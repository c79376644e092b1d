"""PyTorch/CUDA port of mpi_pastar_msa_tpu: provably-optimal multiple
sequence alignment by batched-frontier A* on an NVIDIA H100.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU (``device="cpu"``); without a CUDA device they raise.  The package
imports ``torch`` and ``numpy`` only, never ``jax`` nor the JAX package.
"""
