"""Multi-process bootstrap: torch.distributed init and the rank-0 problem
broadcast.

Port of the JAX package's ``parallel/multihost.py``, the equivalent of the
reference's MPI bootstrap (ref: pastar/msa_pastar_main.cpp:56-190): instead
of ``MPI_Init_thread`` and rank 0 sending a serialized, compressed
sequence blob to every rank (ref: msa_pastar_main.cpp:97-179), the ranks
join a torch.distributed group and rank 0 broadcasts the raw sequence
bytes.  In a single process every function is a no-op passthrough, so the
CLI calls them unconditionally.
"""
from __future__ import annotations

import atexit
import os
from typing import Optional

import numpy as np
import torch

from ..core.problem import Problem


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Join the torch.distributed group if a multi-process run is set up,
    and return this process's rank (0 in a single process).

    The group comes from the arguments or from torch's own environment as
    ``torchrun`` sets it: ``MASTER_ADDR`` and ``MASTER_PORT`` (the
    coordinator ``host:port``), ``WORLD_SIZE`` and ``RANK``.  With neither
    a coordinator nor a process count, nothing is started.  The backend is
    gloo for CPU tensors and, where CUDA is available, NCCL for CUDA ones.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if coordinator is None and num_processes is None:
        return 0
    if coordinator is None or num_processes is None:
        raise ValueError("a multi-process run needs both the coordinator "
                         "(MASTER_ADDR:MASTER_PORT) and the process count (WORLD_SIZE)")
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=rank)
    atexit.register(_shutdown)
    return rank


def _shutdown() -> None:
    """Leave the group before the interpreter exits.  A process that exits
    with the group still up tears its store and gloo threads down during
    static destruction, which can abort it (SIGABRT, "terminate called
    without an active exception") after its work is done."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _broadcast(x: np.ndarray) -> np.ndarray:
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(x))
    dist.broadcast(t, src=0)
    return t.numpy()


def broadcast_problem(problem: Optional[Problem]) -> Problem:
    """Rank 0 reads the FASTA; every other rank receives the sequences: the
    header (n, lmax), then the lengths and the (n, lmax) uint8 matrix of
    the encoded sequences, one ``dist.broadcast`` each (the reference's
    rank-0 send loop, msa_pastar_main.cpp:112-139, and receive path,
    :145-174).  In a single process it returns ``problem``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        if problem is None:
            raise ValueError("a single process must read the problem itself")
        return problem
    src = dist.get_rank() == 0
    if src:
        if problem is None:
            raise ValueError("rank 0 must read the problem")
        lens = np.array([len(s) for s in problem.seqs], dtype=np.int32)
        header = np.array([problem.n_seq, int(lens.max())], dtype=np.int32)
    else:
        header = np.zeros(2, dtype=np.int32)
    n, lmax = (int(v) for v in _broadcast(header))
    if src:
        enc = problem.encoded(lmax)
    else:
        lens = np.zeros(n, dtype=np.int32)
        enc = np.zeros((n, lmax), dtype=np.uint8)
    lens = _broadcast(lens)
    enc = _broadcast(enc)
    return Problem(tuple(bytes(enc[i, : int(lens[i])]).decode("latin-1")
                         for i in range(n)))
