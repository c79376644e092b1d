"""Tests that need the card (marker ``cuda``): the hand-written CUDA kernels
against their plain PyTorch versions, and the port's main path on the GPU.
They skip on a host without a CUDA device.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import json
import os

import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu_torch import _kernels
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.wavefront import (
    pair_inputs, wavefront_tables, wavefront_tables_plain)

pytestmark = pytest.mark.cuda
HERE = os.path.dirname(os.path.abspath(__file__))
AMINO = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("seed,n,lo,hi", [
    (1, 5, 1, 40), (2, 3, 200, 300), (3, 2, 1, 1),
    # row-band boundaries: lengths 1023/1023 (L1 = 1024, R = 1), 1023/1024
    # (L1 = 1025, R = 2) and 2105/2099 (R = 3)
    (4, 2, 1023, 1023), (4, 2, 1023, 1024), (6, 2, 2095, 2105),
    # ragged, lengths 1176, 371, 163 and 351: n1 << n2 and n1 >> n2
    (4, 4, 30, 1400),
])
def test_k1_kernel_equals_plain(cuda, seed, n, lo, hi):
    rs = np.random.RandomState(seed)
    seqs = tuple("".join(rs.choice(list(AMINO), size=rs.randint(lo, hi + 1)))
                 for _ in range(n))
    args = pair_inputs(Problem(seqs), cuda)
    before = _kernels.launches["pair_wavefront"]
    got = wavefront_tables(**args)
    assert _kernels.launches["pair_wavefront"] == before + 1
    want = wavefront_tables_plain(**args)
    assert torch.equal(got.cpu(), want.cpu())


def test_k1_wrapper_rejects_unequal_gaps(cuda, monkeypatch):
    # the kernel takes gap open == extension (core/cost.py); anything else
    # raises before a launch
    from mpi_pastar_msa_tpu_torch.heuristic import wavefront
    monkeypatch.setattr(wavefront, "GAP_OPEN", 40)
    monkeypatch.setattr(wavefront, "GAP_EXTENSION", 7)
    args = pair_inputs(Problem(("ACDE", "ACF")), cuda)
    before = _kernels.launches["pair_wavefront"]
    with pytest.raises(ValueError):
        wavefront_tables(**args)
    assert _kernels.launches["pair_wavefront"] == before


def test_k1_wrapper_rejects_bad_input(cuda):
    args = pair_inputs(Problem(("ACDE", "ACF")), cuda)
    args["enc"] = args["enc"].long()
    with pytest.raises(ValueError):
        wavefront_tables(**args)


def test_k1_wrapper_rejects_oversize(cuda):
    # Lmax 21605 needs more shared memory than a block may use
    args = pair_inputs(Problem(("ACDE", "A" * 21605)), cuda)
    before = _kernels.launches["pair_wavefront"]
    with pytest.raises(ValueError):
        wavefront_tables(**args)
    assert _kernels.launches["pair_wavefront"] == before


def test_main_path_on_card(cuda):
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    gold = json.load(open(os.path.join(HERE, "goldens.json")))["PF08184.fasta"]
    p = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    _kernels.reset_counts()
    res = FrontierSearch(p, HPairHeuristic.build(p, cuda), device=cuda).run()
    assert _kernels.launches["pair_wavefront"] == 1
    assert res.g == gold["optimal_g"]
    assert build_alignment(p, res.closed) == gold["alignment"]
