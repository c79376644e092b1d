"""Port K1 (pair-wavefront suffix DP): the plain PyTorch version equals the
JAX scan wavefront, the Pallas kernel in interpret mode and the NumPy oracle,
cell for cell (int32, zero tolerance); the CUDA kernel's launch shape.

Inputs are rebuilt from tests/goldens.json (degapped golden rows) and
tests/data/synth4_long.fasta, or drawn from numpy.random.RandomState.
"""
import json
import os

import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu.core.problem import Problem as JProblem
from mpi_pastar_msa_tpu.heuristic.wavefront import pair_tables_device
from mpi_pastar_msa_tpu.heuristic.wavefront_pallas import pair_tables_pallas
from mpi_pastar_msa_tpu_torch.core.cost import COST_TABLE
from mpi_pastar_msa_tpu_torch.core.problem import Problem, problem_from_fasta
from mpi_pastar_msa_tpu_torch.heuristic.pairwise import all_pair_tables
from mpi_pastar_msa_tpu_torch.heuristic.wavefront import (k1_launch_shape,
                                                          pair_tables)

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
AMINO = "ACDEFGHIKLMNPQRSTVWY"


def golden_seqs(name):
    gold = json.load(open(os.path.join(HERE, "goldens.json")))[name]
    return tuple(r.replace("-", "") for r in gold["alignment"])


def random_seqs(seed, n, lo, hi):
    rs = np.random.RandomState(seed)
    return tuple("".join(rs.choice(list(AMINO), size=rs.randint(lo, hi + 1)))
                 for _ in range(n))


def assert_tables_equal(stacked, host):
    for k, t in enumerate(host):
        assert np.array_equal(stacked[k, : t.shape[0], : t.shape[1]], t), k
        assert (stacked[k, t.shape[0]:, :] == 2**28).all(), k
        assert (stacked[k, :, t.shape[1]:] == 2**28).all(), k


@pytest.mark.parametrize("name", ["PF08184.fasta", "test2.fasta",
                                  "kinase.fasta", "synth4_long"])
def test_plain_k1_matches_jax_scan_and_numpy(name):
    if name == "synth4_long":
        seqs = problem_from_fasta(os.path.join(HERE, "data",
                                               "synth4_long.fasta")).seqs
    else:
        seqs = golden_seqs(name)
    got = pair_tables(Problem(seqs), "cpu").numpy()
    want = pair_tables_device(JProblem(seqs))
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert_tables_equal(got, all_pair_tables(seqs))


@pytest.mark.parametrize("seed", [3, 11])
def test_plain_k1_matches_pallas_interpret(seed):
    seqs = random_seqs(seed, 4, 2, 15)
    got = pair_tables(Problem(seqs), "cpu").numpy()
    want = pair_tables_pallas(JProblem(seqs), interpret=True)
    assert_tables_equal(want, all_pair_tables(seqs))
    assert np.array_equal(got, want)


def test_plain_k1_unequal_lengths_borders():
    seqs = random_seqs(5, 5, 1, 30)
    got = pair_tables(Problem(seqs), "cpu").numpy()
    assert_tables_equal(got, all_pair_tables(seqs))


# (L1, threads, rows per thread); None where only the invariants are held
@pytest.mark.parametrize("L1,threads,rows", [
    (277, 288, 1),     # kinase, Lmax 276
    (1108, 576, 2),    # synth4_long, Lmax 1107
    (1, 32, 1), (1024, 1024, 1), (1025, 544, 2), (2049, 704, 3),
    (21605, None, 22),  # the largest L1 whose shared bytes fit a block
])
def test_k1_launch_shape(L1, threads, rows):
    T, R, shared = k1_launch_shape(L1 - 1)
    assert R == rows and threads in (None, T)
    assert T % 32 == 0 and 32 <= T <= 1024
    assert R * T >= L1 and (R - 1) * T < L1
    assert shared == 8 * (L1 + 1) + 128 * 128 + 2 * L1 <= 232_448


def test_k1_launch_shape_rejects_oversize():
    with pytest.raises(ValueError):
        k1_launch_shape(21605)


def test_k1_cost_table_fits_uint8():
    # the kernel stages the cost table in shared memory as uint8
    assert COST_TABLE.min() >= 0 and COST_TABLE.max() <= 255
