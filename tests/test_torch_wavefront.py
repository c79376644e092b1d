"""Port K1 (pair-wavefront suffix DP): the plain PyTorch version equals the
JAX scan wavefront, the Pallas kernel in interpret mode and the NumPy oracle,
cell for cell (int32, zero tolerance).

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
from mpi_pastar_msa_tpu_torch.core.problem import Problem, problem_from_fasta
from mpi_pastar_msa_tpu_torch.heuristic.pairwise import all_pair_tables
from mpi_pastar_msa_tpu_torch.heuristic.wavefront import pair_tables

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
