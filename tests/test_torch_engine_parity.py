"""Port frontier engine against the JAX engine and the serial A* oracle.

Both engines get the same heuristic (the JAX HPairHeuristic's NumPy state,
carried over with HPairHeuristic.from_numpy) and must agree on the optimal g
and on the g of every node of the returned path.  Expansion counts may
differ: the engines may resolve write races in the table differently.
"""
import json
import os

import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu.core.problem import Problem as JProblem
from mpi_pastar_msa_tpu.heuristic.hpair import HPairHeuristic as JHPair
from mpi_pastar_msa_tpu.search.engine import TpuFrontierSearch
from mpi_pastar_msa_tpu.search.serial import SerialAStar
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

AMINO = "ACDEFGHIKLMNPQRSTVWY"
HERE = os.path.dirname(os.path.abspath(__file__))
PF08184 = tuple(r.replace("-", "") for r in json.load(open(
    os.path.join(HERE, "goldens.json")))["PF08184.fasta"]["alignment"])


def random_seqs(seed, n=4, lo=5, hi=12):
    rs = np.random.RandomState(seed)
    return tuple("".join(rs.choice(list(AMINO), size=rs.randint(lo, hi + 1)))
                 for _ in range(n))


def both(seqs):
    jh = JHPair.build(JProblem(seqs), backend="host")
    th = HPairHeuristic.from_numpy(Problem(seqs), jh.tables, jh.weight_f,
                                   jh.weight_i)
    return jh, th


@pytest.mark.parametrize("seqs", [PF08184, random_seqs(21)],
                         ids=["PF08184", "random21"])
def test_matches_jax_engine(seqs):
    jh, th = both(seqs)
    jres = TpuFrontierSearch(JProblem(seqs), jh, triples="off").run()
    tres = FrontierSearch(Problem(seqs), th, device="cpu", triples="off").run()
    assert tres.g == jres.g
    assert tres.closed == jres.closed  # same path, same g at every node
    assert tres.h == jres.h == 0


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_random_matches_serial(seed):
    seqs = random_seqs(seed)
    jh, th = both(seqs)
    want = SerialAStar(JProblem(seqs), jh).run().g
    res = FrontierSearch(Problem(seqs), th, device="cpu", batch=64,
                         capacity=1 << 14, triples="off").run()
    assert res.g == want
