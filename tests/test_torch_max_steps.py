"""``FrontierSearch(max_steps=...)`` against JAX's ``TpuFrontierSearch`` on the
CPU, on PF08184 rebuilt from tests/goldens.json: a step limit below what the
search needs raises "max_steps exceeded" in both, and the default limit lets
both reach the golden g."""
import json
import os

import pytest
import torch

from mpi_pastar_msa_tpu.core.problem import Problem as JProblem
from mpi_pastar_msa_tpu.heuristic.hpair import HPairHeuristic as JHPair
from mpi_pastar_msa_tpu.search.engine import TpuFrontierSearch
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.search import engine as TE

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))["PF08184.fasta"]
SEQS = tuple(r.replace("-", "") for r in GOLD["alignment"])
# small tables and chunks: the search takes a few dozen steps
ARGS = dict(batch=64, capacity=1 << 12, chunk_steps=4, triples="off")


def engines(**kw):
    jh = JHPair.build(JProblem(SEQS), backend="host")
    th = HPairHeuristic.from_numpy(Problem(SEQS), jh.tables, jh.weight_f, jh.weight_i)
    return (TpuFrontierSearch(JProblem(SEQS), jh, **ARGS, **kw),
            TE.FrontierSearch(Problem(SEQS), th, device="cpu", **ARGS, **kw))


def test_max_steps_below_the_search_raises_in_both():
    jeng, teng = engines(max_steps=4)
    assert jeng.max_steps == teng.max_steps == 4
    for eng in (jeng, teng):
        with pytest.raises(RuntimeError, match="max_steps exceeded"):
            eng.run()


def test_default_max_steps_reaches_the_golden_g_in_both():
    jeng, teng = engines()
    assert jeng.max_steps == teng.max_steps == 1_000_000
    jres, tres = jeng.run(), teng.run()
    assert jres.g == tres.g == GOLD["optimal_g"]
    assert jres.steps == tres.steps > 4  # the limit above is below the need
