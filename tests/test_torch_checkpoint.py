"""Checkpoint/resume and the host driver of ``FrontierSearch`` on the CPU,
on PF08184 rebuilt from tests/goldens.json, in each table layout (mirrors
tests/test_checkpoint.py without the reference files): a search interrupted
by ``max_steps`` leaves a checkpoint, and a new engine resumes from it to
the golden g with more steps and the alignment of an uninterrupted run; a
checkpoint of another problem, layout or configuration, or one written by
JAX's engine, is ignored (and JAX's engine ignores the port's);
``driver="host"`` reaches the same result one step a dispatch."""
import json
import os

import pytest
import torch

from mpi_pastar_msa_tpu.core.problem import Problem as JProblem
from mpi_pastar_msa_tpu.heuristic.hpair import HPairHeuristic as JHPair
from mpi_pastar_msa_tpu.search.engine import TpuFrontierSearch
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))["PF08184.fasta"]
SEQS = tuple(r.replace("-", "") for r in GOLD["alignment"])
# small tables and chunks: the search takes a few dozen steps
ARGS = dict(batch=64, capacity=1 << 12, chunk_steps=4, triples="off", device="cpu")
LAYOUTS = ["sig", "packed", "unpacked"]


@pytest.fixture(scope="module")
def heuristic():
    p = Problem(SEQS)
    return p, HPairHeuristic.build(p, "cpu")


def engine(heuristic, **kw):
    p, h = heuristic
    return FrontierSearch(p, h, **{**ARGS, **kw})


def interrupt(heuristic, ckpt, **kw):
    eng = engine(heuristic, max_steps=10, checkpoint_path=ckpt, checkpoint_every=1, **kw)
    with pytest.raises(RuntimeError, match="max_steps"):
        eng.run()
    assert os.path.exists(ckpt) and eng.last_phase_walls["checkpoint_save"] > 0
    return eng


@pytest.mark.parametrize("layout", LAYOUTS)
def test_interrupt_then_resume(heuristic, tmp_path, layout):
    ckpt = str(tmp_path / "search.ckpt.npz")
    whole = engine(heuristic, layout=layout).run()
    assert whole.g == GOLD["optimal_g"]
    interrupt(heuristic, ckpt, layout=layout)
    eng = engine(heuristic, layout=layout, checkpoint_path=ckpt, checkpoint_every=1)
    res = eng.run()
    assert res.g == GOLD["optimal_g"]
    assert eng.resumed_steps == 12 and res.steps > 10  # continued, not restarted
    assert "checkpoint_load" in eng.last_phase_walls
    # the resumed search is the uninterrupted one
    assert (res.steps, res.nodes_expanded, res.closed) == (
        whole.steps, whole.nodes_expanded, whole.closed)
    al = build_alignment(Problem(SEQS), res.closed)
    assert al == build_alignment(Problem(SEQS), whole.closed)
    assert [r.replace("-", "") for r in al] == list(SEQS)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_host_driver_reaches_the_same_result(heuristic, layout):
    whole = engine(heuristic, layout=layout).run()
    eng = engine(heuristic, layout=layout, driver="host")
    res = eng.run()
    assert res.g == whole.g == GOLD["optimal_g"]
    assert (res.steps, res.nodes_expanded, res.closed) == (
        whole.steps, whole.nodes_expanded, whole.closed)
    with pytest.raises(ValueError):
        engine(heuristic, driver="remote")


@pytest.mark.parametrize("other", [
    dict(layout="packed"), dict(layout="unpacked"), dict(capacity=1 << 13),
    dict(batch=32), dict(triples="auto"), dict(seqs=SEQS[:2] + (SEQS[2][:-1],))])
def test_mismatched_checkpoint_ignored(heuristic, tmp_path, other):
    ckpt = str(tmp_path / "search.ckpt.npz")
    interrupt(heuristic, ckpt, layout="sig")
    seqs = other.pop("seqs", None)
    if seqs is not None:
        p = Problem(seqs)
        heuristic = (p, HPairHeuristic.build(p, "cpu"))
    eng = engine(heuristic, checkpoint_path=ckpt, **other)
    res = eng.run()
    assert eng.resumed_steps is None  # started afresh
    assert res.g == (GOLD["optimal_g"] if seqs is None
                     else engine(heuristic, **other).run().g)


def test_checkpoints_of_the_two_packages_ignore_each_other(heuristic, tmp_path):
    jp = JProblem(SEQS)
    jh = JHPair.build(jp, backend="host")
    jargs = dict(batch=64, capacity=1 << 12, chunk_steps=4, triples="off")
    jax_ckpt = str(tmp_path / "jax.ckpt.npz")
    jeng = TpuFrontierSearch(jp, jh, max_steps=10, checkpoint_path=jax_ckpt,
                             checkpoint_every=1, **jargs)
    with pytest.raises(RuntimeError, match="max_steps"):
        jeng.run()
    assert os.path.exists(jax_ckpt)
    p = Problem(SEQS)
    th = HPairHeuristic.from_numpy(p, jh.tables, jh.weight_f, jh.weight_i)
    eng = FrontierSearch(p, th, layout=jeng.layout, checkpoint_path=jax_ckpt, **ARGS)
    assert eng.run().g == GOLD["optimal_g"] and eng.resumed_steps is None
    # and JAX's engine starts afresh from the port's file
    ckpt = str(tmp_path / "port.ckpt.npz")
    interrupt((p, th), ckpt, layout=jeng.layout)
    jres = TpuFrontierSearch(jp, jh, checkpoint_path=ckpt, **jargs).run()
    assert jres.g == GOLD["optimal_g"] and jres.steps == eng.run().steps
