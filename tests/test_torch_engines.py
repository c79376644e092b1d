"""The port's serial (``search/serial.py``), native (``search/native.py``) and
brute-force (``search/bruteforce.py``) engines against the JAX package's on
the CPU, on identical heuristics (the JAX ``HPairHeuristic`` fields through
``HPairHeuristic.from_numpy``): random 3- and 4-sequence problems and test,
test2 and PF08184 rebuilt from tests/goldens.json.  Mirrors
tests/test_serial_astar.py and tests/test_native_mt.py without the reference
files.  The native libraries build into the port's ``_build/``, never into
``native/``."""
import json
import os
import random
import subprocess

import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu.core.problem import Problem as JProblem
from mpi_pastar_msa_tpu.heuristic.hpair import HPairHeuristic as JHPair
from mpi_pastar_msa_tpu.search.bruteforce import optimal_cost as j_optimal_cost
from mpi_pastar_msa_tpu.search.native import NativeAStar as JNative
from mpi_pastar_msa_tpu.search.serial import SerialAStar as JSerial
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.search import native as tnative
from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment, similarity
from mpi_pastar_msa_tpu_torch.search.bruteforce import optimal_cost
from mpi_pastar_msa_tpu_torch.search.native import NativeAStar
from mpi_pastar_msa_tpu_torch.search.serial import SerialAStar

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))


def both(seqs):
    """(JAX problem, JAX heuristic, port problem, port heuristic), the port's
    on the JAX heuristic's fields."""
    jp = JProblem(tuple(seqs))
    jh = JHPair.build(jp, backend="host")
    p = Problem(tuple(seqs))
    return jp, jh, p, HPairHeuristic.from_numpy(p, jh.tables, jh.weight_f, jh.weight_i)


def degaps(p, res):
    al = build_alignment(p, res.closed)
    assert len({len(a) for a in al}) == 1
    assert [row.replace("-", "") for row in al] == list(p.seqs)
    return al


def random_problem(seed, n, lo, hi, alphabet="ACDEFGHIKLMNPQRSTVWY"):
    random.seed(seed)
    return tuple("".join(random.choice(alphabet) for _ in range(random.randint(lo, hi)))
                 for _ in range(n))


@pytest.mark.parametrize("seqs", [
    random_problem(0, 3, 3, 8), random_problem(1, 3, 3, 8), random_problem(2, 3, 3, 8),
    random_problem(3, 3, 3, 8), random_problem(42, 4, 5, 5, "ACDEFG"),
    random_problem(31, 4, 5, 11), ("ACDEF", "ACF")])
def test_engines_equal_jax_and_bruteforce(seqs):
    jp, jh, p, h = both(seqs)
    want = j_optimal_cost(jp, jh)
    assert optimal_cost(p, h) == want
    jres = JSerial(jp, jh).run()
    res = SerialAStar(p, h).run()
    assert (res.g, res.h, res.nodes_expanded, res.nodes_reopened, res.open_size) == (
        jres.g, jres.h, jres.nodes_expanded, jres.nodes_reopened, jres.open_size)
    assert res.g == want and res.closed == jres.closed
    degaps(p, res)
    for t in (1, 2, 4):
        nres = NativeAStar(p, h, threads=t).run()
        assert nres.g == want == JNative(jp, jh, threads=t).run().g
        assert len(nres.thread_stats) == t
        degaps(p, nres)
    if len(seqs) == 2:  # N = 2 is pairwise alignment; the weight scales to 8
        assert int(h.weight_i[0, 1]) == 8


@pytest.mark.parametrize("name", ["test.fasta", "test2.fasta", "PF08184.fasta"])
def test_golden_inputs_equal_jax(name):
    gold = GOLD[name]
    jp, jh, p, h = both([r.replace("-", "") for r in gold["alignment"]])
    # the port's own Phase 1 (K1's and K8's plain versions) gives the same
    # heuristic as JAX's host build
    own = HPairHeuristic.build(p, "cpu")
    assert np.array_equal(own.weight_i, jh.weight_i)
    assert all(np.array_equal(a, b) for a, b in zip(own.tables, jh.tables))
    jn = JNative(jp, jh).run()
    for t in (1, 2, 4):
        res = NativeAStar(p, h, threads=t).run()
        assert res.g == jn.g == gold["optimal_g"]
        al = degaps(p, res)
        assert round(similarity(al), 2) == gold["similarity_pct"]
        if t == 1:
            assert (res.nodes_expanded, res.nodes_reopened, res.open_size,
                    res.closed_size) == (jn.nodes_expanded, jn.nodes_reopened,
                                         jn.open_size, jn.closed_size)
            assert res.closed == jn.closed and res.thread_stats == jn.thread_stats
    if name != "test2.fasta":  # the Python oracle is slow on test2's lattice
        res = SerialAStar(p, h).run()
        jres = JSerial(jp, jh).run()
        assert res.g == jres.g == gold["optimal_g"] and res.closed == jres.closed
        assert res.h == 0 and res.open_size == jres.open_size
        al = degaps(p, res)
        assert round(similarity(al), 2) == gold["similarity_pct"]
    if name == "PF08184.fasta":
        assert gold["similarity_pct"] == 95.48


def native_state():
    """(mtime of each file of native/, git status of native/) — the
    files are the repository's and the JAX package's, never the port's."""
    files = sorted(os.listdir(os.path.join(ROOT, "native")))
    tracked = subprocess.run(["git", "ls-files", "native"], cwd=ROOT,
                             capture_output=True, text=True)
    status = subprocess.run(["git", "status", "--porcelain", "native"], cwd=ROOT,
                            capture_output=True, text=True)
    names = (tracked.stdout.split() if tracked.returncode == 0
             else [f"native/{f}" for f in files if f.endswith((".c", ".h"))])
    return ({n: os.stat(os.path.join(ROOT, n)).st_mtime_ns for n in names},
            status.stdout if status.returncode == 0 else None)


def test_native_builds_into_the_ports_build_dir(tmp_path):
    before = native_state()
    for name in ("fastastar", "fastastar_mt"):
        assert os.path.dirname(tnative.lib_path(name)) == os.path.join(
            ROOT, "mpi_pastar_msa_tpu_torch", "_build")
        lib = tnative.build(name, str(tmp_path))  # a fresh build
        assert os.path.dirname(lib) == str(tmp_path) and os.path.exists(lib)
        assert tnative.build(name, str(tmp_path)) == lib  # built once
    # the name covers the flags and every source the library includes
    assert tnative.lib_path("fastastar") != tnative.lib_path("fastastar_mt")
    assert native_state() == before
    assert before[0]  # the tracked sources were seen


def test_native_build_failure_raises(tmp_path, monkeypatch):
    (tmp_path / "fast_astar.c").write_text("this is not C\n")
    monkeypatch.setattr(tnative, "NATIVE_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="gcc failed"):
        tnative.build("fastastar", str(tmp_path / "build"))
    assert not any((tmp_path / "build").iterdir())
