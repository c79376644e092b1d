"""Port HPair heuristic and package boundaries.

- The port's weights, tables and calculate_h equal the JAX
  HPairHeuristic.build(backend="host"); from_numpy round-trips the JAX state.
- Importing the whole port loads neither jax nor any mpi_pastar_msa_tpu module
  (checked in a subprocess: tests/conftest.py imports jax in-process).
- Without --device cpu on a host with no CUDA device, the CLI exits non-zero
  with the "no CUDA device" error instead of running on the CPU.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu.core.problem import Problem as JProblem
from mpi_pastar_msa_tpu.heuristic.hpair import HPairHeuristic as JHPair
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def golden_seqs(name):
    gold = json.load(open(os.path.join(HERE, "goldens.json")))[name]
    return tuple(r.replace("-", "") for r in gold["alignment"])


@pytest.mark.parametrize("name", ["test.fasta", "test2.fasta", "PF08184.fasta",
                                  "kinase.fasta"])
def test_build_matches_jax_host(name):
    seqs = golden_seqs(name)
    jh = JHPair.build(JProblem(seqs), backend="host")
    th = HPairHeuristic.build(Problem(seqs), "cpu")
    assert th.weight_f.dtype == np.float32
    assert np.array_equal(th.weight_f, jh.weight_f)
    assert np.array_equal(th.weight_i, jh.weight_i)
    gold = json.load(open(os.path.join(HERE, "goldens.json")))[name]
    assert np.array_equal(th.weight_i, np.array(gold["weights_int"]))
    for a, b in zip(th.tables, jh.tables):
        assert np.array_equal(a, b)
    assert np.array_equal(th.stacked_tables(), jh.stacked_tables())
    assert np.array_equal(th.pair_weights_i(), jh.pair_weights_i())
    rs = np.random.RandomState(1)
    final = np.array([len(s) for s in seqs])
    for _ in range(20):
        c = np.array([rs.randint(0, v + 1) for v in final])
        assert th.calculate_h(c) == jh.calculate_h(c)


def test_from_numpy_round_trip():
    seqs = golden_seqs("PF08184.fasta")
    jh = JHPair.build(JProblem(seqs), backend="host")
    th = HPairHeuristic.from_numpy(Problem(seqs), jh.tables, jh.weight_f,
                                   jh.weight_i)
    for a, b in zip(th.tables, jh.tables):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    assert np.array_equal(th.weight_f, jh.weight_f)
    assert np.array_equal(th.weight_i, jh.weight_i)
    assert th.calculate_h((3, 17, 42)) == jh.calculate_h((3, 17, 42))
    back = HPairHeuristic.from_numpy(th.problem, th.tables, th.weight_f,
                                     th.weight_i)
    assert back.calculate_h((59, 0, 7)) == th.calculate_h((59, 0, 7))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mpi_pastar_msa_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'mpi_pastar_msa_tpu' or k.startswith('mpi_pastar_msa_tpu.')]\n"
        "n = sum(1 for k in sys.modules if k.startswith('mpi_pastar_msa_tpu_torch.'))\n"
        "need = ['mpi_pastar_msa_tpu_torch.heuristic.triples',\n"
        "        'mpi_pastar_msa_tpu_torch.search.engine',\n"
        "        'mpi_pastar_msa_tpu_torch.heuristic.gotoh_wavefront',\n"
        "        'mpi_pastar_msa_tpu_torch.search.serial',\n"
        "        'mpi_pastar_msa_tpu_torch.search.native',\n"
        "        'mpi_pastar_msa_tpu_torch.search.bruteforce',\n"
        "        'mpi_pastar_msa_tpu_torch.parallel.partition',\n"
        "        'mpi_pastar_msa_tpu_torch.parallel.mesh',\n"
        "        'mpi_pastar_msa_tpu_torch.parallel.multihost',\n"
        "        'mpi_pastar_msa_tpu_torch.parallel.sharded']\n"
        "print(n, bad, [k for k in need if k not in sys.modules])\n"
        "sys.exit(1 if bad or n < 20 or not all(k in sys.modules for k in need) else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cli_refuses_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    fasta = tmp_path / "PF08184.fasta"
    fasta.write_text("".join(f">s{k}\n{s}\n" for k, s in
                             enumerate(golden_seqs("PF08184.fasta"))))
    out = subprocess.run([sys.executable, "-m", "mpi_pastar_msa_tpu_torch",
                          str(fasta)], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "Final Score" not in out.stdout
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrontierSearch(Problem(golden_seqs("PF08184.fasta")))
