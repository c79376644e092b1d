"""The port's CLI flags and engines against the JAX CLI on the CPU (mirrors
tests/test_cli.py:25-56 without the reference files): ``--engine auto``
picks what JAX's rule picks, ``--engine serial`` and ``--engine native``
(``-t 1`` and ``-t 2``) print the same Final Score, Similarity and
alignment as JAX's CLI with the same flags, ``-y``/``-s`` are echoed,
``--memory_debug``, ``--profile`` and ``-v`` do what they say, and the
frontier engine refuses ``-t`` > 1."""
import contextlib
import io
import json
import os

import pytest
import torch

from mpi_pastar_msa_tpu import cli as jcli
from mpi_pastar_msa_tpu_torch import cli as tcli
from mpi_pastar_msa_tpu_torch.core.problem import Problem

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))


def surface(text):
    lines = text.splitlines()
    score = next(i for i, l in enumerate(lines) if l.startswith("Final Score:"))
    sim = next(i for i, l in enumerate(lines) if l.startswith("Similarity:"))
    end = next(i for i, l in enumerate(lines) if l.startswith("Total nodes counters"))
    return lines[score], lines[sim:end]


def run(main, argv, rc=0):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == rc
    return out.getvalue()


def fasta(tmp_path, name):
    path = tmp_path / name
    path.write_text("".join(f">s{k}\n{r.replace('-', '')}\n"
                            for k, r in enumerate(GOLD[name]["alignment"])))
    return str(path)


def jax_rule(seqs):
    """JAX's --engine auto (mpi_pastar_msa_tpu/cli.py:121-131), restated."""
    lattice = 1
    for s in seqs:
        lattice *= len(s) + 1
        if lattice > 10**8:
            break
    return "native" if lattice <= 10**8 else "tpu"


@pytest.mark.parametrize("lengths", [(4,) * 8, (24,) * 5, (59,) * 3, (99,) * 4,
                                     (99, 99, 99, 100), (267, 276, 263, 273, 272)])
def test_auto_follows_jax_rule(lengths):
    # the problem only: the big lattices are not searched
    seqs = tuple("A" * L for L in lengths)
    want = {"native": "native", "tpu": "frontier"}[jax_rule(seqs)]
    assert tcli.auto_engine(Problem(seqs)) == want


@pytest.mark.parametrize("name", ["test2.fasta", "PF08184.fasta"])
def test_auto_runs_native_as_jax(tmp_path, name):
    path = fasta(tmp_path, name)
    want = run(jcli.run, [path])
    got = run(tcli.run, [path, "--device", "cpu"])
    assert "engine auto -> native" in want and "engine auto -> native" in got
    assert surface(got) == surface(want)
    assert f"g - {GOLD[name]['optimal_g']} " in got


@pytest.mark.parametrize("name,flags", [
    ("PF08184.fasta", ["--engine", "serial"]),
    ("test.fasta", ["--engine", "serial"]),
    ("test2.fasta", ["--engine", "native"]),
    ("PF08184.fasta", ["--engine", "native", "-t", "1"]),
    ("PF08184.fasta", ["--engine", "native", "-t", "2"]),
])
def test_engine_surface_matches_jax(tmp_path, name, flags):
    path = fasta(tmp_path, name)
    want = run(jcli.run, flags + [path])
    got = run(tcli.run, flags + [path, "--device", "cpu"])
    assert surface(got) == surface(want)
    score, block = surface(got)
    assert f"g - {GOLD[name]['optimal_g']} " in score
    assert block[0] == f"Similarity: {GOLD[name]['similarity_pct']:.2f}%"
    for line in ("Phase 1 - init heuristic: ", "Phase 2: A-Star running time: ",
                 "Phase 3 - backtrace: ", "total\texpanded ", "nodes expanded/s"):
        assert line in got
    threads = int(flags[-1]) if "-t" in flags else 1
    assert sum(l.startswith("tid ") for l in got.splitlines()) == threads
    if flags[1] == "serial":  # the serial row carries the open size
        tid0 = next(l for l in got.splitlines() if l.startswith("tid 0"))
        assert tid0 == next(l for l in want.splitlines() if l.startswith("tid 0"))


def test_hash_flags_echoed(tmp_path):
    out = run(tcli.run, ["--engine", "serial", "-y", "FSUM", "-s", "3",
                         fasta(tmp_path, "test.fasta"), "--device", "cpu"])
    assert "hash=FSUM shift=3" in out and "g - 52440 " in out
    defaults = tcli.make_parser().parse_args(["x.fasta"])
    assert (defaults.hash_type, defaults.hash_shift, defaults.threads,
            defaults.engine, defaults.device) == ("FSUM", 4, 0, "auto", "cuda")


def test_memory_debug_line(tmp_path):
    out = run(tcli.run, ["--memory_debug", fasta(tmp_path, "PF08184.fasta"),
                         "--device", "cpu", "--engine", "frontier", "--triples", "off"])
    line = next(l for l in out.splitlines() if l.startswith("memory_debug: "))
    assert line == "memory_debug: 0 live device arrays, 0.0 MB after cleanup"


def test_profile_writes_a_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    out = run(tcli.run, ["--profile", str(trace_dir), fasta(tmp_path, "test.fasta"),
                         "--device", "cpu", "--engine", "native"])
    path = trace_dir / "phase2_trace.json"
    assert f"profile trace written to {path}" in out
    assert "traceEvents" in json.load(open(path))


def test_version(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.run(["-v"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == "msa_pastar_torch 0.1.0"


def test_frontier_refuses_threads(tmp_path, capsys):
    # -t above 1 is the frontier engine's shard count (the sharded engine,
    # tests/test_torch_cli_sharded.py), which keeps no checkpoint
    path = fasta(tmp_path, "PF08184.fasta")
    assert tcli.run([path, "--device", "cpu", "--engine", "frontier", "-t", "2",
                     "--checkpoint", str(tmp_path / "ckpt.npz")]) == 2
    assert "keeps no checkpoint" in capsys.readouterr().err
