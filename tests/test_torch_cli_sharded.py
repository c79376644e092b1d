"""The CLI's sharded frontier engine on the CPU (mirrors the JAX CLI's
``--devices`` / ``-t`` path, mpi_pastar_msa_tpu/cli.py:153-233):
``--devices 2`` and ``-t 2`` with ``--engine frontier`` run the sharded
engine on CPU shards and print the golden Final Score, similarity and
alignment, the placement of the shards, one tid row a shard with its
``migrated`` column, and the exchange ``--exchange`` asks for; ``-t 2
--triples on`` on two sequences keeps the pair heuristic and prints the
JAX CLI's Final Score and alignment, and ``--triples fractional`` there is
refused, as in the JAX CLI (mpi_pastar_msa_tpu/cli.py:174-187)."""
import contextlib
import io
import json
import os
import re
import string

import pytest
import torch

from mpi_pastar_msa_tpu import cli as jcli
from mpi_pastar_msa_tpu_torch import cli as tcli

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))


def fasta(tmp_path, name):
    path = tmp_path / name
    path.write_text("".join(f">s{k}\n{r.replace('-', '')}\n"
                            for k, r in enumerate(GOLD[name]["alignment"])))
    return str(path)


def run(argv, main=tcli.run, rc=0):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert main(argv) == rc
    return out.getvalue()


def surface(text):
    """The Final Score line and the lines from Similarity to the counters."""
    lines = text.splitlines()
    score = next(i for i, l in enumerate(lines) if l.startswith("Final Score:"))
    sim = next(i for i, l in enumerate(lines) if l.startswith("Similarity:"))
    end = next(i for i, l in enumerate(lines) if l.startswith("Total nodes counters"))
    return lines[score], lines[sim:end]


@pytest.mark.parametrize("name,flags,shards,exchange", [
    ("PF08184.fasta", ["--devices", "2"], 2, "dense"),
    ("test2.fasta", ["-t", "2"], 2, "dense"),
    ("PF08184.fasta", ["--devices", "3", "--exchange", "ragged"], 3, "ragged"),
    ("test2.fasta", ["-t", "4", "--devices", "2", "--exchange", "dense", "-y", "PZORDER"], 2,
     "dense"),
])
def test_cli_sharded_reaches_golden(tmp_path, name, flags, shards, exchange):
    path = fasta(tmp_path, name)
    got = run([path, "--device", "cpu", "--engine", "frontier"] + flags)
    gold = GOLD[name]
    lines = got.splitlines()
    assert f"g - {gold['optimal_g']} " in got
    assert f"Similarity: {gold['similarity_pct']:.2f}%" in lines
    assert f"shards: {shards} on " + ", ".join(["cpu"] * shards) in lines
    assert f"exchange {exchange} " in got
    # CPU shards run the chunked driver: one host read a chunk of 256 steps
    steps = int(re.search(r"; (\d+) steps, driver chunked, ", got).group(1))
    assert f"driver chunked, {-(-steps // 256) / steps:.2f} host reads a step" in got
    rows = [l for l in lines if l.startswith("tid ")]
    assert len(rows) == shards and all("\tmigrated " in r for r in rows)
    assert sum(int(r.split("migrated ")[1]) for r in rows) > 0
    al = "".join(l for l in lines if l and set(l) <= set(string.ascii_uppercase + "-"))
    assert al.replace("-", "") == "".join(r.replace("-", "") for r in gold["alignment"])


def test_cli_one_shard_stays_single_device(tmp_path):
    path = fasta(tmp_path, "PF08184.fasta")
    got = run([path, "--device", "cpu", "--engine", "frontier", "--devices", "1"])
    assert "shards:" not in got and "g - 24450 " in got
    assert sum(l.startswith("tid ") for l in got.splitlines()) == 1


def test_cli_sharded_triples_on_falls_back_as_jax(tmp_path):
    """Two sequences have no triangle: ``--triples on`` keeps the pair
    heuristic under the sharded engine and exits 0 with the JAX CLI's
    Final Score and alignment; ``--triples fractional`` exits 2 in both."""
    path = tmp_path / "two.fasta"
    path.write_text(">a\nACDEFGHIK\n>b\nACDFGHIK\n")
    flags = [str(path), "-t", "2", "--triples", "on"]
    want = run(flags + ["--engine", "tpu"], main=jcli.run)
    got = run(flags + ["--device", "cpu", "--engine", "frontier"])
    assert "shards: 2 on cpu, cpu" in got.splitlines()
    assert surface(got) == surface(want)
    frac = [str(path), "-t", "2", "--triples", "fractional"]
    run(frac + ["--engine", "tpu"], main=jcli.run, rc=2)
    run(frac + ["--device", "cpu", "--engine", "frontier"], rc=2)
