"""The port's CLI prints the same Final Score, Similarity and alignment block
as the JAX CLI (--engine tpu against the port's --engine frontier, with
--triples off and with --triples auto) on PF08184 rebuilt from
tests/goldens.json; timers and the counters table may differ."""
import contextlib
import io
import json
import os

import torch

from mpi_pastar_msa_tpu import cli as jcli
from mpi_pastar_msa_tpu_torch import cli as tcli

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def surface(text):
    lines = text.splitlines()
    score = next(i for i, l in enumerate(lines) if l.startswith("Final Score:"))
    sim = next(i for i, l in enumerate(lines) if l.startswith("Similarity:"))
    end = next(i for i, l in enumerate(lines) if l.startswith("Total nodes counters"))
    return lines[score], lines[sim:end]


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def pf08184_fasta(tmp_path):
    gold = json.load(open(os.path.join(HERE, "goldens.json")))["PF08184.fasta"]
    fasta = tmp_path / "PF08184.fasta"
    fasta.write_text("".join(f">s{k}\n{r.replace('-', '')}\n"
                             for k, r in enumerate(gold["alignment"])))
    return gold, fasta


def test_cli_surface_matches_jax(tmp_path):
    gold, fasta = pf08184_fasta(tmp_path)
    want = run(jcli.run, [str(fasta), "--engine", "tpu", "--triples", "off"])
    got = run(tcli.run, [str(fasta), "--device", "cpu", "--engine", "frontier",
                         "--triples", "off"])
    assert surface(got) == surface(want)
    score, block = surface(got)
    assert score == "Final Score: (59 59 59)\tg - 24450 (h - 0 f - 24450)"
    assert block[0] == "Similarity: 95.48%"
    assert [l for l in block[1:] if l] == gold["alignment"]
    for line in ("Phase 1 - init heuristic: ", "Phase 2: PA-Star running time: ",
                 "Phase 3 - backtrace: ", "total\texpanded ", "throughput: "):
        assert line in got


def test_cli_triples_auto_surface_matches_jax(tmp_path):
    # the default --triples auto builds PF08184's one cube in both packages
    gold, fasta = pf08184_fasta(tmp_path)
    want = run(jcli.run, [str(fasta), "--engine", "tpu", "--triples", "auto"])
    got = run(tcli.run, [str(fasta), "--device", "cpu", "--engine", "frontier",
                         "--triples", "auto"])
    assert surface(got) == surface(want)
    assert surface(run(tcli.run, [str(fasta), "--device", "cpu", "--engine",
                                  "frontier"])) == surface(got)
    score, block = surface(got)
    assert score == "Final Score: (59 59 59)\tg - 24450 (h - 0 f - 24450)"
    assert [l for l in block[1:] if l] == gold["alignment"]
