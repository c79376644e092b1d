"""The single-table search's chunk loop on the card, timed in turns
between another tree and this one.

    python3 tools/chunk_loop_turns.py OTHER [--runs 4] [--out FILE]

OTHER is another checkout's root (for instance the parent commit unpacked
with ``git archive``).  Each turn is a process of its own that imports the
port from one tree, in the order OTHER, this, this, OTHER, and on the card
builds FrontierSearch for kinase (``--triples`` auto and off) and globin6
(auto: packed) with the CLI's other defaults, then runs each ``--runs``
times, each run capturing its chunk graph as a run in a process of its
own does (the cached graph is dropped first: a new table may take the
old one's addresses, and the engine would not capture again).  A run's
chunk loop is the wall of the engine's ``_run_once`` less its
``_init_table`` (with a synchronize after it) and its ``_finish``, both
timed here by wrapping them, the same way in every tree: the chunk
graph's capture, every chunk and the host reads.  The first run of an
engine carries the kernels' first loads; the medians are over the
others.  Prints a JSON line a turn, then the summary; needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELLS = (("kinase_auto", "kinase.fasta", "auto"), ("kinase_off", "kinase.fasta", "off"),
         ("globin6_auto", "globin6", "auto"))


def sequences(name: str):
    if name.endswith(".fasta"):  # a golden input: its degapped rows
        gold = json.load(open(os.path.join(ROOT, "tests", "goldens.json")))[name]
        return [row.replace("-", "") for row in gold["alignment"]]
    seqs, cur = [], None
    for line in open(os.path.join(ROOT, "tests", "data", name + ".fasta")):
        line = line.strip()
        if line.startswith(">"):
            cur = []
            seqs.append(cur)
        elif line:
            cur.append(line)
    return ["".join(s) for s in seqs]


def worker(tree: str, runs: int) -> dict:
    sys.path.insert(0, tree)
    import torch

    import mpi_pastar_msa_tpu_torch as port
    from mpi_pastar_msa_tpu_torch.core.problem import Problem
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    if not os.path.abspath(port.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise SystemExit(f"imported {port.__file__}, not the port of {tree}")
    out = {"tree": tree}
    for cell, name, triples in CELLS:
        p = Problem(sequences(name))
        eng = FrontierSearch(p, HPairHeuristic.build(p, "cuda"), device="cuda",
                             triples=triples)
        spans = {}

        def timed(attr, sync=False):
            fn = getattr(eng, attr)

            def wrapped(*args, **kwargs):
                t0 = time.perf_counter()
                res = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                spans[attr] = time.perf_counter() - t0
                return res
            setattr(eng, attr, wrapped)

        for attr, sync in (("_run_once", False), ("_init_table", True), ("_finish", False)):
            timed(attr, sync)
        rows = []
        for _ in range(runs):
            bufs = getattr(eng.st, "_step_buffers", None)
            if bufs is not None:
                bufs.graph = None
            res = eng.run()
            walls = eng.last_phase_walls
            rows.append(dict(
                loop_ms=(spans["_run_once"] - spans["_init_table"] - spans["_finish"]) * 1e3,
                engine_chunk_loop_ms=walls["chunk_loop"] * 1e3 if "chunk_loop" in walls
                else None,
                capture_ms=walls.get("graph_capture", 0.0) * 1e3, steps=res.steps,
                expanded=res.nodes_expanded, g=res.g))
        out[cell] = dict(layout=eng.layout, runs=rows,
                         loop_ms=statistics.median(r["loop_ms"] for r in rows[1:]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker, a.runs)))
        return 0
    if not a.other or a.runs < 2:
        ap.error("give another tree's root and at least 2 runs")
    other = os.path.abspath(a.other)
    turns = []
    for tree in (other, ROOT, ROOT, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                               "--runs", str(a.runs)], capture_output=True, text=True,
                              cwd=tree)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"the turn on {tree} failed ({proc.returncode})")
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    summary = {}
    for cell, _, _ in CELLS:
        per = {"other": [], "this": []}
        for t in turns:
            who = "this" if t["tree"] == ROOT else "other"
            per[who].append(t[cell]["loop_ms"])
            if t[cell]["runs"][0]["g"] != turns[0][cell]["runs"][0]["g"]:
                raise SystemExit(f"{cell}: the trees reach different g")
        summary[cell] = dict(
            other_turns_ms=per["other"], this_turns_ms=per["this"],
            other_ms=statistics.mean(per["other"]), this_ms=statistics.mean(per["this"]),
            steps={w: turns[k][cell]["runs"][0]["steps"] for w, k in (("other", 0),
                                                                     ("this", 1))})
        s = summary[cell]
        print(f"{cell}: the chunk loop, other {s['other_ms']:.3f} ms "
              f"({', '.join(f'{x:.3f}' for x in s['other_turns_ms'])}), this "
              f"{s['this_ms']:.3f} ms ({', '.join(f'{x:.3f}' for x in s['this_turns_ms'])}); "
              f"steps {s['steps']}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
