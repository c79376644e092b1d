"""Command-line interface of the port: FASTA in, optimal alignment out.

Usage: ``python -m mpi_pastar_msa_tpu_torch [--device cuda|cpu]
[--triples auto|on|off|fractional] <fasta>``.
Runs on the card unless ``--device cpu`` is given; without a CUDA device it
exits non-zero rather than running on the CPU.

Output follows the JAX CLI and the reference's printed surface: the
"Final Score:" line (ref: pastar/backtrace.cpp:53), "Similarity: x.xx%"
(ref: pastar/backtrace.cpp:162-164), the wrapped alignment, and the node
counts table (ref: pastar/PAStar.cpp:591-619).
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from typing import List

import torch

from .core.problem import Problem, problem_from_fasta
from .heuristic.hpair import HPairHeuristic
from .search.backtrace import build_alignment, format_alignment, similarity
from .search.engine import FrontierResult, FrontierSearch
from .utils.device import resolve_device
from .utils.timing import TimeCounter


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="msa_pastar_torch",
        description="PyTorch/CUDA parallel A* multiple sequence alignment",
    )
    ap.add_argument("fasta", help="input FASTA file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the search runs (default: cuda)")
    ap.add_argument("--width", type=int, default=None,
                    help="alignment print width (default: terminal width)")
    ap.add_argument("--batch", type=int, default=None,
                    help="frontier batch size (default: auto)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="hash-table capacity (default: auto)")
    ap.add_argument("--chunk", type=int, default=64,
                    help="super-steps per counters read")
    ap.add_argument("--fill", type=int, default=None,
                    help="selection-fill target for the threshold "
                         "controller (default batch/2 with triple cubes, "
                         "else batch/16)")
    ap.add_argument("--triples", choices=("auto", "on", "off", "fractional"),
                    default="auto",
                    help="triple-wise heuristic cubes (auto: when applicable;"
                         " fractional: all-triples cover with (n-2)-scaled"
                         " costs)")
    return ap


@dataclass
class Report:
    """What one run produced, for callers that check it (chip_smoke.py)."""
    problem: Problem
    engine: FrontierSearch
    result: FrontierResult
    alignment: List[str]
    walls: dict


def execute(args) -> Report:
    """Run the three phases for parsed ``args`` and print the output."""
    device = resolve_device(args.device)
    problem = problem_from_fasta(args.fasta)
    print(f"Aligning {problem.n_seq} sequences (max length {problem.max_length}) "
          f"with engine=frontier device={device.type}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with TimeCounter("Phase 1 - init heuristic: ") as t1:
        heuristic = HPairHeuristic.build(problem, device)
        sync()
    with TimeCounter("Phase 2: PA-Star running time: ") as t2:
        eng = FrontierSearch(problem, heuristic, device=device,
                             batch=args.batch, capacity=args.capacity,
                             chunk_steps=args.chunk, triples=args.triples,
                             fill_target=args.fill)
        res = eng.run()
        sync()
    coord_str = "(" + " ".join(str(int(v)) for v in problem.final_coord) + ")"
    print(f"Final Score: {coord_str}\tg - {res.g} (h - {res.h} f - {res.g + res.h})")

    with TimeCounter("Phase 3 - backtrace: ") as t3:
        al = build_alignment(problem, res.closed)
    print(f"Similarity: {similarity(al):.2f}%")
    print(format_alignment(al, args.width))

    stats = res.shard_stats
    print("Total nodes counters")
    for tid, (exp, reopen, closed_n, open_n) in enumerate(stats):
        print(f"tid {tid}\texpanded {exp}\treopened {reopen}"
              f"\tclosed {closed_n}\topen {open_n}")
    print(f"total\texpanded {sum(s[0] for s in stats)}"
          f"\treopened {sum(s[1] for s in stats)}"
          f"\tclosed {sum(s[2] for s in stats)}\topen {sum(s[3] for s in stats)}")
    if t2.elapsed > 0:
        print(f"throughput: {res.nodes_expanded / t2.elapsed:.0f} nodes expanded/s")
    walls = {"phase1": t1.elapsed, "phase2": t2.elapsed, "phase3": t3.elapsed}
    return Report(problem, eng, res, al, walls)


def run(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if not os.path.isfile(args.fasta):
        print(f"Option parse error: File {args.fasta} does not exist "
              f"or isn't a regular file", file=sys.stderr)
        return 1
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    execute(args)
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
