"""Command-line interface of the port: FASTA in, optimal alignment out.

Usage: ``python -m mpi_pastar_msa_tpu_torch [--device cuda|cpu]
[--engine auto|serial|native|frontier] [--triples auto|on|off|fractional]
[-t THREADS] [-s SHIFT] [-y HASH] [--checkpoint PATH] [--profile DIR]
[--memory_debug] <fasta>``.
Phase 1 (the pair tables, K1, and the Gotoh fill of the weights, K8) runs
on the card unless ``--device cpu`` is given; without a CUDA device it
exits non-zero rather than running on the CPU.  The engines are the JAX
CLI's (ref: pastar/msa_options.cpp:30-69 for -t, -s, -y and
--memory_debug): ``serial`` (the Python oracle), ``native`` (the C engine;
``-t`` > 1 its shared-memory HDA* engine), ``frontier`` (the batched
frontier A* on ``--device``, JAX's ``tpu``) and ``auto``, JAX's rule:
native for a lattice of at most 10^8 states, else frontier.

Output follows the JAX CLI and the reference's printed surface: the
"Final Score:" line (ref: pastar/backtrace.cpp:53), "Similarity: x.xx%"
(ref: pastar/backtrace.cpp:162-164), the wrapped alignment, and the node
counts table (ref: pastar/PAStar.cpp:591-619).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import os
import sys
from dataclasses import dataclass
from typing import List, Optional

import torch

from .core.problem import Problem, problem_from_fasta
from .heuristic.hpair import HPairHeuristic
from .search.backtrace import build_alignment, format_alignment, similarity
from .search.engine import FrontierSearch
from .search.native import NativeAStar
from .search.serial import SerialAStar
from .utils.device import resolve_device
from .utils.timing import TimeCounter

HASH_TYPES = ("FZORDER", "PZORDER", "FSUM", "PSUM")
ENGINES = ("auto", "serial", "native", "frontier")
#: ``--engine auto`` takes the native engine up to this many lattice states
AUTO_NATIVE_LATTICE = 10**8


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="msa_pastar_torch",
        description="PyTorch/CUDA parallel A* multiple sequence alignment",
    )
    ap.add_argument("-v", "--version", action="version",
                    version="msa_pastar_torch 0.1.0")
    ap.add_argument("fasta", help="input FASTA file")
    ap.add_argument("-t", "--threads", type=int, default=0,
                    help="worker threads of the native engine (>1: its HDA* "
                         "engine); the frontier engine runs on one device")
    ap.add_argument("-s", "--hash_shift", type=int, default=4,
                    help="owner-hash shift (default 4, as the JAX CLI; the "
                         "reference defaults to 12)")
    ap.add_argument("-y", "--hash_type", choices=HASH_TYPES, default="FSUM",
                    help="owner-hash strategy")
    ap.add_argument("--memory_debug", action="store_true",
                    help="strict-cleanup mode: drop all engine/heuristic "
                         "state, force GC, and report CUDA tensors still live "
                         "(the reference's flag keeps destructors for leak "
                         "checkers, ref: msa_options.cpp:114-117)")
    ap.add_argument("--engine", choices=ENGINES, default="auto",
                    help="search engine (frontier is the JAX CLI's tpu; auto: "
                         "native up to 10^8 lattice states, else frontier)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where Phase 1 and the frontier engine run "
                         "(default: cuda)")
    ap.add_argument("--width", type=int, default=None,
                    help="alignment print width (default: terminal width)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of Phase 2 into DIR")
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
    ap.add_argument("--checkpoint", metavar="PATH", default=None,
                    help="periodically checkpoint the frontier search; resumes "
                         "automatically if PATH holds one of the same problem")
    return ap


class UsageError(Exception):
    """A combination of flags the port does not run (exit code 2)."""


@dataclass
class Report:
    """What one run produced, for callers that check it (chip_smoke.py);
    ``heuristic`` is Phase 1's, ``engine`` the FrontierSearch (None for
    the serial and native engines)."""
    problem: Problem
    heuristic: HPairHeuristic
    engine_name: str
    engine: Optional[FrontierSearch]
    result: object
    alignment: List[str]
    walls: dict


def auto_engine(problem: Problem) -> str:
    """JAX's ``--engine auto``: native for a lattice of at most 10^8 states
    (small searches finish in milliseconds there), else frontier."""
    lattice = 1
    for s in problem.seqs:
        lattice *= len(s) + 1
        if lattice > AUTO_NATIVE_LATTICE:
            return "frontier"
    return "native"


@contextlib.contextmanager
def _profiled(trace_dir: Optional[str], device: torch.device):
    """A torch.profiler trace of the block into ``trace_dir`` (nothing when
    None)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "phase2_trace.json")
    prof.export_chrome_trace(path)
    print(f"profile trace written to {path}")


def execute(args) -> Report:
    """Run the three phases for parsed ``args`` and print the output."""
    device = resolve_device(args.device)
    problem = problem_from_fasta(args.fasta)
    print(f"Aligning {problem.n_seq} sequences (max length {problem.max_length}) "
          f"with engine={args.engine} hash={args.hash_type} shift={args.hash_shift} "
          f"device={device.type}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    engine = auto_engine(problem) if args.engine == "auto" else args.engine
    if engine == "frontier" and args.threads > 1:
        raise UsageError("the frontier engine runs on one device (the "
                         "multi-device engine is not ported yet); -t applies "
                         "to the native engine")

    with TimeCounter("Phase 1 - init heuristic: ") as t1:
        heuristic = HPairHeuristic.build(problem, device)
        sync()
    if args.engine == "auto":
        print(f"engine auto -> {engine}")

    eng = None
    with _profiled(args.profile, device):
        if engine == "serial":
            with TimeCounter("Phase 2: A-Star running time: ") as t2:
                res = SerialAStar(problem, heuristic).run()
            stats = [(res.nodes_expanded, res.nodes_reopened, len(res.closed),
                      res.open_size)]
        elif engine == "native":
            # -t > 1 selects the shared-memory HDA* engine — the reference's
            # thread model (ref: pastar/PAStar.cpp:643-654) run natively
            with TimeCounter("Phase 2: A-Star running time: ") as t2:
                res = NativeAStar(problem, heuristic, threads=max(1, args.threads)).run()
            # res.closed is the path-only dict for the backtrace renderer; the
            # closed-list size (per thread) comes from the engine counters
            stats = res.thread_stats
        else:
            with TimeCounter("Phase 2: PA-Star running time: ") as t2:
                eng = FrontierSearch(problem, heuristic, device=device,
                                     batch=args.batch, capacity=args.capacity,
                                     chunk_steps=args.chunk, triples=args.triples,
                                     fill_target=args.fill,
                                     checkpoint_path=args.checkpoint)
                res = eng.run()
                sync()
            stats = res.shard_stats
    coord_str = "(" + " ".join(str(int(v)) for v in problem.final_coord) + ")"
    print(f"Final Score: {coord_str}\tg - {res.g} (h - {res.h} f - {res.g + res.h})")

    with TimeCounter("Phase 3 - backtrace: ") as t3:
        al = build_alignment(problem, res.closed)
    print(f"Similarity: {similarity(al):.2f}%")
    print(format_alignment(al, args.width))

    print("Total nodes counters")
    for tid, (exp, reopen, closed_n, open_n) in enumerate(stats):
        print(f"tid {tid}\texpanded {exp}\treopened {reopen}"
              f"\tclosed {closed_n}\topen {open_n}")
    total_exp = sum(s[0] for s in stats)
    print(f"total\texpanded {total_exp}"
          f"\treopened {sum(s[1] for s in stats)}"
          f"\tclosed {sum(s[2] for s in stats)}\topen {sum(s[3] for s in stats)}")
    if t2.elapsed > 0:
        print(f"throughput: {total_exp / t2.elapsed:.0f} nodes expanded/s")
    walls = {"phase1": t1.elapsed, "phase2": t2.elapsed, "phase3": t3.elapsed}
    return Report(problem, heuristic, engine, eng, res, al, walls)


def memory_debug() -> None:
    """The device analogue of the reference's --memory_debug (which keeps
    destructors so valgrind sees them, ref: pastar/msa_options.cpp:114-117),
    worded as the JAX CLI's: after every engine and heuristic reference is
    dropped and the garbage collected, the CUDA tensors still alive and the
    bytes the allocator holds for tensors."""
    gc.collect()
    # type(), not isinstance(): the latter reads __class__, which some
    # deprecated module proxies answer with a warning
    live = [o for o in gc.get_objects()
            if issubclass(type(o), torch.Tensor) and o.is_cuda]
    n_bytes = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    print(f"memory_debug: {len(live)} live device arrays, "
          f"{n_bytes / 1e6:.1f} MB after cleanup")


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
    try:
        report = execute(args)
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.memory_debug:
        del report
        memory_debug()
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
