"""Command-line interface of the port: FASTA in, optimal alignment out.

Usage: ``python -m mpi_pastar_msa_tpu_torch [--device cuda|cpu]
[--engine auto|serial|native|frontier] [--triples auto|on|off|fractional]
[-t THREADS] [--devices N] [--exchange auto|ragged|dense] [-s SHIFT]
[-y HASH] [--checkpoint PATH] [--profile DIR] [--memory_debug] <fasta>``.
Phase 1 (the pair tables, K1, and the Gotoh fill of the weights, K8) runs
on the card unless ``--device cpu`` is given; without a CUDA device it
exits non-zero rather than running on the CPU.  The engines are the JAX
CLI's (ref: pastar/msa_options.cpp:30-69 for -t, -s, -y and
--memory_debug): ``serial`` (the Python oracle), ``native`` (the C engine;
``-t`` > 1 its shared-memory HDA* engine), ``frontier`` (the batched
frontier A* on ``--device``, JAX's ``tpu``) and ``auto``, JAX's rule:
native for a lattice of at most 10^8 states, else frontier.  The frontier
engine runs ``--devices`` shards (default ``-t`` when it is above 1, else
one): above one, the sharded engine (parallel/sharded.py), its shards
round-robin over the visible cards (``--devices 4`` on one card is four
shards on it), or one shard a rank when the run is a torch.distributed
group (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), where
rank 0 reads the FASTA and broadcasts the sequences.

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
import torch.distributed as dist

from .core.problem import Problem, problem_from_fasta
from .heuristic.hpair import HPairHeuristic
from .parallel.multihost import broadcast_problem, init_distributed
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
                         "engine); with the frontier engine, the shard count "
                         "when --devices is not given")
    ap.add_argument("--devices", type=int, default=0,
                    help="shards of the frontier engine (>1: the sharded "
                         "engine; default -t if above 1, else 1)")
    ap.add_argument("--exchange", choices=("auto", "ragged", "dense"), default="auto",
                    help="the sharded engine's exchange (auto: ragged when every "
                         "shard is on a card, else dense)")
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


def shard_devices(device: torch.device, n_dev: int) -> list:
    """The shards' devices: round-robin over the visible cards, or every
    shard on the CPU."""
    if device.type != "cuda":
        return [torch.device("cpu")] * n_dev
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n_dev)]


def execute(args, problem: Optional[Problem] = None) -> Report:
    """Run the three phases for parsed ``args`` (on ``problem``, else the
    FASTA's) and print the output."""
    device = resolve_device(args.device)
    if problem is None:
        problem = problem_from_fasta(args.fasta)
    print(f"Aligning {problem.n_seq} sequences (max length {problem.max_length}) "
          f"with engine={args.engine} hash={args.hash_type} shift={args.hash_shift} "
          f"device={device.type}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    engine = auto_engine(problem) if args.engine == "auto" else args.engine
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    n_dev = args.devices or (args.threads if args.threads > 1 else 1)
    if world > 1 and engine == "frontier":
        if n_dev not in (1, world):
            raise UsageError(f"--devices {n_dev}: a run of {world} processes holds one "
                             "shard a process")
        n_dev = world
    if engine == "frontier" and n_dev > 1 and args.checkpoint:
        raise UsageError("the sharded engine (-t or --devices above 1) keeps no "
                         "checkpoint; --checkpoint applies to one shard")

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
        elif n_dev > 1:
            from .parallel.mesh import ProcessMesh
            from .parallel.sharded import ShardedFrontierSearch

            if world > 1:
                rank = dist.get_rank()
                devs = [shard_devices(device, world)[rank]]
                mesh = ProcessMesh(devs[0])
                print(f"shards: {world}, one a process; rank {rank} on {devs[0]}")
            else:
                mesh = devs = shard_devices(device, n_dev)
                print(f"shards: {n_dev} on " + ", ".join(str(d) for d in devs))
            # the triple cubes as the JAX CLI passes them (mpi_pastar_msa_tpu/
            # cli.py:165-187): `fractional` is refused where it does not
            # apply, `on` keeps the pair heuristic there; the engine builds
            # the cubes itself whenever the heuristic it is given has none
            if args.triples == "off":
                heuristic = getattr(heuristic, "base", heuristic)
            elif args.triples in ("on", "fractional") and not getattr(heuristic, "triangles",
                                                                         None):
                from .heuristic.triples import HTriples

                frac = args.triples == "fractional"
                ht = HTriples.build(heuristic, device=devs[0], fractional=frac,
                                    **({"budget_bytes": 10 << 30} if frac else {}))
                if ht is None and frac:
                    raise UsageError("--triples fractional: the triple heuristic is not "
                                     "applicable to this input")
                heuristic = ht if ht is not None else heuristic
            with TimeCounter("Phase 2: PA-Star running time: ") as t2:
                eng = ShardedFrontierSearch(problem, heuristic, devices=mesh,
                                            hash_type=args.hash_type,
                                            hash_shift=args.hash_shift, batch=args.batch,
                                            capacity=args.capacity, chunk_steps=args.chunk,
                                            exchange=args.exchange, fill_target=args.fill)
                res = eng.run()
                sync()
            st = eng.last_stats
            print(f"sharded: layout {eng.layout}, exchange {eng.exchange} (cap "
                  f"{eng.exchange_cap}), shard cubes {eng.shard_cubes}, capacity "
                  f"{eng.st.C} a shard, batch {eng.st.B} a shard; {st['steps']} steps, driver "
                  f"{st['driver']}, {st['host_reads'] / max(st['steps'], 1):.2f} host reads a "
                  f"step, "
                  f"{st['wire_rows']} wire rows, peak carry {st['peak_carry']}, walk "
                  f"{st['walk_rounds']} rounds")
            stats = res.shard_stats
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
    for tid, row in enumerate(stats):
        exp, reopen, closed_n, open_n = row[:4]
        migr = f"\tmigrated {row[4]}" if len(row) > 4 else ""
        print(f"tid {tid}\texpanded {exp}\treopened {reopen}"
              f"\tclosed {closed_n}\topen {open_n}{migr}")
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
    # the multi-process bootstrap (nothing in a single process): rank 0
    # reads the FASTA and broadcasts it, as the reference's MPI rank 0
    # (ref: pastar/msa_pastar_main.cpp:97-179)
    rank = init_distributed()
    if (dist.is_initialized() and dist.get_world_size() > 1 and args.device == "cuda"
            and torch.cuda.is_available()):
        torch.cuda.set_device(rank % torch.cuda.device_count())  # the rank's card
    if rank == 0 and not os.path.isfile(args.fasta):
        print(f"Option parse error: File {args.fasta} does not exist "
              f"or isn't a regular file", file=sys.stderr)
        return 1
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    problem = broadcast_problem(problem_from_fasta(args.fasta) if rank == 0 else None)
    try:
        report = execute(args, problem)
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
