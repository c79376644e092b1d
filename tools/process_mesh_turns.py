"""One rank of a ProcessMesh run of the sharded engine, under each driver
in turn.

Started once a rank, as ``torchrun`` starts a program (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``): rank 0 reads the FASTA and
broadcasts the sequences (``parallel/multihost.py``), every rank holds one
shard of a ``ProcessMesh`` (gloo for CPU tensors, NCCL for CUDA ones) and
runs ``ShardedFrontierSearch`` under each driver of ``--drivers`` in that
order, a new engine each time, with the exchange of ``--exchange``
(auto: ragged on cards, each rank's exchange reading the other ranks'
wires through CUDA IPC mappings; dense on the CPU).  After each run a rank
prints one JSON line ``RANK_RUN {...}``: its rank, the driver, the
exchange, g, steps, host reads and walk reads, wire rows a step, each
kernel's launches, the wall a step (the chunked driver's also without its
graph captures, whose parts it gives: the warm-up step, which also makes
the NCCL communicator, the host code while captured, the rest), the peak
device memory, the alignment, and a SHA-256 of every word its shard's step
leaves that does not depend on the order lanes run in (the table, the
counters, the step state, both rings and which is current, the received
count, the insert flag, the route's out, the candidate rows, the wire,
and the consensus vector): two drivers on the same mesh must print the
same hash on every rank.

    WORLD_SIZE=4 RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
        python3 tools/process_mesh_turns.py kinase.fasta --drivers chunked,host
    torchrun --nproc-per-node 4 tools/process_mesh_turns.py kinase.fasta \\
        --drivers chunked,host,chunked --exchange ragged,ragged,dense

``--exchange`` takes one exchange for every run or one a run.  ``--device
cpu`` runs the shards' plain versions over gloo.  ``--kernel-times``
traces each run with torch.profiler (CUPTI: the kernels inside the step
graphs too) and adds each kernel's launches and mean device time in
microseconds (``kernel_us``; cards only), so one kernel's time inside a
rank's step reads from the run; the trace slows the run's walls.
"""
import argparse
import contextlib
import hashlib
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpi_pastar_msa_tpu_torch import _kernels  # noqa: E402
from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta  # noqa: E402
from mpi_pastar_msa_tpu_torch.parallel.mesh import ProcessMesh  # noqa: E402
from mpi_pastar_msa_tpu_torch.parallel.multihost import (broadcast_problem,  # noqa: E402
                                                         init_distributed)
from mpi_pastar_msa_tpu_torch.parallel.sharded import ShardedFrontierSearch  # noqa: E402
from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment  # noqa: E402
from mpi_pastar_msa_tpu_torch.search.step import STATE_CNT  # noqa: E402


def words_hash(eng) -> str:
    """SHA-256 of the local shards' words (the module docstring's list)."""
    h = hashlib.sha256()
    for sh in eng.shards:
        words = [getattr(sh.tab, f) for f in sh.tab.__dataclass_fields__]
        words += [sh.ctr, sh.state[:STATE_CNT], *sh.rings, torch.tensor(sh.cur), sh.recv,
                  sh.go, sh.route_out, sh.cand, sh.wire]
        for t in words:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(eng.cards[0].cons.cpu().numpy().tobytes())
    return h.hexdigest()


def kernel_name(key: str) -> str:
    """A traced kernel's name without its return type, namespaces and
    arguments (its template arguments kept)."""
    key = key.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
    base, lt, args = key.partition("<")
    return base.rsplit("::", 1)[-1] + lt + args


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("fasta")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--drivers", default="chunked,host",
                    help="drivers to run in turn, comma-separated (auto, chunked, host)")
    ap.add_argument("--exchange", default="auto",
                    help="the exchange of every run, or one a run, comma-separated (auto, "
                         "ragged, dense)")
    ap.add_argument("--chunk", type=int, default=256, help="chunk_steps")
    ap.add_argument("--kernel-times", action="store_true",
                    help="trace each run and print each kernel's launches and mean device "
                         "time (us)")
    args = ap.parse_args()
    drivers = args.drivers.split(",")
    exchanges = args.exchange.split(",")
    if len(exchanges) == 1:
        exchanges *= len(drivers)
    if len(exchanges) != len(drivers):
        ap.error(f"{len(exchanges)} exchanges for {len(drivers)} drivers")
    rank = init_distributed()
    world = torch.distributed.get_world_size()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device; pass --device cpu", file=sys.stderr)
            return 2
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = torch.device("cpu")
    problem = broadcast_problem(problem_from_fasta(args.fasta) if rank == 0 else None)
    mesh = ProcessMesh(dev)
    for driver, exchange in zip(drivers, exchanges):
        eng = ShardedFrontierSearch(problem, devices=mesh, driver=driver, exchange=exchange,
                                    chunk_steps=args.chunk)
        _kernels.reset_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        timed = args.kernel_times and dev.type == "cuda"
        trace = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                 if timed else contextlib.nullcontext())
        t0 = time.perf_counter()
        with trace as prof:
            res = eng.run()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        st = eng.last_stats
        steps = max(st["steps"], 1)
        out = dict(rank=rank, world=world, device=str(dev),
                   name=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   driver=st["driver"], exchange=eng.exchange, layout=eng.layout, g=res.g,
                   steps=st["steps"], host_reads=st["host_reads"],
                   host_reads_a_step=st["host_reads"] / steps, walk_rounds=st["walk_rounds"],
                   walk_reads=st["walk_reads"], wire_rows_a_step=st["wire_rows"] / steps,
                   graph_captures=st.get("graph_captures", 0),
                   step_ms=st["search_s"] / steps * 1e3,
                   step_ms_no_capture=(st["search_s"] - st.get("capture_s", 0.0)) / steps * 1e3,
                   capture_s=st.get("capture_s", 0.0),
                   capture_parts={k: st[k] for k in ("capture_warm_s", "capture_host_s",
                                                     "capture_instantiate_s", "walk_warm_s",
                                                     "walk_capture_s") if k in st},
                   walk_s=st["walk_s"], run_s=wall,
                   peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
                   launches={k: v for k, v in _kernels.launches.items() if v},
                   hash=words_hash(eng), alignment=build_alignment(problem, res.closed))
        if timed:
            out["kernel_us"] = {kernel_name(e.key): dict(
                launches=e.count, mean_us=e.device_time_total / e.count)
                for e in prof.key_averages() if e.count and e.device_time_total > 0}
        print("RANK_RUN " + json.dumps(out), flush=True)
        del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
