"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit):

1. device: a CUDA device must exist; prints the card's name and power limit.
2. build: compiles every kernel from csrc/ (one nvcc per source, in
   parallel) and, beside them, K3's, K5's, K8's, K9s's and K11's
   measurement builds.
   Capture: a chunk of the sig step (K3, K4 and the cooperative K5, on
   each of K5's paths) as the engine runs it (K6: the set-up, then a
   graph of one captured step replayed) must equal the eager chunk.
3. kernel check: each kernel against its plain PyTorch version on the card,
   exact int32 equality.  K8 (the Gotoh fill of Phase 1's weights,
   csrc/gotoh_wavefront.cu) at kinase, globin6, synth4_long, synth10 and
   random pairs of very unequal lengths, also against the host fill over
   every pair's box: wrapper, device (and its fill and tiled transpose
   apart), plain, host-fill and crop-and-copy times, the scratch's bytes,
   bounds by bytes and operations, the dependent-diagonal floor
   (``--k8-baseline SRC`` builds another tree's K8, one with no scratch,
   checks it against this one and times the two in turns); then
   Phase 1's wall with K8 and with the host fill, in turns, at the first
   four (their distances and weights equal).
   K1 (pair wavefront) at the main path's shapes
   (kinase) and at synth4_long's: kernel, plain, bound and
   dependent-diagonal floor times, also per diagonal (``--k1-baseline SRC``
   builds the first version of the K1 source and times it in turns with this
   one).  K2 (triple cubes) at kinase's own cover and at one ragged shape:
   the whole stack and the origins; kernel, plain and bound times, the
   dependent-launch floor of its tile diagonals and, beside it, that of
   one launch per plane (``--k2-baseline SRC`` builds the plane-per-launch
   version of the K2 source and times it in turns with this one;
   ``--k2-variant TILE SRC`` does the same for an edited copy of the
   current source, e.g. another tile or shared-memory layout).
   Step kernels: K3 (select_best.cu), K4 (sig_expand.cu) and K5
   (sig_probe.cu) run 1 and 32 steps from mid-search kinase tables (--triples
   auto from step 150, off from step 400) as a chunk graph, and the plain
   step functions run the same steps on copies: t_sig, t_best, t_closed
   and the 14 counters must be identical (also with K5 on 1 and on 132
   blocks, at its cap and on its grid path); the chunk graph against the
   eager chunk (K6), and the chunk loop (a one-step graph replayed) in
   turns with the 32-step graph it replaced (loop turns, 32 steps at
   kinase `auto` step 150, `off` step 400, globin6 step 60 and kinase
   unpacked step 150: span between events, wall, the gap a step, the
   capture by part); K3 alone against the plain select on globin6's
   packed table.  The packed and unpacked step kernels K3 (select_best.cu, both
   instantiations), K9 (keyrow_expand.cu) and K10 (keyrow_insert.cu) run 1
   and 32 steps from globin6's table (packed, step 60) and from kinase's
   pinned to unpacked (step 150) as a chunk graph and as the eager chunk
   (1 step also with K10 on one block), each with K10 at its cap K10_CAP
   (a list that long in one block, else round 0 on the grid and a tail
   that long in one block) and with every round on the grid (cap 0),
   against the plain step on copies: every table tensor (claim included)
   and the 14 counters identical; their kernel, plain and bound times,
   K9's launch shape (a block a row), its surviving lanes and the ones it
   leaves pending after its round-0 match (globin6: fewer, or the run
   fails), its bounds by bytes and by operations, K10 on both paths with
   its grid syncs a step and its K10_PHASES split, and K3's torch.min
   yardstick (``--keyrow-baseline SRC`` builds another tree's K10 and K7,
   checks its K10 against this one on the same tables and times the two
   in turns, and its K7 on the timed walks; ``--k10-sweep`` times K10
   against its list length, 64 to 4,096 entries on a synthetic kinase
   table: one block, round 0 on the grid, every round on the grid, the
   other tree's).  The cost of one grid sync (an empty
   cooperative kernel of 132 x 512 threads with 1, 4 and 16), and K10's
   tail (lanes left after round 0) and improving lanes a step over the
   globin6, kinase-unpacked and synth10 searches, by path.  Kernel,
   plain and bound times of K3, K4, K5 and the whole step,
   each kernel's device time (CUPTI, torch.profiler) beside its
   event-timed wrapper call, K3's and K5's phase splits, the chunk's time
   as a graph and eager and its capture, the empty-kernel launch floor,
   K3's library yardstick (torch.min) with its own bound
   (``--step-baseline SRC`` builds another tree's K3, K4 and K5, checks
   them against these and times them in turns on the same tables;
   ``--k5-sweep`` times K5 on both its paths, and the other tree's, at
   every step of three searches; ``--step-only`` stops after this phase).
4. main path, kinase: the port's CLI entry with --engine frontier and its
   other defaults (--triples auto, --device cuda) must build 4 cubes and reach g = 421546 with a path
   whose recomputed cost equals g, degapped rows equal to the inputs, and
   K1, K2 and the step kernels K3-K5 launched (one step graph, each step
   kernel launched once before the capture and once a replay,
   chunk_steps replays a chunk); then the same with
   --triples off (K1 and K3-K5 launched); every run prints the engine's
   named walls (the statics' build, the chunk loop, the capture by part,
   _finish);
   then synth6 (tests/data, N = 6, 63 masks a row) with the CLI's defaults
   on the sig layout: g = 272848.
5. main path, test / test2 / PF08184, under auto and under off: golden g and
   byte-identical alignment.  Every CLI run on the card (phases 4-6 pin
   --engine frontier, whose step kernels they check) launches K1 and K8
   once in Phase 1 and has the host fill's weights.  The CLI's other
   engines, Phase 1 on the card: --engine auto on test2 (it must print
   "engine auto -> native"), --engine serial and --engine native -t 4 on
   PF08184: the golden g, path cost g, degapped rows, the golden
   similarity; whether each alignment is byte-identical to the golden.
6. layouts: globin6, synth7 and synth10 (tests/data) through the CLI with
   its defaults must take the packed table layout (their keys do not fit a
   sig word at C = 2^23), build cubes, launch K1, K2, K3, K9 and K10 and
   reach their certified optima; kinase with the layout pinned to packed
   and to unpacked (engine entry, as --profile drives it) must reach g =
   421546; test, test2 and PF08184 with each pinned must stay
   byte-identical to the goldens; the degenerate input ("WYWY", "WYY",
   "YWW") must warn, take the unpacked layout and complete.  Every run on
   the card (phases 4-6) must launch its layout's three step kernels (K3,
   K4, K5 on sig; K3, K9, K10 on packed; K3's unpacked instantiation, K9,
   K10 on unpacked), one chunk graph a run, and no plain step function.
   synth10's step (N = 10, 1023 masks) from step 20 of its main-path
   engine against the plain step, as in phase 3.
   The walk (phases 4-6): every run on the card walks its path with K7
   (csrc/path_walk.cu), once, and never with the plain _walk (a counting
   wrapper); on each run's finished table K7's masks and final coordinate
   must equal _walk's on the card; the walk's wall is printed for every
   run, and K7's wrapper, device and plain times (device with the table
   in L2 and after an eviction), its bound by bytes and its latency floor
   (path nodes x one dependent load from L2, and beside it from device
   memory, each timed by a pointer chase through 256 MiB) at kinase,
   globin6 and kinase pinned to unpacked (with another tree's K7 checked
   against K7 and timed in turns with it); then K7's device time on the
   engine's own walk, right after a search (engine_walk: kinase pinned to
   each layout, and globin6), in turns with the other tree's K7.
   Checkpoint/resume: kinase (sig) and globin6 (packed) stopped by
   max_steps at 128 steps with a checkpoint, then resumed by a new engine:
   the optimum, the uninterrupted search's counts, kinase's golden
   alignment, one chunk graph the resumed run captured, K7 once; the
   save and load walls and the file's size.
7. sharded (parallel/sharded.py, a LocalMesh of [cuda:0] * 4 through
   ShardedFrontierSearch.run): kinase --triples auto, whose automatic
   layout is packed at JAX's 2^21 slots a shard (sharded cubes), with the
   ragged exchange under the chunked driver (a step one CUDA graph for
   each ring parity, two captures, a chunk 256 replays of them: at most
   0.01 host reads a step) and with
   the dense one (traced: device time a step) must reach g = 421546 with
   the golden alignment and migrated rows, launching K3, keyrow_coords,
   K12 (tri_partial.cu), K9's sharded instantiation (keyrow_expand.cu),
   K11 on key rows (route_pack.cu), K10 on the received rows
   (keyrow_insert.cu), the loop's consensus and exchange (shard_loop.cu)
   and the walk in one launch (path_walk_shards, path_walk.cu: one card),
   and no plain version; on the finished tables the one-launch walk and
   the walk's round form (K7's hop mode and walk_advance, which several
   cards run) give the host walk's masks and rounds, timed in turns,
   path_walk_shards timed with its call split on the host's clock (also
   on the sig and unpacked runs' tables), each round's device span traced,
   walk_advance is captured over a programmatic edge from the round's
   last walk (where the runs lie on several cards, one full edge from an
   empty node after them) and equals its plain version; kinase packed,
   pinned to unpacked (K3's unpacked
   instantiation, the whole cube stack on every shard) and pinned to sig
   at 2^23 slots a shard (sig_coords, K4's sharded instantiation, K11 on
   sig rows, K5) each run 256 steps under the chunked and then the host
   driver with every table, ring, counter and telemetry word equal, then
   in full under the host driver;
   any overflow retry and the capacity reached; one shard of kinase;
   PF08184 with exchange_cap=1; a random 4-sequence input whose one-row
   wire must spill into the carry ring (its brute-force optimum), on sig
   and pinned to unpacked; the degenerate input on 4 shards (unpacked,
   warned, the single-table unpacked search's g and alignment); test2
   under FZORDER, PZORDER, FSUM and PSUM.  On step 200 of the packed, the
   unpacked and the sig kinase runs (host driver) each kernel of the step
   against its plain version bit for bit (the consensus and the exchange
   on the packed run; K11 under both allowances, on sig rows with
   each destination's sort barriers as its K11_BARRIERS build counts
   them; K10 over the received rows and the self-owned lanes: every
   table tensor, the claim words and the 14 counters, as the run made it
   and run again, its path, list and K10_PHASES split, and with
   ``--keyrow-baseline`` the other tree's K10 in turns; K7's hop mode on
   every shard's table from every path node), their wrapper, device and
   plain times and byte bounds, and sharded_step_bounds at the run's B
   and cap
   (``--k11-baseline SRC`` builds another tree's K11, checks it on the
   same inputs and times the two in turns, each pass alone;
   ``--k6s-baseline SRC`` another tree's consensus, exchange or
   walk_advance, whichever of its forms the source has, each in turns
   with this tree's, walk_advance also inside the walk loop;
   ``--k11-sweep`` checks and times K11 on synthetic kinase-shaped inputs
   of 64 to 31,744 rows a destination); K9s on step 200's packed and
   unpacked rows at each rows a block of its sweep (0, the block form, a
   block a row; 1, 2, 4, 8 warps a block of the rows form) and K4s on the
   sig run's step 200 at each of its own (0 the warp-strided form; the
   rows form from sig_coords' coordinates, and decoding the sig words),
   then synth5 (auto: sig at 2^21 a shard) chunked to g = 266713 and its
   step 150 under the host driver (its run ends at step 186), synth6 (N = 6: the warp-strided form)
   at step 40, and the dense sig step traced with each of K4s's forms:
   bit for bit,
   device and wrapper times and its K9S_PHASES split (``--k9s-baseline
   SRC`` builds another tree's K9s, checks it and times it in turns with
   this one; ``--k9s-only`` runs K9s's checks alone, on kinase and on the
   random 4 x 12-16 input, packed and unpacked, with the unsharded K9
   against the other tree's at globin6 and synth10 and a traced dense
   run with each form of K9s; K4s the same with its K4S_PHASES split,
   ``--k4s-baseline SRC``, ``--k4s-rows`` and ``--k4s-only``).  The several-card step on this
   one card: kinase's four shards grouped into two cards (``split_cards``),
   chunked (a stream a card, one graph a ring parity, the gathers as
   copies, every card's consensus over every shard's snapshot), held to
   the host driver's rank form on the same mesh table word for table
   word and to the golden, and the first card's consensus over the
   snapshots against its plain version.  A ProcessMesh's step on this one
   card: kinase in the rank form (``rank_form``: a card a shard, the
   mesh's collectives as copies in NCCL's places), chunked under the
   ragged exchange (every rank's exchange reading the senders' wires by
   address) and the dense one, the golden g and alignment, every table
   word equal to the host driver's in the same form, one host read a
   chunk in the search and in the walk, its wall a step with and without
   the captures, and every rank's exchange (from the wires, from its
   received blocks) against its plain version; then two processes on the
   card, each running the exchange from the other's wire mapped through
   CUDA IPC, against its plain version (``ipc_check``).  Several cards,
   when there are: kinase one shard a card, chunked and host in turns,
   equal and golden, a traced chunked run, and a ProcessMesh of NCCL
   ranks, the CLI (auto: ragged, chunked) and then the engine in turns
   (ragged chunked, ragged host, dense chunked, ragged chunked), each
   rank's table words equal under both drivers of an exchange; else it
   says so (``--sharded-only`` runs this phase alone,
   ``--multi-card-only`` its several-card part).
8. the kernels JSON line, then the result line.

Inputs are rebuilt from tests/goldens.json (the degapped golden rows) and
read from tests/data/*.fasta.  Weights are not random: the system runs no
model, and its data are these real sequences.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import gc
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (data sheet)
# H100 SXM: 132 multiprocessors at the 1.98 GHz boost clock (the clock of
# the data sheet's 67 TFLOP/s in float32), 64 int32 lanes each (half the
# float32 lanes), and one shared-memory wavefront a clock each
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SHARED_WAVEFRONTS_PER_S = 132 * 1.98e9
NVLINK_BYTES_PER_S = 450e9    # H100 SXM NVLink, each way (data sheet)
K1_OPS_PER_CELL = 12          # int32 adds/compares/selects per DP cell
K2_OPS_PER_CELL = 7 * 12      # 7 moves x ~12 int32 ops per in-box cube cell
K8_OPS_PER_CELL = 16          # int32 adds/compares/selects per Gotoh cell (dd, hh, vv)
# certified optima of the tests/data inputs beyond the sig layout
# (tests/test_globin6.py, tests/test_beyond_reference.py)
LAYOUT_INPUTS = {"globin6": 988171, "synth7": 402469, "synth10": 575615}
# (expansions, reopens, steps) of the main path's searches, which the
# kernels must not move (they equal the plain step): PERF.md section 5
MAIN_PATH_COUNTS = {("globin6", "auto"): (170120, 52953, 154),
                    ("synth7", "auto"): (28604, 3045, 122),
                    ("synth10", "auto"): (14185, 723, 79),
                    ("kinase", "auto"): (985050, 346443, 299),
                    ("kinase", "off"): (5137387, 593519, 966)}
SYNTH6_G = 272848  # tests/test_synth6.py
STEP_KERNELS = ["select_best", "sig_expand", "sig_probe"]
# the step kernels of each table layout (K3, then K4 and K5 or K9 and K10)
LAYOUT_KERNELS = {"sig": STEP_KERNELS,
                  "packed": ["select_best", "keyrow_expand", "keyrow_insert"],
                  "unpacked": ["select_best_unpacked", "keyrow_expand", "keyrow_insert"]}
# the plain functions that no run on the card may call (the plain loop,
# the expand and insert it alone calls, and the plain walk)
PLAIN_STEP = ("_run_chunk_plain", "_expand_insert", "_expand", "_probe_claim", "_walk")
# another tree's K7 ("baseline", --keyrow-baseline; the same C entry), set
# in main() and timed in turns with K7 by check_k7 and engine_walk
K7_VARIANTS = {}
# the host fill's Altschul weights of each input (check_weights), by sequences
HOST_WEIGHTS = {}
# the searches whose own walk engine_walk times: (label, input, layout)
ENGINE_WALKS = (("kinase", "kinase.fasta", "sig"), ("kinase", "kinase.fasta", "packed"),
                ("kinase", "kinase.fasta", "unpacked"), ("globin6", "globin6", "packed"))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def own_event(key: str) -> bool:
    """A device event of the call under test in a torch.profiler window:
    kernels and memsets, not the host's runtime calls, PyTorch's ops and
    kernels, device copies (the restores between calls) or the session's
    preamble."""
    return (not key.startswith(("aten::", "cuda", "Memcpy")) and "at::native" not in key
            and "spin_kernel" not in key)


PREAMBLE_SPINS = 32


def profiler_preamble() -> None:
    """What a torch.profiler session runs before the work it measures:
    PREAMBLE_SPINS short spin kernels (torch.cuda._sleep), then 50 ms of
    host time.  A session can miss the device events of its first moments
    (seen on the card: the first 4 of 32 steps of a window); these take
    their place.  Their device events are named spin_kernel and every count
    leaves them out; their launch calls on the host (cudaLaunchKernel) are
    taken off the host's count."""
    for _ in range(PREAMBLE_SPINS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.05)


def device_ms(fn, reps: int, restore=None, keep=own_event) -> float:
    """Device milliseconds of one call of fn(): from torch.profiler's CUPTI
    durations of the device events that ``keep`` takes, over ``reps``
    calls (each after ``restore()``, whose copies and fills are left out),
    the sum over event names of the mean duration times the launches a
    call makes (the count over ``reps``, rounded), so that an event missed
    or added at the session's edge does not move it.  A session that
    recorded none is run again, at most twice."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiler_preamble()
            for _ in range(reps):
                if restore:
                    restore()
                fn()
            torch.cuda.synchronize()
        own = [e for e in prof.key_averages() if keep(e.key) and e.count]
        per_call = sum(e.device_time_total / e.count * round(e.count / reps) for e in own)
        if per_call > 0:
            return per_call / 1e3
        print(f"  (torch.profiler session {attempt + 1} recorded no device time for the "
              f"call under test; run again)")
    fail("torch.profiler recorded no device time for the call under test")


def launch_floor(launches: int = 1, blocks: int = 132, threads: int = 512) -> dict:
    """The empty-kernel launch floor: ``launches`` back-to-back launches of
    an empty kernel of blocks x threads (plane_chain, csrc/triple_wavefront.cu)
    from one ctypes call, as a wrapper call is timed (CUDA events, median of
    20), and their device time (CUPTI)."""
    from mpi_pastar_msa_tpu_torch._kernels import load

    fn = load("triple_wavefront").plane_chain
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def go():
        if fn(launches, blocks, threads, torch.cuda.current_stream().cuda_stream):
            fail("plane_chain probe failed to launch")

    return dict(launches=launches, blocks=blocks, threads=threads,
                ms=time_ms(go, reps=20), device_ms=device_ms(go, 20))


def rebuild_inputs(tmp: str) -> dict:
    gold = json.load(open(os.path.join(ROOT, "tests", "goldens.json")))
    paths = {}
    for name, g in gold.items():
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            for k, row in enumerate(g["alignment"]):
                f.write(f">seq{k}\n{row.replace('-', '')}\n")
        paths[name] = path
    return gold, paths


def build_baseline_k1(src: str, tmp: str):
    """Build the first version of the K1 source (``git show`` of
    csrc/pair_wavefront.cu at the commit that added it), to time beside the
    current kernel.  Its C entry takes (enc, enc_stride, xs, ys, lens, cost,
    out, P, L1, lmax, O, E, stream)."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.core.cost import GAP_EXTENSION, GAP_OPEN
    from mpi_pastar_msa_tpu_torch.heuristic.wavefront import _device_cost

    lib_path = os.path.join(tmp, f"libk1_{abs(hash(src))}.so")
    subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib_path, src], check=True, capture_output=True)
    fn = ctypes.CDLL(lib_path).pair_wavefront
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(enc, xs, ys, lens, lmax):
        P, L1 = xs.shape[0], lmax + 1
        out = torch.empty((P, L1, L1), dtype=torch.int32, device="cuda")
        if fn(enc.data_ptr(), enc.shape[1], xs.data_ptr(), ys.data_ptr(),
              lens.data_ptr(), _device_cost(enc.device).data_ptr(), out.data_ptr(),
              P, L1, lmax, GAP_OPEN, GAP_EXTENSION,
              torch.cuda.current_stream().cuda_stream):
            fail(f"K1 build of {src} failed to launch")
        return out

    return run


def check_k1(paths, baseline=None) -> dict:
    """K1 against its plain version at kinase and synth4_long, with times;
    ``baseline`` is (source, run) of the first version's build, or None."""
    from mpi_pastar_msa_tpu_torch._kernels import launches, load
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.wavefront import (
        k1_launch_shape, pair_inputs, wavefront_tables, wavefront_tables_plain)

    rows = {}
    for label, path in (("kinase", paths["kinase.fasta"]),
                        ("synth4_long", os.path.join(ROOT, "tests", "data",
                                                     "synth4_long.fasta"))):
        p = problem_from_fasta(path)
        args = pair_inputs(p, "cuda")
        n0 = launches["pair_wavefront"]
        got = wavefront_tables(**args)
        torch.cuda.synchronize()
        if launches["pair_wavefront"] != n0 + 1:
            fail("pair_wavefront wrapper did not launch its kernel")
        want = wavefront_tables_plain(**args)
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            fail(f"K1 {label}: kernel differs from plain version (max |err| {err})")
        ms = time_ms(lambda: wavefront_tables(**args), reps=20)
        dev_ms = device_ms(lambda: wavefront_tables(**args), 20)
        plain_ms = time_ms(lambda: wavefront_tables_plain(**args), reps=3, warmup=1)
        P, L1 = got.shape[0], got.shape[1]
        threads, rows_per_thread, shared = k1_launch_shape(L1 - 1)
        lens = args["lens"].cpu().tolist()
        cells = sum((lens[x] + 1) * (lens[y] + 1) for x, y in p.pairs())
        in_bytes = sum(t.numel() * 4 for k, t in args.items() if k != "lmax") + 128 * 128 * 4
        out_bytes = P * L1 * L1 * 4
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = cells * K1_OPS_PER_CELL / INT32_OPS_PER_S * 1e3
        # dependent-diagonal floor: n1+n2 barrier steps of the longest pair,
        # each at least one measured shared-memory barrier step of a block
        # as wide as the kernel's
        steps = max(lens[x] + lens[y] for x, y in p.pairs())
        lib = load("pair_wavefront")
        fn = lib.barrier_chain
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        probe = torch.empty(threads, dtype=torch.int32, device="cuda")

        def chain():
            if fn(steps, threads, probe.data_ptr(), torch.cuda.current_stream().cuda_stream):
                fail("barrier_chain probe failed to launch")

        chain_ms = time_ms(chain, reps=20)
        rows[label] = dict(P=P, Lmax=L1 - 1, threads=threads,
                           rows_per_thread=rows_per_thread, shared_bytes=shared,
                           ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                           chain_floor_ms=chain_ms, diagonals=steps,
                           ns_per_diagonal=ms * 1e6 / steps,
                           floor_ns_per_diagonal=chain_ms * 1e6 / steps,
                           out_bytes=out_bytes, max_abs_err=err)
        per = lambda t: f"{t * 1e6 / steps:.1f} ns/diag"
        print(f"K1 {label}: P={P} Lmax={L1 - 1} threads={threads} rows/thread="
              f"{rows_per_thread} shared={shared} B exact; kernel {ms:.4f} ms "
              f"({per(ms)}; device {dev_ms:.4f} ms), plain {plain_ms:.2f} ms "
              f"({per(plain_ms)}), bound "
              f"{max(bytes_ms, ops_ms):.5f} ms ({rows[label]['bound_by']}; "
              f"{per(max(bytes_ms, ops_ms))}), dependent-diagonal floor "
              f"{chain_ms:.4f} ms ({per(chain_ms)}, {steps} barrier steps of "
              f"{threads} threads); no library yardstick (no single PyTorch "
              f"call computes this DP)")
        if baseline is not None:
            # the first version, then in turns: first, current, current, first
            src, run = baseline
            first = lambda: run(args["enc"], args["xs"], args["ys"], args["lens"],
                                L1 - 1)
            old = first()
            torch.cuda.synchronize()
            if not torch.equal(old, got):
                fail(f"K1 {label}: the build of {src} differs from this one")
            current = lambda: wavefront_tables(**args)
            turns = [time_ms(f, reps=20)
                     for f in (first, current, current, first)]
            rows[label]["turns"] = dict(source=src, ms=turns)
            print(f"K1 {label} in turns with {src}: first {turns[0]:.4f} ms, "
                  f"current {turns[1]:.4f} ms, current {turns[2]:.4f} ms, "
                  f"first {turns[3]:.4f} ms")
    return rows


def build_baseline_k2(src: str, tmp: str):
    """Build the plane-per-launch version of the K2 source (``git show`` of
    csrc/triple_wavefront.cu at the commit that added it), to time beside
    the current kernel.  Its C entry takes (cubes, cxy, cxz, cyz, lens, ws,
    T, S, Dmax, threads, O, E, GG, stream)."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.core.cost import GAP_EXTENSION, GAP_GAP, GAP_OPEN

    lib_path = os.path.join(tmp, f"libk2_{abs(hash(src))}.so")
    subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib_path, src], check=True, capture_output=True)
    fn = ctypes.CDLL(lib_path).triple_wavefront
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(cxy, cxz, cyz, lens, ws):
        T, S = cxy.shape[0], cxy.shape[-1]
        cubes = torch.empty((T, S, S, S), dtype=torch.int32, device="cuda")
        if fn(cubes.data_ptr(), cxy.data_ptr(), cxz.data_ptr(), cyz.data_ptr(),
              lens.data_ptr(), ws.data_ptr(), T, S, int(lens.sum(1).max()), 256,
              GAP_OPEN, GAP_EXTENSION, GAP_GAP, torch.cuda.current_stream().cuda_stream):
            fail(f"K2 build of {src} failed to launch")
        return cubes

    return run


def build_variant_k2(tile, src: str, tmp: str):
    """Build an edited copy of the current K2 source, compiled for ``tile``
    (its C entry as the current one's), to time beside the current kernel
    at kinase."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.core.cost import GAP_EXTENSION, GAP_GAP, GAP_OPEN
    from mpi_pastar_msa_tpu_torch.heuristic.triples import k2_launch_shape

    lib_path = os.path.join(tmp, f"libk2v_{abs(hash(src))}.so")
    subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib_path, src], check=True, capture_output=True)
    fn = ctypes.CDLL(lib_path).triple_wavefront
    fn.argtypes = _kernels.SIGNATURES["triple_wavefront"]
    fn.restype = ctypes.c_int

    def run(cxy, cxz, cyz, lens, ws):
        T, S = cxy.shape[0], cxy.shape[-1]
        shape = k2_launch_shape(lens.cpu().numpy(), S, tile)
        cubes = torch.empty((T, S, S, S), dtype=torch.int32, device="cuda")
        if fn(cubes.data_ptr(), cxy.data_ptr(), cxz.data_ptr(), cyz.data_ptr(),
              lens.data_ptr(), ws.data_ptr(), T, S, *shape.tile, shape.diagonals,
              shape.grid.ctypes.data, GAP_OPEN, GAP_EXTENSION, GAP_GAP,
              torch.cuda.current_stream().cuda_stream):
            fail(f"K2 build of {src} failed to launch")
        return cubes

    return run


def check_k2(paths, baseline=None, variants=()) -> dict:
    """K2 against its plain version at kinase's own cover (4 cubes) and at a
    ragged shape (lengths 1, 40 and 300), whole stack and origins, with
    kernel, plain, bound and dependent-launch floor times; ``baseline`` is
    (source, run) of the plane-per-launch version's build, or None;
    ``variants`` are (tile, source, run) of edited builds of the current
    source, each checked and timed at kinase."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch._kernels import launches, load
    from mpi_pastar_msa_tpu_torch.core.problem import Problem, problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.triples import (
        k2_launch_shape, pick_cover, triple_inputs, triple_tables, triple_tables_plain)
    from mpi_pastar_msa_tpu_torch.heuristic.weights import altschul_rationale2

    kinase = problem_from_fasta(paths["kinase.fasta"])
    _, wi = altschul_rationale2(kinase.seqs)
    cover = pick_cover(wi, kinase.n_seq)
    rs = np.random.RandomState(0)
    ragged = Problem(tuple("".join(rs.choice(list("ACDEFGHIKLMNPQRSTVWY"), size=L))
                           for L in (1, 40, 300)))
    shapes = {"kinase": (kinase, [t for t, _ in cover], [w for _, w in cover]),
              "ragged": (ragged, [(0, 1, 2)], [(17, 23, 31)])}
    fn = load("triple_wavefront").plane_chain
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def chain_ms(launches_, blocks, threads):
        def chain():
            if fn(launches_, blocks, threads, torch.cuda.current_stream().cuda_stream):
                fail("plane_chain probe failed to launch")
        return time_ms(chain, reps=10)

    rows = {}
    for label, (p, tris, tws) in shapes.items():
        args = triple_inputs(p, tris, tws, "cuda")
        n0 = launches["triple_wavefront"]
        got, got_org = triple_tables(**args)
        torch.cuda.synchronize()
        if launches["triple_wavefront"] != n0 + 1:
            fail("triple_wavefront wrapper did not launch its kernel")
        want, want_org = triple_tables_plain(**args)
        err = max(int((got.long() - want.long()).abs().max()),
                  int((got_org.long() - want_org.long()).abs().max()))
        if err != 0:
            fail(f"K2 {label}: kernel differs from plain version (max |err| {err})")
        del want, want_org
        ms = time_ms(lambda: triple_tables(**args), reps=10)
        dev_ms = device_ms(lambda: triple_tables(**args), 10)
        plain_ms = time_ms(lambda: triple_tables_plain(**args), reps=3, warmup=1)
        T, S = args["cxy"].shape[0], args["cxy"].shape[-1]
        lens = args["lens"].cpu().long()
        shape = k2_launch_shape(lens.numpy(), S)
        planes = int(lens.sum(1).max()) + 1
        cells = int((lens + 1).prod(1).sum())
        in_bytes = sum(t.numel() * 4 for t in args.values())
        out_bytes = T * S ** 3 * 4
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = cells * K2_OPS_PER_CELL / INT32_OPS_PER_S * 1e3
        # dependent-launch floors: one empty launch per tile diagonal at the
        # largest launch's grid, and beside it one per plane at a thread
        # per (t, j, k), the plane-per-launch design's grid
        floor_ms = chain_ms(shape.diagonals, shape.max_blocks, shape.threads)
        plane_blocks = -(-T * S * S // 256)
        plane_floor_ms = chain_ms(planes, plane_blocks, 256)
        rows[label] = dict(T=T, S=S, lengths=lens.tolist(), ms=ms, device_ms=dev_ms,
                           plain_ms=plain_ms,
                           bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                           bytes_ms=bytes_ms, ops_ms=ops_ms, tile=shape.tile,
                           tiles=shape.tiles.tolist(), diagonals=shape.diagonals,
                           blocks=shape.blocks, max_blocks=shape.max_blocks,
                           threads=shape.threads,
                           chain_floor_ms=floor_ms, plane_floor_ms=plane_floor_ms,
                           planes=planes, device_launches_per_fill=shape.diagonals + 1,
                           in_box_cells=cells, out_bytes=out_bytes, max_abs_err=err)
        print(f"K2 {label}: T={T} S={S} lengths {lens.tolist()} exact (stack and "
              f"origins); tile {shape.tile}, {shape.diagonals} tile diagonals, "
              f"{shape.blocks} blocks of {shape.threads} threads ({shape.max_blocks} "
              f"in the largest launch); kernel {ms:.4f} ms "
              f"({ms * 1e3 / shape.diagonals:.2f} us/tile diagonal; device "
              f"{dev_ms:.4f} ms), plain "
              f"{plain_ms:.2f} ms, bound {max(bytes_ms, ops_ms):.5f} ms (bytes "
              f"{bytes_ms:.5f}, operations {ops_ms:.5f}), dependent-launch floor "
              f"{floor_ms:.4f} ms ({shape.diagonals} empty launches of "
              f"{shape.max_blocks} x {shape.threads}; one per plane: {planes} of "
              f"{plane_blocks} x 256, {plane_floor_ms:.4f} ms); "
              f"{shape.diagonals + 1} device launches per fill; no library "
              f"yardstick (no single PyTorch call computes this DP)")
        if label == "kinase":
            # each edited build, in turns: current, variant, variant, current
            for tile, src, run in variants:
                other = lambda: run(args["cxy"], args["cxz"], args["cyz"],
                                    args["lens"], args["ws"])
                alt = other()
                torch.cuda.synchronize()
                if not torch.equal(alt, got):
                    fail(f"K2 kinase: the build of {src} differs from this one")
                del alt
                current = lambda: triple_tables(**args)
                turns = [time_ms(f, reps=10) for f in (current, other, other, current)]
                alt_shape = k2_launch_shape(lens.numpy(), S, tile)
                rows[label].setdefault("variants", []).append(dict(
                    source=src, tile=tile, diagonals=alt_shape.diagonals, ms=turns))
                print(f"K2 kinase {src} (tile {tile}, {alt_shape.diagonals} tile "
                      f"diagonals) exact; in turns: current {turns[0]:.4f} ms, "
                      f"variant {turns[1]:.4f} ms, variant {turns[2]:.4f} ms, "
                      f"current {turns[3]:.4f} ms")
        if baseline is not None:
            # the plane-per-launch version, then in turns: first, current,
            # current, first
            src, run = baseline
            first = lambda: run(args["cxy"], args["cxz"], args["cyz"], args["lens"],
                                args["ws"])
            old = first()
            torch.cuda.synchronize()
            if not torch.equal(old, got):
                fail(f"K2 {label}: the build of {src} differs from this one")
            del old
            current = lambda: triple_tables(**args)
            turns = [time_ms(f, reps=10) for f in (first, current, current, first)]
            rows[label]["turns"] = dict(source=src, ms=turns)
            print(f"K2 {label} in turns with {src}: first {turns[0]:.4f} ms, "
                  f"current {turns[1]:.4f} ms, current {turns[2]:.4f} ms, "
                  f"first {turns[3]:.4f} ms")
        del got, got_org
    return rows


def clone_table(tab):
    """A copy of a table (every tensor of its dataclass)."""
    import dataclasses

    return type(tab)(*(getattr(tab, f.name).clone() for f in dataclasses.fields(tab)))


def time_restored(fn, restore, reps: int) -> float:
    """Median milliseconds of fn() alone (CUDA events), each run after
    restore() has reset the state fn changes (outside the events)."""
    times = []
    for k in range(reps + 1):
        restore()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        if k:  # the first run warms up
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def warm_engine(path: str, triples: str, warm_steps: int, layout: str = "auto", eng=None):
    """An engine on the card (``eng``, or a new one of ``layout``) run
    ``warm_steps`` steps into its search from a new table; returns (engine,
    table, counters)."""
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search import engine as E

    if eng is None:
        p = problem_from_fasta(path)
        eng = E.FrontierSearch(p, HPairHeuristic.build(p, "cuda"), device="cuda",
                               triples=triples, layout=layout)
    tab = eng._init_table()
    ctr = torch.as_tensor(E.fresh_counters(), device="cuda")
    ctr = E._run_chunk(eng.st, tab, ctr, warm_steps, eng.ub, eng.fill_target, eng.layout)
    return eng, tab, ctr


# The C entry of K5's grid-only version (a cooperative launch with no block
# path and no cap argument): t_sig, t_best, pending list, lane_cur,
# lane_dest, lane_word, bbits, max bucket probes, max calls, fill target,
# run, counters, state, blocks, stream
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
K5_GRID_ONLY_SIGNATURE = [_P] * 6 + [_I] * 4 + [_P] * 3 + [_I, _P]


def build_step_baseline(src: str, tmp: str):
    """Build the step kernels of another tree (``src``: a checkout's root or
    its csrc/ directory, whose K3 and K4 take this tree's C entries and K5
    K5_GRID_ONLY_SIGNATURE's) into their own directory, the three
    nvcc at once.  Returns their C entries (select_best, sig_expand,
    sig_probe)."""
    import shutil

    from mpi_pastar_msa_tpu_torch import _kernels

    csrc = src if os.path.isfile(os.path.join(src, "select_best.cu")) else os.path.join(
        src, "mpi_pastar_msa_tpu_torch", "csrc")
    out = os.path.join(tmp, "step_baseline")
    os.makedirs(out, exist_ok=True)
    for f in ("select_best.cu", "sig_expand.cu", "sig_probe.cu", "step_state.cuh"):
        shutil.copy(os.path.join(csrc, f), out)
    jobs = {}
    for name in STEP_KERNELS:
        lib = os.path.join(out, f"lib{name}.so")
        jobs[name] = (lib, subprocess.Popen(
            [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
             os.path.join(out, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    argtypes = {"select_best": _kernels.SIGNATURES["select_best"],
                "sig_expand": _kernels.SIGNATURES["sig_expand"],
                "sig_probe": K5_GRID_ONLY_SIGNATURE}
    fns = []
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"step baseline: nvcc failed for {name}.cu of {src}:\n{log}")
        fn = getattr(ctypes.CDLL(lib), name)
        fn.argtypes = argtypes[name]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return tuple(fns)


def start_phases_build(name: str, tmp: str, macro: str = None):
    """Start nvcc on csrc/<name>.cu with its measurement macro (K3_PHASES
    for select_best: three %globaltimer readings in the partials when a
    launch ends; K5_PHASES for sig_probe: five in lane_word; K10_PHASES for
    keyrow_insert: eight in the tail list; K8_NO_STORE
    for gotoh_wavefront: the fill without its scratch stores; K11_BARRIERS
    for route_pack: each destination's sort counts its block barriers; or
    ``macro``, as K11_PHASES for route_pack: its passes' %globaltimer
    readings) into ``tmp``; returns (name, proc, lib)."""
    from mpi_pastar_msa_tpu_torch import _kernels

    macro = macro or {"select_best": "K3_PHASES", "sig_probe": "K5_PHASES",
                      "keyrow_insert": "K10_PHASES", "gotoh_wavefront": "K8_NO_STORE",
                      "route_pack": "K11_BARRIERS"}[name]
    macros = macro.split("+")  # several macros: "A+B"
    lib = os.path.join(tmp, f"lib{name}_{'_'.join(macros)}.so")
    proc = subprocess.Popen(
        [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", *(f"-D{m}" for m in macros), "-o", lib,
         os.path.join(_kernels.CSRC, f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return name, proc, lib


def load_phases(job):
    """A measurement build's C entry (the same signature as the kernel's)."""
    from mpi_pastar_msa_tpu_torch import _kernels

    name, proc, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc failed for the measurement build of {name}.cu:\n{log}")
    fn = getattr(ctypes.CDLL(lib), name)
    fn.argtypes = _kernels.SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def load_k10_phases(job) -> dict:
    """The K10_PHASES build's two C entries (start_phases_build
    ("keyrow_insert")): {"keyrow_insert": fn, "keyrow_insert_recv": fn}."""
    from mpi_pastar_msa_tpu_torch import _kernels

    out = {"keyrow_insert": load_phases(job)}
    fn = ctypes.CDLL(job[2]).keyrow_insert_recv
    fn.argtypes, fn.restype = _kernels.SIGNATURES["keyrow_insert_recv"], ctypes.c_int
    out["keyrow_insert_recv"] = fn
    return out


# K10_PHASES: what ends at each %globaltimer reading after the first
K10_MARKS = ("wait_us", "round0_reads_us", "round0_writes_us", "round0_rereads_us",
             "to_block_path_us", "rounds_us", "finish_us")


def k10_phases(fns: dict, args: tuple, tail, restore, reps: int = 20) -> dict:
    """K10's phases on this card: the K10_PHASES build's ``args[0]`` entry
    (``args``: _keyrow_insert_args, the stream last) run ``reps`` times
    after ``restore()``; medians, in microseconds of block 0's thread 0's
    %globaltimer, of each span between two readings it passed (K10_MARKS:
    wait_predecessor, round 0's reads, writes and re-reads each up to its
    grid sync, on to the block path, the claim rounds, the placement and
    counters) and of the whole kernel from its start; the spans a path
    skips are absent."""
    fn = fns[args[0]]
    got = {}
    words = tail[:16].view(torch.int64)
    for _ in range(reps):
        restore()
        words.zero_()
        if fn(*args[1:]):
            fail("the K10_PHASES build failed to launch")
        torch.cuda.synchronize()
        marks = words.tolist()
        prev = marks[0]
        for name, t in zip(K10_MARKS, marks[1:]):
            if t:
                got.setdefault(name, []).append((t - prev) / 1e3)
                prev = t
        got.setdefault("total_us", []).append((marks[7] - marks[0]) / 1e3)
    return {k: statistics.median(v) for k, v in got.items()}


def k10_phase_line(ph: dict) -> str:
    return ", ".join(f"{k[:-3].replace('_', ' ')} {v:.3f}" for k, v in ph.items()) + " us"


def load_k11_barriers(job) -> dict:
    """The K11_BARRIERS build (start_phases_build("route_pack")) as K11Run's
    ``fns``: this tree's route_count, the build's route_pack, and
    ``barriers(ndev)``, each destination's block barriers in the last
    route_pack."""
    from mpi_pastar_msa_tpu_torch import _kernels

    pack = load_phases(job)
    read = ctypes.CDLL(job[2]).route_pack_barriers
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int

    def barriers(ndev: int) -> list:
        got = (ctypes.c_int * ndev)()
        if read(ctypes.cast(got, ctypes.c_void_p), ndev):
            fail("route_pack_barriers of the K11_BARRIERS build failed")
        return list(got)

    dll = ctypes.CDLL(job[2])
    fns = {"src": "the K11_BARRIERS build", "api": K11_API, "route_pack": pack,
           "barriers": barriers}
    for name in ("route_count", "route_count_rows", "route_pack_rows"):
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = _kernels.SIGNATURES[name], ctypes.c_int
        fns[name] = fn
    return fns


# route_pack.cu's K11_PHASES readings: kStamps of them, sorting block d's
# six from K11_STAMP_SORT + 6 d (d < 8), the ring tail's three from
# K11_STAMP_TAIL
K11_STAMPS, K11_STAMP_SORT, K11_STAMP_TAIL = 57, 6, 54


def load_k11_phases(job, label: str = "the K11_PHASES build") -> dict:
    """The K11_PHASES build (start_phases_build("route_pack", macro=
    "K11_PHASES"), or one with more macros) as K11Run's ``fns``: its four C
    entries (this tree's signatures) and ``phases()``, the readings of the
    calls since the last read (0 where no block wrote one), which it
    resets; ``label`` names it."""
    from mpi_pastar_msa_tpu_torch import _kernels

    name, proc, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc failed for the K11_PHASES build of route_pack.cu:\n{log}")
    dll = ctypes.CDLL(lib)
    fns = {"src": label, "api": K11_API}
    for n in ("route_count", "route_pack", "route_count_rows", "route_pack_rows"):
        fn = getattr(dll, n)
        fn.argtypes, fn.restype = _kernels.SIGNATURES[n], ctypes.c_int
        fns[n] = fn
    read = dll.route_pack_phases
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int

    def phases() -> list:
        got = (ctypes.c_ulonglong * K11_STAMPS)()
        if read(ctypes.cast(got, ctypes.c_void_p), K11_STAMPS):
            fail("route_pack_phases of the K11_PHASES build failed")
        return list(got)

    fns["phases"] = phases
    return fns


def k3_phases(fn, args, partial, restore, reps: int = 20) -> dict:
    """K3's two phases on this card: the K3_PHASES build run ``reps`` times
    on the restored table; medians of the read pass (block 0's start to the
    last block's start of the finish) and of the last block's finish, in
    microseconds of %globaltimer."""
    read, finish = [], []
    for _ in range(reps):
        restore()
        if fn(*args):
            fail("the K3_PHASES build failed to launch")
        torch.cuda.synchronize()
        t0, t1, t2 = partial.reshape(-1)[:3].tolist()
        read.append((t1 - t0) / 1e3)
        finish.append((t2 - t1) / 1e3)
    return dict(read_pass_us=statistics.median(read), finish_us=statistics.median(finish))


def k5_phases(fn, args, lane_word, restore, reps: int = 20) -> dict:
    """K5's phases on this card: the K5_PHASES build run ``reps`` times on
    the state K4 left (``restore``); medians, in microseconds of block 0's
    %globaltimer, of its read phases and of its write phases (each summed
    over the calls, up to the barrier that ends it), of the finish (the
    counters) and of the whole kernel from block 0's start."""
    got = {k: [] for k in ("read_us", "write_us", "finish_us", "total_us")}
    words = lane_word[:10].view(torch.int64)
    for _ in range(reps):
        restore()
        if fn(*args):
            fail("the K5_PHASES build failed to launch")
        torch.cuda.synchronize()
        t0, t_read, t_write, t_loop, t_end = words.tolist()
        got["read_us"].append(t_read / 1e3)
        got["write_us"].append(t_write / 1e3)
        got["finish_us"].append((t_end - t_loop) / 1e3)
        got["total_us"].append((t_end - t0) / 1e3)
    return {k: statistics.median(v) for k, v in got.items()}


def step_baseline_turns(src, fns, st, ub, fill, work, ctr, bufs, restores, news) -> dict:
    """Another tree's K3, K4 and K5 (``fns``, build_step_baseline) on the
    tables of this step, each from the state the step had before it
    (``restores``: the table, after K3, after K4): checked against this
    tree's kernels (``news``; K3: its outputs, t_closed, its state slots
    and compact list; K4: t_best, the goal, the surviving and pending
    counts and the pending set; K5: t_sig, t_best, the counters and its
    state slots), then timed in turns, old, new, new, old (CUDA events
    around each wrapper call, median of 20), and by device time (CUPTI).
    The other tree's kernels write the buffers these write."""
    from mpi_pastar_msa_tpu_torch.search import step as S

    stream = torch.cuda.current_stream().cuda_stream
    args3 = S._select_args(st, work.t_best, work.t_closed, ctr[0], ctr[7], bufs.run, bufs,
                           stream)[1:]
    args4 = S._expand_args(st, work, bufs, ctr, ub, stream)[1:]
    args5 = S._probe_args(st, work, bufs, ctr, fill, 0, S.K5_CAP, stream)[1:]
    args5 = args5[:10] + args5[11:-2] + args5[-1:]  # that entry takes no cap nor recv
    olds = []
    for k, (fn, args) in enumerate(zip(fns, (args3, args4, args5))):
        def old(fn=fn, args=args, k=k):
            if fn(*args):
                fail(f"step baseline: K{3 + k} of {src} failed to launch")
        olds.append(old)

    def outputs(k):
        st_ = bufs.state
        if k == 0:
            n = int(st_[S.STATE_NSEL])
            return [bufs.slots, bufs.vmin, bufs.active, work.t_closed,
                    st_[:S.STATE_NVALID], bufs.sel[:n]]
        if k == 1:
            n = int(st_[S.STATE_NPEND])
            return [work.t_best, ctr, st_[S.STATE_NVALID:S.STATE_NPEND + 1],
                    torch.tensor(sorted(map(tuple, bufs.pend[:n].tolist())))]
        calls = int(st_[S.STATE_CALLS])
        return [work.t_sig, work.t_best, ctr, st_[S.STATE_CALLS:S.STATE_CNT + calls]]

    out = dict(source=src)
    for k, (restore, new, old) in enumerate(zip(restores, news, olds)):
        restore()
        new()
        torch.cuda.synchronize()
        want = [t.clone() for t in outputs(k)]
        restore()
        old()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(want, outputs(k))):
            fail(f"step baseline: K{3 + k} of {src} differs from this one")
        name = f"k{3 + k}"
        out[f"{name}_turns_ms"] = [time_restored(f, restore, 20) for f in (old, new, new, old)]
        out[f"{name}_old_device_ms"] = device_ms(old, 20, restore)
        out[f"{name}_new_device_ms"] = device_ms(new, 20, restore)
    print(f"  baseline {src}: its K3, K4 and K5 give the same outputs; in turns (old, new, "
          f"new, old) " + "; ".join(
              f"K{k} {' / '.join(f'{t:.4f}' for t in out[f'k{k}_turns_ms'])} ms, device old "
              f"{out[f'k{k}_old_device_ms']:.4f} new {out[f'k{k}_new_device_ms']:.4f} ms"
              for k in (3, 4, 5)))
    return out


def wall_restored(fn, restore, reps: int) -> float:
    """Median host milliseconds of fn() and a synchronize (what a caller
    that then reads the result waits), each run after restore()."""
    times = []
    for k in range(reps + 1):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if k:  # the first run warms up
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def graph_vs_eager(st, tab0, ctr0, ub, fill, same, steps: int = 32) -> dict:
    """The chunk graph (K6) against the eager chunk from one mid-search
    table: 1 and 4 chunks of 16 steps, tables and counters identical; then
    a ``steps``-step chunk timed both ways (host wall with a synchronize,
    and the CUDA-event span; median of 10, each from the restored table)
    and the graph's capture (warm-up, capture and instantiation, host
    seconds)."""
    from mpi_pastar_msa_tpu_torch.search import step as S

    for chunks in (1, 4):
        g_tab, e_tab = clone_table(tab0), clone_table(tab0)
        g_ctr = e_ctr = ctr0
        for _ in range(chunks):
            g_ctr = S.run_chunk_sig_cuda(st, g_tab, g_ctr, 16, ub, fill)
            e_ctr = S.run_chunk_sig_cuda(st, e_tab, e_ctr, 16, ub, fill, graph=False)
        torch.cuda.synchronize()
        same(f"graph vs eager, {chunks} chunk(s) of 16", g_tab, g_ctr, e_tab, e_ctr, st.C)
        del g_tab, e_tab
    work = clone_table(tab0)

    def restore():
        for name in ("t_sig", "t_best", "t_closed"):
            getattr(work, name).copy_(getattr(tab0, name))

    n0, s0 = S.capture_stats(st)
    restore()
    # a capture of its own: the allocator may hand this copy the addresses
    # of a freed one, whose graph would serve it
    st._step_buffers.graph = None
    S.run_chunk_sig_cuda(st, work, ctr0, steps, ub, fill)  # captures
    torch.cuda.synchronize()
    n1, s1 = S.capture_stats(st)
    if n1 != n0 + 1:
        fail(f"graph vs eager: {n1 - n0} captures for one new table")
    graph = lambda: S.run_chunk_sig_cuda(st, work, ctr0, steps, ub, fill)
    eager = lambda: S.run_chunk_sig_cuda(st, work, ctr0, steps, ub, fill, graph=False)
    out = dict(steps=steps, capture_s=s1 - s0,
               graph_wall_ms=wall_restored(graph, restore, 10),
               eager_wall_ms=wall_restored(eager, restore, 10),
               graph_event_ms=time_restored(graph, restore, 10),
               eager_event_ms=time_restored(eager, restore, 10))
    if S.capture_stats(st)[0] != n1:
        fail("graph vs eager: a replay on the same table captured again")
    print(f"  chunk graph vs eager chunk: identical after 1 and 4 chunks of 16 steps; a "
          f"{steps}-step chunk takes {out['graph_wall_ms']:.4f} ms (graph) vs "
          f"{out['eager_wall_ms']:.4f} ms (eager) host wall, {out['graph_event_ms']:.4f} "
          f"vs {out['eager_event_ms']:.4f} ms between CUDA events; capture "
          f"{out['capture_s'] * 1e3:.2f} ms")
    return out


def loop_turns(label: str, st, tab0, ctr0, ub, fill, steps: int = 32, reps: int = 10) -> dict:
    """The chunk loop (K6: the set-up, then a graph of one step replayed
    ``steps`` times) in turns with the design it replaced, from one
    mid-search table: ``steps`` steps captured one after another in one
    graph ("old": S._capture of the eager chunk S._chunk, built here for
    measurement only, never on the engine's path; its expand and insert
    launched over the same programmatic edges).  Both chunks must equal
    each other, tables and counters.  The span of a chunk between CUDA
    events (the launches alone) in turns old, new, new, old, median of
    ``reps`` each, and the host wall of a chunk (the wrapper call, or the
    copy-in, replay and copy-out, with a synchronize); the steps' kernels'
    device time (CUPTI, over the eager chunk) and each design's gap a step
    beside it; the new capture's host seconds by part against the old
    graph's capture and instantiation."""
    import dataclasses

    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    sig = isinstance(tab0, E.SigTable)
    run = S.run_chunk_sig_cuda if sig else S.run_chunk_keyrow_cuda
    cap = S.K5_CAP if sig else S.K10_CAP
    dev = ctr0.device
    stream = S._stream(dev)
    work = clone_table(tab0)
    names = [f.name for f in dataclasses.fields(work)]

    def restore():
        for name in names:
            getattr(work, name).copy_(getattr(tab0, name))

    restore()
    # a capture of its own: the allocator may hand this copy the addresses
    # of a freed one, whose graph would serve it
    st._step_buffers.graph = None
    n0 = S.capture_stats(st)[0]
    parts0 = S.capture_parts(st)
    new_ctr = run(st, work, ctr0, steps, ub, fill)  # the capture, then one chunk
    torch.cuda.synchronize()
    if S.capture_stats(st)[0] != n0 + 1:
        fail(f"{label} loop turns: no capture for a new table")
    parts = {k: v - parts0[k] for k, v in S.capture_parts(st).items()}
    new_tab = clone_table(work)
    bufs = st._step_buffers
    g_new = bufs.graph
    if sorted(g_new.tally.values()) != [1, 1, 1]:
        fail(f"{label} loop turns: the step graph holds {g_new.tally}, want one step")

    restore()
    t0 = time.perf_counter()
    with _kernels.capturing({}):
        g_old = S._capture(lambda: S._chunk(st, work, bufs, steps, ub, fill, 0, cap,
                                            S._stream(dev)))
    old_capture_s = time.perf_counter() - t0

    def new():
        S._setup(bufs, stream)
        for _ in range(steps):
            g_new.graph.replay()

    launch = {"old": g_old.replay, "new": new}

    def restore_ctr():
        restore()
        bufs.counters.copy_(ctr0)

    restore_ctr()
    g_old.replay()
    torch.cuda.synchronize()
    if not torch.equal(bufs.counters, new_ctr) or any(
            not torch.equal(getattr(work, k)[:st.C], getattr(new_tab, k)[:st.C])
            for k in names):
        fail(f"{label} loop turns: the old graph and the step graph's replays differ: "
             f"{new_ctr.tolist()} vs {bufs.counters.tolist()}")
    del new_tab

    def old_wall():
        bufs.counters.copy_(ctr0)
        g_old.replay()
        return bufs.counters.clone()

    event = {w: [] for w in launch}
    for w in ("old", "new", "new", "old"):
        event[w].append(time_restored(launch[w], restore_ctr, reps))
    wall = {"old": [], "new": []}
    for w, fn in (("old", old_wall), ("new", lambda: run(st, work, ctr0, steps, ub, fill)),
                  ("new", lambda: run(st, work, ctr0, steps, ub, fill)), ("old", old_wall)):
        wall[w].append(wall_restored(fn, restore, reps))
    kernels_ms = device_ms(lambda: S._chunk(st, work, bufs, steps, ub, fill, 0, cap, stream),
                           5, restore_ctr)
    ran = int(new_ctr[2]) - int(ctr0[2])
    out = dict(steps=steps, from_step=int(ctr0[2]), ran=ran, kernels_device_ms=kernels_ms,
               capture_ms=sum(parts.values()) * 1e3,
               capture_parts_ms={k: v * 1e3 for k, v in parts.items()},
               old_capture_ms=old_capture_s * 1e3)
    for w in launch:
        out[f"{w}_event_ms"] = statistics.median(event[w])
        out[f"{w}_event_turns"] = event[w]
        out[f"{w}_gap_us_a_step"] = (out[f"{w}_event_ms"] - kernels_ms) / ran * 1e3
    for w in wall:
        out[f"{w}_wall_ms"] = statistics.median(wall[w])
        out[f"{w}_wall_turns"] = wall[w]
    print(f"  loop turns, {label} from step {out['from_step']} ({ran} steps; old, new, new, "
          f"old, median of {reps}) between CUDA events: the one-step graph replayed "
          f"{out['new_event_ms']:.4f} ms (gap {out['new_gap_us_a_step']:.2f} us a step), the "
          f"{steps}-step graph {out['old_event_ms']:.4f} ms (gap "
          f"{out['old_gap_us_a_step']:.2f}), the steps' kernels {kernels_ms:.4f} ms (CUPTI, "
          f"eager); host wall new {out['new_wall_ms']:.4f} / old {out['old_wall_ms']:.4f} ms; "
          f"capture {out['capture_ms']:.3f} ms (warm-up {parts['warm_s'] * 1e3:.3f}, host "
          f"{parts['host_s'] * 1e3:.3f}, instantiation {parts['instantiate_s'] * 1e3:.3f}) "
          f"against {out['old_capture_ms']:.3f} ms for the {steps}-step graph's capture and "
          f"instantiation")
    del g_old, work
    return out


def chunk_setup_check() -> dict:
    """chunk_setup (csrc/chunk_setup.cu, a chunk's set-up) against
    chunk_setup_plain on the same counters and run flag: searching, goal 0,
    an overflow; its wrapper call (CUDA events), device (CUPTI) and plain
    times, and its bound: 28 bytes (two counters read, f-min and the flag
    written)."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    err = 0
    stream = torch.cuda.current_stream().cuda_stream
    for goal, ovf in ((421546, 0), (0, 0), (421546, 3)):
        ctr = torch.as_tensor(E.fresh_counters(), device="cuda")
        ctr[0], ctr[1], ctr[6] = goal, 77, ovf
        bufs = [ctr.clone(), torch.full((1,), 5, dtype=torch.int32, device="cuda")]
        want = [t.clone() for t in bufs]
        _kernels.launch("chunk_setup", bufs[0].data_ptr(), bufs[1].data_ptr(), stream)
        S.chunk_setup_plain(*want)
        torch.cuda.synchronize()
        err = max([err] + [int((a.long() - b.long()).abs().max()) for a, b in zip(bufs, want)])
    if err:
        fail(f"chunk_setup differs from chunk_setup_plain (max |err| {err})")
    go = _kernels.bind("chunk_setup", bufs[0].data_ptr(), bufs[1].data_ptr(), stream)
    out = dict(max_abs_err=err, ms=time_ms(go, reps=20), device_ms=device_ms(go, 20),
               plain_ms=time_ms(lambda: S.chunk_setup_plain(*want), reps=20),
               bound_ms=28 / HBM_BYTES_PER_S * 1e3)
    print(f"chunk_setup: equal to chunk_setup_plain (searching, goal 0, overflow); "
          f"{out['ms']:.4f} ms wrapper / {out['device_ms']:.4f} ms device, plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.2e} ms (bytes)")
    return out


def capture_check(paths) -> dict:
    """The chunk graph's capture on its own, before the rest: PF08184's sig
    table, 8 steps in, then 8 steps as a chunk graph and as the eager chunk
    from copies of it, with K5 at its cap (one block) and at cap 0 (its
    grid path: a cooperative launch with grid syncs, captured); tables and
    counters identical, one capture each."""
    from mpi_pastar_msa_tpu_torch.search import step as S

    eng, tab0, ctr0 = warm_engine(paths["PF08184.fasta"], "auto", 8)
    st = eng.st
    if eng.layout != "sig":
        fail(f"capture check: PF08184 took layout {eng.layout}")
    out = {}
    for cap in (S.K5_CAP, 0):
        g_tab, e_tab = clone_table(tab0), clone_table(tab0)
        n0 = S.capture_stats(st)[0]
        g_ctr = S.run_chunk_sig_cuda(st, g_tab, ctr0, 8, eng.ub, eng.fill_target, cap=cap)
        e_ctr = S.run_chunk_sig_cuda(st, e_tab, ctr0, 8, eng.ub, eng.fill_target, cap=cap,
                                     graph=False)
        torch.cuda.synchronize()
        if S.capture_stats(st)[0] != n0 + 1:
            fail(f"capture check: no capture at K5 cap {cap}")
        for name in ("t_sig", "t_best", "t_closed"):
            if not torch.equal(getattr(g_tab, name)[:st.C], getattr(e_tab, name)[:st.C]):
                fail(f"capture check: graph and eager chunks differ in {name} (cap {cap})")
        if not torch.equal(g_ctr, e_ctr) or int(g_ctr[2]) <= int(ctr0[2]):
            fail(f"capture check: counters {g_ctr.tolist()} vs {e_ctr.tolist()}")
        out[cap] = dict(steps=int(g_ctr[2]) - int(ctr0[2]))
    print(f"capture: a chunk of 8 steps (K3, K4 and K5, whose launch is cooperative: "
          f"cudaLaunchKernelEx with cudaLaunchAttributeCooperative) captured in a CUDA "
          f"graph and replayed on PF08184 equals the eager chunk, with K5 at cap "
          f"{S.K5_CAP} (one block) and at cap 0 (its grid path, grid syncs)")
    return out


def step_kernels(paths, baseline=None, floor=None, phases=None, keyrow_baseline=None,
                 k10_sweep: bool = False) -> dict:
    """The step kernels K3 -> K4 -> K5 against the plain step on the card:
    kinase under --triples auto (from step 150) and off (from step 400),
    1 and 32 steps from one table, through run_chunk_sig_cuda (a chunk
    graph) and through _run_chunk_plain(plain_select=True); t_sig, t_best,
    t_closed (the first C slots) and the 14 counters must be identical.
    The 1-step case also runs K5 on one block and on 132, and each case
    with K5's cap and with cap 0 (its grid path whatever the pending
    count), which must not change anything.  The chunk graph against the
    eager chunk (graph=False): 1 and 4 chunks of 16 steps, identical; a
    32-step chunk timed both ways, and the graph's capture.  Then K3 alone
    against _select_best_plain on globin6's packed table (step 60).  Times
    at kinase: K3, K4, K5 (at its cap and on its grid path) and the whole
    step, kernel (CUDA events around the wrapper call, and the device time
    from CUPTI) and plain, with their bounds by bytes, and K3's library
    yardstick with its own bound.  ``baseline`` is (source, (select,
    expand, probe)) of another tree's K3, K4 and K5 (build_step_baseline):
    checked against these on the same tables and timed in turns with them;
    ``floor`` the empty-kernel launch floor, printed beside the kernels;
    ``phases`` the C entries of the measurement builds (load_phases) of K3
    (its read pass and its last block's finish) and of K5 (its read and
    write phases and its finish) and K10 (load_k10_phases);
    ``keyrow_baseline`` another tree's K10 (load_keyrow_baseline), timed
    in turns with this one in keyrow_step.
    Then the grid sync's cost and K10's tail a step over the globin6 and
    kinase-unpacked searches (k10_tail_sweep; ``k10_sweep`` also times
    K10 on both its paths at every step)."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    def same(label, a_tab, a_ctr, b_tab, b_ctr, C):
        err = 0
        for name in ("t_sig", "t_best", "t_closed"):
            x, y = getattr(a_tab, name)[:C].long(), getattr(b_tab, name)[:C].long()
            err = max(err, int((x - y).abs().max()))
        err = max(err, int((a_ctr - b_ctr).abs().max()))
        if err != 0:
            fail(f"step kernels {label}: kernels differ from the plain step (max |err| "
                 f"{err}); counters {a_ctr.tolist()} vs {b_ctr.tolist()}")
        return err

    out = {}
    for triples, warm in (("auto", 150), ("off", 400)):
        eng, tab0, ctr0 = warm_engine(paths["kinase.fasta"], triples, warm)
        st, ub, fill = eng.st, eng.ub, eng.fill_target
        C = st.C
        row = dict(layout=eng.layout, batch=st.B, fill_target=fill, warm_steps=warm,
                   checks=[])
        if eng.layout != "sig":
            fail(f"step kernels: kinase {triples} took layout {eng.layout}")
        for n, blocks, cap in ((1, 0, S.K5_CAP), (1, 1, S.K5_CAP), (1, 132, S.K5_CAP),
                               (1, 0, 0), (1, 1, 0), (32, 0, S.K5_CAP), (32, 0, 0)):
            ktab = clone_table(tab0)
            kctr = S.run_chunk_sig_cuda(st, ktab, ctr0, n, ub, fill, blocks=blocks, cap=cap)
            ptab = clone_table(tab0)
            pctr = E._run_chunk_plain(st, ptab, ctr0, n, ub, fill, "sig", plain_select=True)
            torch.cuda.synchronize()
            err = same(f"kinase {triples} {n} step(s), K5 blocks {blocks} cap {cap}", ktab,
                       kctr, ptab, pctr, C)
            row["checks"].append(dict(steps=n, k5_blocks=blocks, k5_cap=cap, max_abs_err=err,
                                      counters=kctr.tolist()))
            del ktab, ptab
        print(f"step kernels kinase --triples {triples} (sig, B={st.B}, from step "
              f"{int(ctr0[2])}): t_sig, t_best, t_closed and the 14 counters identical "
              f"to the plain step after 1 step (K5 grid auto, 1 and 132 blocks; cap "
              f"{S.K5_CAP} and 0) and after 32 steps (cap {S.K5_CAP} and 0)")
        row["graph"] = graph_vs_eager(st, tab0, ctr0, ub, fill, same)
        row["loop"] = loop_turns(f"kinase {triples}", st, tab0, ctr0, ub, fill)
        # one step's pieces, timed from the same table (each run restores
        # what the piece changes)
        bufs = S._step_buffers(st, torch.device("cuda"))
        work = clone_table(tab0)
        ctr = ctr0.clone()
        ctr[1] = 0
        bufs.run.fill_(1)
        stream = torch.cuda.current_stream().cuda_stream
        snap = clone_table(tab0)
        goal, thr = ctr[0], ctr[7]

        def restore_tab():
            for name in ("t_sig", "t_best", "t_closed"):
                getattr(work, name).copy_(getattr(snap, name))
            ctr.copy_(ctr0)
            ctr[1] = 0
            bufs.run.fill_(1)

        # each kernel as the step loop launches it: its arguments bound once
        k3 = _kernels.bind(*S._select_args(st, work.t_best, work.t_closed, goal, thr,
                                           bufs.run, bufs, stream))
        k3_ms = time_restored(k3, restore_tab, 20)
        best0, closed0 = snap.t_best[:C], snap.t_closed[:C]
        k3_plain_ms = time_restored(
            lambda: E._select_best_plain(st, work.t_best, work.t_closed, goal, thr),
            restore_tab, 5)
        is_open = (best0 < closed0) & ((best0 >> st.nb) < goal - st.f0)
        v_open = torch.where(is_open, best0, E.INFP).view(st.B, C // st.B)
        k3_lib_ms = time_ms(lambda: torch.min(v_open, dim=1), reps=20)
        k3_lib_dev = device_ms(  # PyTorch's own kernels are the call under test here
            lambda: torch.min(v_open, dim=1), 20,
            keep=lambda k: (not k.startswith(("aten::", "cuda", "Memcpy"))
                            and "spin_kernel" not in k))
        # after K3: its state, then K4
        restore_tab()
        k3()
        after3 = bufs.state.clone()

        def restore3():
            restore_tab()
            bufs.state.copy_(after3)

        k4 = _kernels.bind(*S._expand_args(st, work, bufs, ctr, ub, stream))
        k4_ms = time_restored(k4, restore3, 20)
        restore3()
        k4()
        after4, best4, goal4 = bufs.state.clone(), work.t_best.clone(), ctr.clone()
        pend = bufs.pend.clone()

        def restore4():
            restore3()
            work.t_best.copy_(best4)
            ctr.copy_(goal4)
            bufs.state.copy_(after4)
            bufs.pend.copy_(pend)

        k5 = _kernels.bind(*S._probe_args(st, work, bufs, ctr, fill, 0, S.K5_CAP, stream))
        k5_grid = _kernels.bind(*S._probe_args(st, work, bufs, ctr, fill, 0, 0, stream))
        k5_ms = time_restored(k5, restore4, 20)
        k5_grid_ms = time_restored(k5_grid, restore4, 20)
        restore4()
        k5()
        torch.cuda.synchronize()
        s5 = bufs.state.tolist()
        n_sel, n_valid, n_pend, calls = (s5[S.STATE_NSEL], s5[S.STATE_NVALID],
                                         s5[S.STATE_NPEND], s5[S.STATE_CALLS])
        new_ways = int(((work.t_sig[:C] != -1).sum() - (snap.t_sig[:C] != -1).sum()))
        step_ms = time_restored(lambda: (k3(), k4(), k5()), restore_tab, 20)
        # the device's own time of each (CUPTI), the same calls
        if phases is not None:
            k3_build, k5_build, _ = phases
            row["k3_phases"] = k3_phases(k3_build, S._select_args(
                st, work.t_best, work.t_closed, goal, thr, bufs.run, bufs, stream)[1:],
                bufs.partial, restore_tab)
            # K5 at its cap (the block path when n <= cap) and on its grid path
            row["k5_phases"] = {cap: k5_phases(k5_build, S._probe_args(
                st, work, bufs, ctr, fill, 0, cap, stream)[1:], bufs.lane_word, restore4)
                for cap in (S.K5_CAP, 0)}
        k3_dev = device_ms(k3, 20, restore_tab)
        k4_dev = device_ms(k4, 20, restore3)
        k5_dev = device_ms(k5, 20, restore4)
        k5_grid_dev = device_ms(k5_grid, 20, restore4)
        step_dev = device_ms(lambda: (k3(), k4(), k5()), 20, restore_tab)
        if baseline is not None:
            row["baseline"] = step_baseline_turns(
                *baseline, st, ub, fill, work, ctr, bufs, (restore_tab, restore3, restore4),
                (k3, k4, k5))

        # the plain pieces on the same table: _expand -> prune ->
        # _candidates_sig for K4 (after the plain select, not timed),
        # _insert_sig (its round 0 included) for K5
        restore_tab()
        coords, f, par, _, active, _, _, _, _ = E._select_sig(
            st, work, goal, thr, E._select_best_plain)
        closed_sel = work.t_closed.clone()

        def plain_k4():
            sel = torch.nonzero(active)[:, 0]
            g_c, f_c, m_c, valid, is_goal, child = E._expand(
                st, coords[sel], f[sel], par[sel], torch.ones_like(sel, dtype=torch.bool),
                g_is_f=True)
            keep = torch.nonzero(valid & (f_c <= ub))[:, 0]
            return E._candidates_sig(st, child[keep], g_c[keep], f_c[keep], m_c[keep])

        k4_plain_ms = time_ms(plain_k4, reps=5)
        cand = plain_k4()

        def restore_sel():
            restore_tab()
            work.t_closed.copy_(closed_sel)

        k5_plain_ms = time_restored(lambda: E._insert_sig(st, work, *cand), restore_sel, 5)
        step_plain_ms = time_restored(
            lambda: E._run_chunk_plain(st, work, ctr0, 1, ub, fill, "sig",
                                       plain_select=True), restore_tab, 5)
        P, T = st.P, st.T3
        # K3: both tables read, slots/vmin/active written, the active slots
        # closed and listed; K4: a list entry, a sig word, P T8 rows and 8T
        # corners a row, a bucket row a surviving lane, then a t_best word
        # or a pending entry
        bytes3 = C * 8 + st.B * 17 + n_sel * (4 + 8)
        bytes4 = (n_sel * (8 + 4 + 32 * P + 32 * T) + n_valid * 32
                  + (n_valid - n_pend) * 4 + n_pend * 12)
        # the yardstick reads one int32 (B, G) array and writes B values and
        # B int64 indices
        lib_bytes = C * 4 + st.B * (4 + 8)
        # rows read: the lanes unsettled at the start of each call; writes:
        # one word a new key, one t_best word a lane settled by the probe
        live = n_pend + sum(s5[S.STATE_CNT + k] for k in range(max(calls - 1, 0)))
        settled = n_pend - (s5[S.STATE_CNT + calls - 1] if calls else 0)
        bytes5 = n_pend * 12 + live * 32 + new_ways * 4 + settled * 4
        ms = lambda b: b / HBM_BYTES_PER_S * 1e3
        row.update(
            selected=n_sel, lanes=n_valid, pending=n_pend, probe_calls=calls,
            new_ways=new_ways,
            k3=dict(ms=k3_ms, device_ms=k3_dev, plain_ms=k3_plain_ms, library_ms=k3_lib_ms,
                    library_device_ms=k3_lib_dev, library_bytes=lib_bytes,
                    library_bound_ms=ms(lib_bytes),
                    bound_ms=ms(bytes3), bytes=bytes3),
            k4=dict(ms=k4_ms, device_ms=k4_dev, plain_ms=k4_plain_ms, bound_ms=ms(bytes4),
                    bytes=bytes4),
            k5=dict(ms=k5_ms, device_ms=k5_dev, path="block" if n_pend <= S.K5_CAP else "grid",
                    grid_ms=k5_grid_ms, grid_device_ms=k5_grid_dev, plain_ms=k5_plain_ms,
                    bound_ms=ms(bytes5), bytes=bytes5),
            step=dict(ms=step_ms, device_ms=step_dev, plain_ms=step_plain_ms,
                      bound_ms=ms(bytes3 + bytes4 + bytes5)))
        print(f"  step {int(ctr0[2])}: {n_sel} rows, {n_valid} lanes, {n_pend} pending, "
              f"{calls} probe calls, {new_ways} new keys; wrapper call (CUDA events) / "
              f"device (CUPTI): K3 {k3_ms:.4f} / {k3_dev:.4f} ms (plain "
              f"{k3_plain_ms:.4f}, bound {ms(bytes3):.5f}; torch.min over (B, G) "
              f"alone {k3_lib_ms:.4f} / {k3_lib_dev:.4f} ms, {lib_bytes / 1e6:.1f} MB, "
              f"its bound {ms(lib_bytes):.5f} ms = {100 * ms(lib_bytes) / k3_lib_dev:.1f}% "
              f"of its device time); K4 "
              f"{k4_ms:.4f} / {k4_dev:.4f} ms (plain _expand -> prune -> _candidates_sig "
              f"{k4_plain_ms:.4f}, bound {ms(bytes4):.5f}); K5 {k5_ms:.4f} / "
              f"{k5_dev:.4f} ms ({row['k5']['path']} path at cap {S.K5_CAP}; grid path "
              f"{k5_grid_ms:.4f} / {k5_grid_dev:.4f} ms; plain _insert_sig "
              f"{k5_plain_ms:.4f}, bound "
              f"{ms(bytes5):.5f}); step {step_ms:.4f} / {step_dev:.4f} ms (plain "
              f"{step_plain_ms:.4f}, bound {ms(bytes3 + bytes4 + bytes5):.5f}); all "
              f"bounds by bytes")
        if floor is not None:
            print(f"  empty-kernel launch floor: {floor['ms']:.4f} ms (CUDA events around "
                  f"one ctypes call), device {floor['device_ms']:.4f} ms")
        if "k3_phases" in row:
            ph = row["k3_phases"]
            print(f"  K3 phases (K3_PHASES build, %globaltimer, median of 20): read pass "
                  f"{ph['read_pass_us']:.3f} us ({C * 8 / ph['read_pass_us'] / 1e6:.3f} TB/s), "
                  f"last block's finish {ph['finish_us']:.3f} us")
        for cap, ph in row.get("k5_phases", {}).items():
            print(f"  K5 phases at cap {cap} (K5_PHASES build, block 0's %globaltimer, "
                  f"median of 20): read phases {ph['read_us']:.3f} us, write phases "
                  f"{ph['write_us']:.3f} us, finish {ph['finish_us']:.3f} us, start to end "
                  f"{ph['total_us']:.3f} us")
        out[triples] = row
        del tab0, work, snap, eng

    k10_ph = phases[2] if phases is not None else None
    # K3 alone on the packed layout: globin6 at step 60
    eng, tab, ctr = warm_engine(data_path("globin6"), "auto", 60)
    if eng.layout != "packed":
        fail(f"step kernels: globin6 took layout {eng.layout}, want packed")
    st = eng.st
    a, b = clone_table(tab), clone_table(tab)
    got = S.select_best_cuda(st, a.t_best, a.t_closed, ctr[0], ctr[7])
    want = E._select_best_plain(st, b.t_best, b.t_closed, ctr[0], ctr[7])
    torch.cuda.synchronize()
    err = max(int((x.long() - y.long()).abs().max()) for x, y in zip(got, want))
    err = max(err, int((a.t_closed[:st.C] - b.t_closed[:st.C]).abs().max()))
    if err != 0:
        fail(f"K3 globin6 (packed): kernel differs from _select_best_plain (max |err| {err})")
    print(f"K3 globin6 (packed, step {int(ctr[2])}, {int(want[5])} rows selected): "
          f"outputs and t_closed identical to the plain select")
    out["globin6_k3"] = dict(selected=int(want[5]), max_abs_err=err)
    del a, b
    # the packed and unpacked step (K3, K9, K10): globin6 (packed) from the
    # same table, kinase pinned to unpacked from step 150
    out["grid_sync"] = grid_sync_cost()
    out["globin6_keyrow"] = g6 = keyrow_step("globin6", eng, tab, ctr,
                                             baseline=keyrow_baseline, k10_phase_fns=k10_ph)
    out["globin6_loop"] = loop_turns("globin6", st, tab, ctr, eng.ub, eng.fill_target)
    if not 0 < g6["k9"]["pending"] < g6["k9"]["lanes"]:
        fail(f"globin6 step {int(ctr[2])}: K9 left {g6['k9']['pending']} of "
             f"{g6['k9']['lanes']} lanes pending: it settles no home-row match")
    del tab, ctr
    out["globin6_tail"] = k10_tail_sweep("globin6", eng, k10_sweep)
    del eng
    eng, tab, ctr = warm_engine(paths["kinase.fasta"], "auto", 150, layout="unpacked")
    out["kinase_unpacked_keyrow"] = keyrow_step("kinase unpacked", eng, tab, ctr,
                                                baseline=keyrow_baseline, k10_phase_fns=k10_ph)
    out["kinase_unpacked_loop"] = loop_turns("kinase unpacked", eng.st, tab, ctr, eng.ub,
                                             eng.fill_target)
    del tab, ctr
    out["kinase_unpacked_tail"] = k10_tail_sweep("kinase unpacked", eng, k10_sweep)
    return out


@contextlib.contextmanager
def plain_step_guard():
    """Count the calls of the plain step functions (PLAIN_STEP) made
    inside: a run on the card must make none."""
    from mpi_pastar_msa_tpu_torch.search import engine as E

    calls = dict.fromkeys(PLAIN_STEP, 0)
    saved = {name: getattr(E, name) for name in PLAIN_STEP}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    for name, fn in saved.items():
        setattr(E, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(E, name, fn)


def check_path_kernels(label: str, eng, res, counts: dict, plain: dict) -> None:
    """The step kernels of the engine's layout and the chunk's set-up ran
    on this path, K7 walked it once, and no plain step function nor the
    plain walk ran; without a regrow, one step graph a run, replayed
    chunk_steps times a chunk: each step kernel once as the capture's
    warm-up and once a replay, the set-up once a chunk."""
    kernels = LAYOUT_KERNELS[eng.layout]
    for k in kernels + ["chunk_setup"]:
        if counts[k] <= 0:
            fail(f"{label}: kernel {k} was not launched on the main path")
    if counts["path_walk"] != 1:
        fail(f"{label}: K7 (path_walk) launched {counts['path_walk']} times, want 1")
    if any(plain.values()):
        fail(f"{label}: plain step functions or the plain walk ran on the card: {plain}")
    if not eng.regrown:
        chunks = -(-res.steps // eng.chunk_steps)
        want = 1 + eng.chunk_steps * chunks
        if (eng.graph_captures != 1 or any(counts[k] != want for k in kernels)
                or counts["chunk_setup"] != chunks):
            fail(f"{label}: {eng.graph_captures} step graph captures and launches "
                 f"{counts} for {res.steps} steps in {chunks} chunks (want {want} of each "
                 f"step kernel, {chunks} of chunk_setup)")


def loop_walls(eng) -> str:
    """The single-table search's named walls (ms): the statics' build, the
    chunk loop, the chunk graph's capture by part, _finish (the walk in
    it)."""
    w = eng.last_phase_walls
    return (f"statics {w['statics'] * 1e3:.2f}, chunk loop {w['chunk_loop'] * 1e3:.2f} (capture "
            f"{w['graph_capture'] * 1e3:.3f}: warm-up {w['capture_warm_s'] * 1e3:.3f}, host "
            f"{w['capture_host_s'] * 1e3:.3f}, instantiation {w['capture_instantiate_s'] * 1e3:.3f}"
            f"), _finish {w['finish'] * 1e3:.2f} (walk {w['walk'] * 1e3:.2f}) ms")


def start_keyrow_baseline(src: str, tmp: str):
    """Start nvcc on another tree's K10 and K7 (``src``: a checkout's root
    or its csrc/ directory; keyrow_insert.cu and path_walk.cu with this
    tree's C entries, and the headers beside them) in their own directory,
    both at once; returns (src, {name: (proc, lib)})."""
    import glob
    import shutil

    from mpi_pastar_msa_tpu_torch import _kernels

    csrc = src if os.path.isfile(os.path.join(src, "keyrow_insert.cu")) else os.path.join(
        src, "mpi_pastar_msa_tpu_torch", "csrc")
    out = os.path.join(tmp, "keyrow_baseline")
    os.makedirs(out, exist_ok=True)
    names = ("keyrow_insert", "path_walk")
    for f in [os.path.join(csrc, f"{n}.cu") for n in names] + glob.glob(
            os.path.join(csrc, "*.cuh")):
        shutil.copy(f, out)
    jobs = {}
    for name in names:
        lib = os.path.join(out, f"lib{name}.so")
        jobs[name] = (subprocess.Popen(
            [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", lib, os.path.join(out, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return src, jobs


def load_keyrow_baseline(job) -> dict:
    """The other tree's K10 and K7 C entries (start_keyrow_baseline):
    {"source": src, "keyrow_insert": fn, "keyrow_insert_recv": fn (where
    the tree has the sharded entry), "path_walk": fn}."""
    from mpi_pastar_msa_tpu_torch import _kernels

    src, jobs = job
    out = dict(source=src)
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"keyrow baseline: nvcc failed for {name}.cu of {src}:\n{log}")
        for entry in (name, "keyrow_insert_recv") if name == "keyrow_insert" else (name,):
            fn = getattr(ctypes.CDLL(lib), entry, None)
            if fn is not None:
                fn.argtypes, fn.restype = _kernels.SIGNATURES[entry], ctypes.c_int
                out[entry] = fn
    return out


def k10_turns(label: str, base: dict, args: tuple, restore, outputs) -> dict:
    """Another tree's K10 (``base``: load_keyrow_baseline) against this
    one on the same inputs: ``args`` the launch (_keyrow_insert_args, the
    entry first), each run after ``restore()``; ``outputs()`` what the
    two must leave alike (table words, counters, state).  Checked, then
    the device times (CUPTI) in turns, old, new, new, old."""
    from mpi_pastar_msa_tpu_torch import _kernels

    old_fn, src = base[args[0]], base["source"]

    def old():
        if old_fn(*args[1:]):
            fail(f"K10 of {src} failed to launch")

    new = _kernels.bind(*args)
    restore()
    new()
    torch.cuda.synchronize()
    want = outputs()
    restore()
    old()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(want, outputs())):
        fail(f"{label}: the K10 of {src} differs from this one")
    turns = [device_ms(f, 20, restore) for f in (old, new, new, old)]
    print(f"  {label}: K10 of {src} in turns (old, new, new, old), device "
          + " / ".join(f"{t:.4f}" for t in turns) + " ms; the same table words, counters and "
          "state")
    return dict(source=src, turns_device_ms=turns)


def grid_sync_cost() -> dict:
    """One grid sync of K10's cooperative grid (132 blocks of 512 threads):
    an otherwise empty cooperative kernel (grid_sync_chain,
    csrc/keyrow_insert.cu) with k = 0, 1, 4 and 16 syncs, its device time
    (CUPTI, 20 calls) and its wrapper call (CUDA events, median of 20); a
    sync's cost is the device time's slope from 1 to 16."""
    from mpi_pastar_msa_tpu_torch._kernels import load

    fn = load("keyrow_insert").grid_sync_chain
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {}
    for k in (0, 1, 4, 16):
        def go(k=k):
            if fn(k, 0, torch.cuda.current_stream().cuda_stream):
                fail("grid_sync_chain failed to launch")
        out[k] = dict(ms=time_ms(go, reps=20), device_ms=device_ms(go, 20))
    per_sync_us = (out[16]["device_ms"] - out[1]["device_ms"]) / 15 * 1e3
    print(f"grid sync (cooperative grid of 132 x 512 threads, empty kernel): device "
          + ", ".join(f"{k} syncs {v['device_ms'] * 1e3:.2f} us" for k, v in out.items())
          + f" (wrapper call " + ", ".join(f"{v['ms'] * 1e3:.1f}" for v in out.values())
          + f" us); one grid sync {per_sync_us:.3f} us")
    return dict(by_syncs={str(k): v for k, v in out.items()}, per_sync_us=per_sync_us)


def pointer_chase():
    """csrc/path_walk.cu's pointer_chase C entry (one thread follows
    ``hops`` links of an int32 cycle from 0 and stores where it ended:
    next, hops, out, stream), bound."""
    from mpi_pastar_msa_tpu_torch._kernels import load

    fn = load("path_walk").pointer_chase
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dependent_load_ns(mib: int = 256, hops: int = 20000) -> dict:
    """One dependent load: a pointer chase (one thread, ``hops`` links of a
    random cyclic permutation of int32 over ``mib`` MiB, five times the
    L2; pointer_chase of csrc/path_walk.cu), CUDA events, median of 5,
    nanoseconds a hop: from L2 (the same chain again: its hops' sectors,
    about 0.6 MB, stay in L2) and from device memory (each run after
    writing 256 MiB elsewhere, which evicts them)."""
    fn = pointer_chase()
    n = mib << 18
    gen = torch.Generator(device="cuda").manual_seed(0)
    perm = torch.randperm(n, device="cuda", generator=gen)
    nxt = torch.empty(n, dtype=torch.int32, device="cuda")
    nxt[perm] = perm.roll(-1).int()
    del perm
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    evict = torch.empty(n, dtype=torch.int32, device="cuda")

    def go():
        if fn(nxt.data_ptr(), hops, out.data_ptr(), torch.cuda.current_stream().cuda_stream):
            fail("pointer_chase failed to launch")

    l2_ns = time_ms(go, reps=5, warmup=1) * 1e6 / hops
    dram_ns = time_restored(go, evict.zero_, 5) * 1e6 / hops
    del nxt, evict
    print(f"dependent load (pointer chase, {hops} hops over {mib} MiB): {l2_ns:.1f} ns a hop "
          f"from L2, {dram_ns:.1f} ns from device memory")
    return dict(mib=mib, hops=hops, l2_ns=l2_ns, dram_ns=dram_ns)


@contextlib.contextmanager
def walk_capture():
    """Keep the statics, table and layout that a run's walk
    (engine.walk) is given, for the K7 check after the run."""
    from mpi_pastar_msa_tpu_torch.search import engine as E

    seen = {}
    real = E.walk

    def spy(st, tab, layout):
        seen.update(st=st, tab=tab, layout=layout)
        return real(st, tab, layout)

    E.walk = spy
    try:
        yield seen
    finally:
        E.walk = real


def first_hit_row(st, tab, layout: str, coord):
    """The probe row at which a lookup of ``coord`` (engine._lookup_sig,
    _lookup_keyrow) takes its first hit, or None on a miss: the same
    gather, on the table's card."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch.search import engine as E

    c = torch.as_tensor(np.asarray(coord, dtype=np.int64))[None, :]
    if layout == "sig":
        home, sigb = E._sig_encode(st, c)
        rs = torch.arange(st.max_bprobes)
        idx = ((((home[0] + rs) & (st.nbuck - 1)) * st.ways)[:, None]
               + torch.arange(st.ways)).reshape(-1).to(st.device)
        hits = (tab.t_sig[idx].cpu() == (sigb[0] | rs).repeat_interleave(st.ways)
                ).view(st.max_bprobes, st.ways).any(1)
    else:
        key = E._pack_keys(c, st.W)
        idx = E._probe_slot(E._hash_keys(key)[0], torch.arange(st.max_probes),
                            st.C - 1).to(st.device)
        rows = tab.t_key[idx, : st.W].long().cpu()
        hits = (rows == E._as_i32(key).long()).all(1) & (rows[:, 0] != E._EMPTY_WORD)
    return int(torch.argmax(hits.to(torch.uint8))) if bool(hits.any()) else None


def walk_bytes(st, tab, layout: str, coord, hops: int, out_words: int) -> dict:
    """The bytes a walk from ``coord`` of at most ``hops`` lookups must
    move (K7, K7's hop mode), from this table's data: each lookup reads
    the key words of its probe rows up to its first hit (sig: 8 ways of 4
    B a bucket row; the key rows: W words) and the hit's parent word
    (t_best, 4 B; unpacked t_fpar, 8 B); the lookup that misses reads the
    key words of every probe row; the coordinate read and ``out_words``
    int32 written once.  Returns bytes, lookups and the probe rows read."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch.search import engine as E

    row = st.ways * 4 if layout == "sig" else st.W * 4
    word = 8 if layout == "unpacked" else 4
    probes = st.max_bprobes if layout == "sig" else st.max_probes
    c = np.asarray(coord, dtype=np.int64)
    nbytes, lookups, rows = st.n * 4 + out_words * 4, 0, 0
    while lookups < hops and c.any():
        r = first_hit_row(st, tab, layout, c)
        lookups += 1
        if r is None:
            nbytes, rows = nbytes + probes * row, rows + probes
            break
        nbytes, rows = nbytes + (r + 1) * row + word, rows + r + 1
        par = E._LAYOUT_FNS[layout].lookup(st, tab, torch.as_tensor(c))
        c = c - np.array([(par >> i) & 1 for i in range(st.n)])
    return dict(bytes=nbytes, lookups=lookups, probe_rows=rows)


def check_k7(label: str, seen: dict, timing: bool = False) -> dict:
    """K7 (walk_cuda) on the finished table of a run (walk_capture) against
    the plain _walk on the same card tensors: masks and final coordinate
    identical; the bound by bytes; with ``timing`` its wrapper call (CUDA
    events, median of 10, its one host read included), device time
    (CUPTI) with the table's rows left in L2 by the call before ("warm")
    and after writing 256 MiB elsewhere ("cold"; engine_walk times the
    engine's own walk), the plain walk's time, and each of K7_VARIANTS
    (another tree's K7) checked against K7 on the same table (the same
    output buffer) and timed in turns with it (old, new, new, old), cold
    and warm.  Releases the table."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    if "tab" not in seen:
        fail(f"{label}: the run gave its walk no table")
    st, tab, layout = seen.pop("st"), seen.pop("tab"), seen.pop("layout")
    got, coord = S.walk_cuda(st, tab, layout)
    want, want_coord = E._walk(st, tab, layout)
    if not (len(got) == len(want) and (got == want).all() and (coord == want_coord).all()):
        fail(f"{label}: K7's walk ({len(got)} masks, final {coord.tolist()}) differs from "
             f"_walk's ({len(want)} masks, final {want_coord.tolist()})")
    nodes = len(got)
    tmax = int(st.final_np.sum())
    wb = walk_bytes(st, tab, layout, st.final_np, tmax, tmax + st.n + 1)
    b = wb["bytes"]
    out = dict(layout=layout, path_nodes=nodes, max_abs_err=0, bytes=b,
               probe_rows=wb["probe_rows"], bound_ms=b / HBM_BYTES_PER_S * 1e3)
    msg = ""
    if timing:
        go = lambda: S.walk_cuda(st, tab, layout)
        out.update(ms=time_ms(go, reps=10), device_ms=device_ms(go, 10),
                   plain_ms=time_ms(lambda: E._walk(st, tab, layout), reps=3, warmup=1))
        # the C entries themselves on K7's arguments for this table
        args, (_, buf) = S._walk_args(st, tab, layout)
        evict = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MiB

        def entry(fn, name):
            def call():
                if fn(*args[1:]):
                    fail(f"{label}: the {name} K7 failed to launch")
            return call

        new = entry(_kernels.load("path_walk").path_walk, "engine's")
        out["cold_device_ms"] = device_ms(new, 10, evict.zero_)
        new()
        torch.cuda.synchronize()
        ref = buf.clone()
        msg = (f"; wrapper call {out['ms']:.4f} ms (CUDA events, its one read included), "
               f"device {out['device_ms']:.4f} ms warm, {out['cold_device_ms']:.4f} ms cold "
               f"(CUPTI), plain _walk {out['plain_ms']:.2f} ms")
        for name, fn in K7_VARIANTS.items():
            old = entry(fn, name)
            buf.fill_(-7)
            old()
            torch.cuda.synchronize()
            if not torch.equal(buf, ref):
                fail(f"{label}: the {name} K7's walk differs from this one's")
            v = dict(cold_turns_device_ms=[device_ms(f, 10, evict.zero_)
                                           for f in (old, new, new, old)],
                     warm_turns_device_ms=[device_ms(f, 10) for f in (old, new, new, old)])
            out[f"{name}_k7"] = v
            msg += (f"; {name} K7 identical, in turns ({name}, K7, K7, {name}) device cold "
                    + " / ".join(f"{t:.4f}" for t in v["cold_turns_device_ms"]) + " ms, warm "
                    + " / ".join(f"{t:.4f}" for t in v["warm_turns_device_ms"]) + " ms")
        del evict
    print(f"  K7 {label} ({layout}): {nodes} path nodes, masks and final coordinate identical "
          f"to _walk's on the card; bound {out['bound_ms']:.6f} ms by bytes "
          f"({b} B: {wb['probe_rows']} probe rows to the first hits){msg}")
    del tab
    return out


def engine_walk(label: str, path: str, layout: str, order) -> dict:
    """K7's device time on the engine's own walk: the one launch that
    FrontierSearch._finish makes right after the search, with the table and
    the L2 as the search left them (no eviction, no launch before it).  For
    each name in ``order`` ("K7", or a key of K7_VARIANTS) one whole search of
    ``path`` with ``layout`` pinned (engine entry, --triples auto); its walk
    launches that build's C entry once on the finished table under
    torch.profiler (CUPTI), checks its masks and final coordinate against
    the engine's walk, which then runs as usual (not timed).  Returns the
    device ms a run, in ``order``."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    builds = {"K7": _kernels.load("path_walk").path_walk, **K7_VARIANTS}
    p = problem_from_fasta(path)
    real = E.walk
    times = []
    for name in order:
        def spy(st, tab, layout_, fn=builds[name], name=name):
            args, (_, out) = S._walk_args(st, tab, layout_)

            def call():
                if fn(*args[1:]):
                    fail(f"K7 engine walk {label} {layout_}: the {name} build failed to launch")

            times.append(device_ms(call, 1))
            masks, coord = real(st, tab, layout_)
            res = out.cpu().numpy()
            tmax = len(res) - st.n - 1
            cnt = int(res[tmax + st.n])
            if not (len(masks) == cnt and (res[:cnt] == masks).all()
                    and (res[tmax:tmax + st.n] == coord).all()):
                fail(f"K7 engine walk {label} {layout_}: the {name} build's walk differs "
                     f"from the engine's")
            return masks, coord

        n0 = len(times)
        E.walk = spy
        try:
            E.FrontierSearch(p, HPairHeuristic.build(p, "cuda"), device="cuda",
                             layout=layout).run()
        finally:
            E.walk = real
        if len(times) != n0 + 1:
            fail(f"K7 engine walk {label} {layout}: the search walked {len(times) - n0} times")
    out = dict(layout=layout, order=list(order), device_ms=times)
    print(f"  K7 on the engine's own walk, {label} pinned {layout} (the launch right after "
          f"the search, CUPTI, a search a run), in turns ({', '.join(order)}): "
          + " / ".join(f"{t:.4f}" for t in times) + " ms")
    return out


def k10_tail_sweep(label: str, eng, timed: bool = False) -> dict:
    """K10's tail (the lanes round 0 leaves, state[kCnt]) and, unpacked,
    its improving lanes, a step, over ``eng``'s whole search from a new
    table: eager steps of the kernels (cap K10_CAP), the state read after
    each; medians and maxima, and the steps whose tail takes the block
    path.  With ``timed`` the search runs again with cap 0 (every round on
    the grid), both under torch.profiler: each step's K10 device time
    (CUPTI) on each path, by bin of the tail (the runs make the same
    steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    st, layout = eng.st, eng.layout
    bufs = S._step_buffers(st, torch.device("cuda"), layout)
    runs = {}
    for cap in (S.K10_CAP, 0) if timed else (S.K10_CAP,):
        tab = eng._init_table()
        ctr = torch.as_tensor(E.fresh_counters(), device="cuda")
        rows = []
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if timed
              else contextlib.nullcontext()) as prof:
            if timed:
                profiler_preamble()
            while True:
                ctr = S.run_chunk_keyrow_cuda(st, tab, ctr, 1, eng.ub, eng.fill_target,
                                              cap=cap, graph=False)
                s_ = bufs.state.tolist()
                n, rounds = s_[S.STATE_NVALID], s_[S.STATE_CALLS]
                tail = s_[S.STATE_CNT] if rounds else 0
                n_list = s_[S.STATE_NPEND]  # K10's list (unpacked: every lane)
                path = S.k10_path(n_list, rounds, tail, cap)
                # the lanes' flags (lane_dest) are written on the grid's
                # paths only: the whole-list block path keeps them in
                # registers
                improve = (int(((bufs.lane_dest[:n_list] & 2) != 0).sum())
                           if layout == "unpacked" and path in ("tail", "grid") else None)
                rows.append((n, rounds, tail, improve, n_list, path))
                c = ctr.tolist()
                if c[1] >= c[0] or c[6] > 0:
                    break
            torch.cuda.synchronize()
        us = []
        if timed:
            us = [e.time_range.elapsed_us() for e in sorted(
                (e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and "keyrow_insert_kernel" in e.name), key=lambda e: e.time_range.start)]
            if len(us) != len(rows):
                fail(f"K10 sweep {label} cap {cap}: {len(us)} K10 kernels traced for "
                     f"{len(rows)} steps")
        runs[cap] = (rows, us)
        del tab
    rows = runs[S.K10_CAP][0]
    if timed and [r[:3] for r in runs[0][0]] != [r[:3] for r in rows]:
        fail(f"K10 sweep {label}: the two paths gave different searches")
    col = lambda k: [r[k] for r in rows if r[k] is not None]
    med = lambda v: statistics.median(v) if v else 0
    paths = {k: sum(1 for r in rows if r[5] == k) for k in ("block", "tail", "grid")}
    out = dict(steps=len(rows), lanes_median=med(col(0)), lanes_max=max(col(0)),
               list_median=med(col(4)), list_max=max(col(4)),
               rounds_max=max(col(1)), tail_median=med(col(2)), tail_max=max(col(2)),
               improve_median=med(col(3)), improve_max=max(col(3), default=0),
               path_steps=paths, multi_round_steps=sum(1 for r in rows if r[1] >= 2))
    print(f"K10 tail {label} ({layout}, {len(rows)} steps): lanes a step median "
          f"{out['lanes_median']} max {out['lanes_max']}; K10's list median "
          f"{out['list_median']} max {out['list_max']}; left after round 0 (the tail) "
          f"median {out['tail_median']} max {out['tail_max']}; claim rounds max "
          f"{out['rounds_max']}; {out['multi_round_steps']} steps with a round after round 0; "
          f"steps by path at cap {S.K10_CAP}: {paths}"
          + (f"; improving lanes a step (grid and tail paths) median "
             f"{out['improve_median']} max {out['improve_max']}" if layout == "unpacked"
             else ""))
    if timed:
        edges = [0, 1, 65, 129, 257, 513, 1025, 2049, 1 << 40]
        bins = []
        for lo, hi in zip(edges, edges[1:]):
            idx = [k for k, r in enumerate(rows) if lo <= r[2] < hi]
            if idx:
                bins.append(dict(tail_lo=lo, tail_hi=hi - 1, steps=len(idx), **{
                    f"cap_{cap}_us": statistics.mean(runs[cap][1][k] for k in idx)
                    for cap in runs}))
        out["bins"] = bins
        out["total_ms"] = {f"cap_{cap}": sum(us) / 1e3 for cap, (_, us) in runs.items()}
        print(f"  K10 device time summed over the search: " + ", ".join(
            f"{t:.3f} ms at {k.replace('_', ' ')}" for k, t in out["total_ms"].items()))
        for r in bins:
            print(f"  tail in [{r['tail_lo']}, {r['tail_hi']}]: {r['steps']} steps, K10 "
                  + ", ".join(f"{r[f'cap_{cap}_us']:.2f} us at cap {cap}" for cap in runs))
    return out


# K10's list-length sweep (--k10-sweep): the lengths, and the lanes a
# thread of the wider builds that take the whole list above K10_CAP
K10_SWEEP_LENGTHS = (64, 128, 256, 512, 768, 1024, 1536, 2048, 3072, 4096)
K10_WIDE_LANES = (4, 8)


def start_k10_wide_builds(tmp: str) -> dict:
    """Start nvcc on copies of csrc/keyrow_insert.cu with kLanes set to each
    of K10_WIDE_LANES (the whole-list block path up to 512 x kLanes
    entries), into ``tmp``; returns {lanes: (proc, lib)}."""
    import re

    from mpi_pastar_msa_tpu_torch import _kernels

    text = open(os.path.join(_kernels.CSRC, "keyrow_insert.cu")).read()
    jobs = {}
    for lanes in K10_WIDE_LANES:
        src = os.path.join(tmp, f"keyrow_insert_lanes{lanes}.cu")
        edited, k = re.subn(r"constexpr int kLanes = \d+;", f"constexpr int kLanes = {lanes};",
                            text)
        if k != 1:
            fail("keyrow_insert.cu: no kLanes constant to widen")
        open(src, "w").write(edited)
        lib = os.path.join(tmp, f"libkeyrow_insert_lanes{lanes}.so")
        jobs[lanes] = (subprocess.Popen(
            [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", _kernels.CSRC, "-o", lib,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return jobs


def load_k10_wide(jobs: dict) -> dict:
    """The wider builds' C entries (start_k10_wide_builds): {cap:
    {"keyrow_insert": fn, "keyrow_insert_recv": fn, "ptxas": [lines]}}."""
    from mpi_pastar_msa_tpu_torch import _kernels

    out = {}
    for lanes, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc failed for keyrow_insert.cu with kLanes = {lanes}:\n{log}")
        entry = {"ptxas": [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]}
        for name in ("keyrow_insert", "keyrow_insert_recv"):
            fn = getattr(ctypes.CDLL(lib), name)
            fn.argtypes, fn.restype = _kernels.SIGNATURES[name], ctypes.c_int
            entry[name] = fn
        out[512 * lanes] = entry
    return out


def k10_sweep_rows(st, layout: str, pool, home, stored: int, n: int, n_front: int, rng):
    """A pending list of ``n`` entries over the keys of ``pool`` (the first
    ``stored`` of them in the table; ``home`` their home slots): stored
    keys, keys sharing a home slot, new keys, each 1-3 times, in random
    order; the first ``n_front`` received rows (tags: places), the others'
    tags from n_front up; packed h and word, unpacked g and f * 2^n + mask.
    (n, PW) int32 on the card."""
    from mpi_pastar_msa_tpu_torch.search import engine as E

    # keys beyond the fresh ones that share a home slot with another
    far = home[stored + n:]
    _, first, cnt = np.unique(far, return_index=True, return_counts=True)
    shared = stored + n + np.flatnonzero(np.isin(far, far[first[cnt >= 2]]))[:n // 8]
    distinct = np.concatenate([rng.choice(stored, n // 4, replace=False), shared,
                               np.arange(stored, stored + n)])
    coords = pool[rng.permutation(np.repeat(distinct, rng.integers(1, 4, len(distinct))))][:n]
    ck = E._pack_keys(torch.from_numpy(coords), st.W)
    tag = torch.from_numpy(n_front + rng.permutation(4 * n)[:n])
    if layout == "packed":
        tail = [torch.from_numpy(coords.sum(1) * 7),
                torch.from_numpy((rng.integers(0, 4000, n) << st.nb) | rng.integers(1, 32, n))]
    else:
        g = torch.from_numpy(rng.integers(1000, 1100, n))
        fpar = (g + 1000) * (1 << st.nb) + torch.from_numpy(rng.integers(1, st.M + 1, n))
        tail = [g, E._as_i32(fpar & 0xFFFFFFFF).long(), fpar >> 32]
    rows = torch.cat([E._as_i32(ck).long(), E._as_i32(E._hash_keys(ck)).long()[:, None],
                      tag[:, None]] + [t[:, None] for t in tail], 1)
    return rows.to(torch.int32).cuda()


def k10_list_sweep(path: str, wide: dict, baseline=None) -> dict:
    """K10 against its list length n (K10_SWEEP_LENGTHS), packed and
    unpacked, without and with received rows (n // 8, keyrow_insert_recv):
    a kinase table of 2^20 slots an eighth full, synthetic lists
    (k10_sweep_rows), each launch from the same table (the slots a run
    changed restored).  Device times (CUPTI, 20 launches) of the whole list
    in one block ("block": this tree at K10_CAP, above it the narrowest
    build of ``wide`` that takes n), of PR 24's schedule ("tail": round 0
    on the grid, the rest in block 0 when at most K10_CAP are left; this
    tree at cap min(n - 1, K10_CAP)), of every round on the grid ("grid":
    cap 0) and, given ``baseline``, of the other tree's K10 at K10_CAP;
    every one's table words, counters and rounds equal to the block's, and
    the block's to insert_pending_plain."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    cuda = torch.device("cuda")
    p = problem_from_fasta(path)
    h = HPairHeuristic.build(p, cuda)
    out = {"lengths": list(K10_SWEEP_LENGTHS), "wide_ptxas": {
        str(c): w["ptxas"] for c, w in wide.items()}}
    print(f"K10 list sweep (kinase table of 2^20 slots, an eighth full; device us, CUPTI, 20 "
          f"launches; wider builds: " + "; ".join(
              f"cap {c}: " + ", ".join(w["ptxas"]) for c, w in wide.items()) + ")")
    for layout in ("packed", "unpacked"):
        eng = E.FrontierSearch(p, h, device=cuda, layout=layout, batch=256, capacity=1 << 20,
                               triples="off")
        st = eng.st
        rng = np.random.default_rng(7)
        pool = np.unique(np.stack([rng.integers(0, int(v) + 1, 400000) for v in st.final_np], 1),
                         axis=0)
        rng.shuffle(pool)
        stored = 1 << 17
        keys = E._pack_keys(torch.from_numpy(pool), st.W)
        home = (E._hash_keys(keys) & (st.C - 1)).numpy()
        tab0 = eng._init_table()
        sk = keys[:stored].cuda()
        if layout == "packed":
            E._insert_core_packed(st, tab0, sk, torch.full((stored,), 7, device=cuda),
                                  torch.full((stored,), 3000 << st.nb, device=cuda) | 1)
        else:
            g = torch.from_numpy(rng.integers(1000, 1100, stored)).cuda()
            E._insert_core(st, tab0, sk, g, g + 500,
                           torch.ones(stored, dtype=torch.int64, device=cuda))
            tab0.t_state[:st.C][(tab0.t_state[:st.C] == 1)
                                & (torch.rand(st.C, device=cuda) < 0.33)] = 2
        tab0.claim.fill_(E.INFP)
        bufs = S.StepBuffers.for_step(st, cuda, layout)
        bufs.tail = torch.empty(max(wide) if wide else S.K10_CAP, dtype=torch.int32,
                                device=cuda)
        tab, fields = clone_table(tab0), list(vars(tab0))
        ctr0 = torch.as_tensor(E.fresh_counters(), device=cuda)
        ctr0[0] = 5000
        ctr, state0 = ctr0.clone(), torch.zeros_like(bufs.state)
        stream = torch.cuda.current_stream().cuda_stream
        out[layout] = rows_out = []
        for received in (False, True):
            for n in K10_SWEEP_LENGTHS:
                n_front = n // 8 if received else 0
                bufs.pend[:n].copy_(k10_sweep_rows(st, layout, pool, home, stored, n, n_front,
                                                   rng))
                state0.zero_()
                state0[S.STATE_NOPEN], state0[S.STATE_NSEL] = stored, 256
                state0[S.STATE_NVALID], state0[S.STATE_NPEND] = n - n_front, n
                recv = torch.tensor([n_front], dtype=torch.int32, device=cuda)
                changed = [torch.arange(st.C, device=cuda)]

                def restore():
                    idx = changed[0]
                    for f in fields:
                        getattr(tab, f)[idx] = getattr(tab0, f)[idx]
                    ctr.copy_(ctr0)
                    bufs.state.copy_(state0)
                    bufs.run.fill_(1)

                def launcher(fns, cap):
                    args = S._keyrow_insert_args(st, tab, bufs, ctr, 64, 0, cap, stream,
                                                 pend_at=n_front, recv=recv)
                    if fns is None:
                        return _kernels.bind(*args)
                    fn = fns[args[0]]

                    def go():
                        if fn(*args[1:]):
                            fail(f"K10 sweep: a build's {args[0]} failed to launch")
                    return go

                outputs = lambda: ([getattr(tab, f)[:st.C].clone() for f in fields]
                                   + [ctr.clone(), bufs.state[S.STATE_CALLS:].clone()])
                block_cap = S.K10_CAP if n <= S.K10_CAP else min(c for c in wide if c >= n)
                kinds = {"block": launcher(None if n <= S.K10_CAP else wide[block_cap],
                                           block_cap),
                         "tail": launcher(None, min(n - 1, S.K10_CAP)),
                         "grid": launcher(None, 0)}
                if baseline is not None and "keyrow_insert_recv" in baseline:
                    kinds["baseline"] = launcher(baseline, S.K10_CAP)
                restore()
                kinds["block"]()
                torch.cuda.synchronize()
                want = outputs()
                s_ = bufs.state.tolist()
                rounds = s_[S.STATE_CALLS]
                counts = s_[S.STATE_CNT:S.STATE_CNT + rounds]
                changed[0] = torch.nonzero(torch.stack(
                    [(getattr(tab, f)[:st.C] != getattr(tab0, f)[:st.C]).reshape(st.C, -1).any(1)
                     for f in fields]).any(0))[:, 0]
                plain = clone_table(tab0)
                ovf, _, p_rounds, _, _ = SH.insert_pending_plain(st, plain, layout,
                                                                 bufs.pend[:n], n_front)
                if p_rounds != rounds or any(not torch.equal(getattr(plain, f)[:st.C],
                                                             getattr(tab, f)[:st.C])
                                             for f in fields):
                    fail(f"K10 sweep {layout} n {n}: the block path differs from "
                         f"insert_pending_plain")
                for k, fn in kinds.items():
                    restore()
                    fn()
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(want, outputs())):
                        fail(f"K10 sweep {layout} n {n}: {k} differs from the block path")
                us = {k: device_ms(fn, 20, restore) * 1e3 for k, fn in kinds.items()}
                paths = {k: S.k10_path(n, rounds, counts[0], c) for k, c in (
                    ("block", block_cap), ("tail", min(n - 1, S.K10_CAP)), ("grid", 0))}
                row = dict(n=n, received=n_front, rounds=rounds, unsettled=counts,
                           block_cap=block_cap, paths=paths, us=us)
                rows_out.append(row)
                print(f"  {layout} n {n} ({n_front} received; {rounds} rounds, unsettled "
                      f"{counts}): " + ", ".join(f"{k} {v:.2f}" for k, v in us.items())
                      + f" us (block at cap {block_cap}: {paths['block']}; the tail's "
                      f"schedule: {paths['tail']})")
        del eng, tab0, tab, bufs
    # the crossover: the longest list up to which one block beats PR 24's
    # schedule at every length, each layout and received count
    win = [r["n"] for lay in ("packed", "unpacked") for r in out[lay]
           if r["us"]["block"] < r["us"]["tail"]]
    lose = [r["n"] for lay in ("packed", "unpacked") for r in out[lay]
            if r["us"]["block"] >= r["us"]["tail"]]
    out["block_wins_up_to"] = max([n for n in win if not lose or n < min(lose)], default=0)
    print(f"  one block ahead of the tail's schedule at every length up to "
          f"{out['block_wins_up_to']} (behind at {sorted(set(lose)) or 'none'})")
    return out


def keyrow_step(label: str, eng, tab0, ctr0, timing: bool = True,
                baseline=None, k10_phase_fns=None) -> dict:
    """The packed or unpacked step kernels K3 -> K9 -> K10 against the
    plain step on the card, from one mid-search table of ``eng``: 1 and 32
    steps through run_chunk_keyrow_cuda as a chunk graph and as the eager
    chunk (and 1 step with K10 on one block), each with K10 at its cap
    (the block path for the lanes left after round 0) and at cap 0 (every
    round on the grid), and through _run_chunk_plain(plain_select=True) on
    copies; every table tensor (claim included, the first C slots) and the
    14 counters must be identical.  With ``timing``: one step's K3, K9 and
    K10 (CUDA events around the wrapper call, and the device time from
    CUPTI; K10 on both its paths, with its grid syncs) beside their plain
    versions (the plain select; _expand -> prune -> candidates; the plain
    insert with its content tags) and their bounds by bytes, and K3's
    library yardstick (torch.min over the same (B, G) view); K9's launch
    shape, its surviving and pending lanes and its bounds by bytes and by
    operations; ``baseline`` (load_keyrow_baseline) is another tree's K10,
    run from K9's state at K10_CAP and at cap 0, checked against this one
    (tables, counters, state) and timed in turns with it (old, new, new,
    old); ``k10_phase_fns`` the K10_PHASES build, K10's split on both
    paths."""
    import dataclasses

    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    st, ub, fill, layout = eng.st, eng.ub, eng.fill_target, eng.layout
    C, W = st.C, st.W
    fields = [f.name for f in dataclasses.fields(tab0)]

    def diff(a_tab, a_ctr, b_tab, b_ctr) -> int:
        err = max(int((getattr(a_tab, k)[:C].long() - getattr(b_tab, k)[:C].long()).abs().max())
                  for k in fields)
        return max(err, int((a_ctr - b_ctr).abs().max()))

    row = dict(layout=layout, batch=st.B, groups=C // st.B, masks=st.M, key_words=W,
               warm_steps=int(ctr0[2]), checks=[])
    captures0 = S.capture_stats(st)[0]
    for n in (1, 32):
        ptab = clone_table(tab0)
        pctr = E._run_chunk_plain(st, ptab, ctr0, n, ub, fill, layout, plain_select=True)
        for cap in (S.K10_CAP, 0):
            for mode, graph, blocks in (("graph", True, 0), ("eager", False, 0),
                                        ("graph, K10 on one block", True, 1)):
                if n == 32 and blocks:
                    continue
                ktab = clone_table(tab0)
                kctr = S.run_chunk_keyrow_cuda(st, ktab, ctr0, n, ub, fill, blocks=blocks,
                                               cap=cap, graph=graph)
                torch.cuda.synchronize()
                err = diff(ktab, kctr, ptab, pctr)
                if err != 0:
                    fail(f"key-row step {label}, {n} step(s), {mode}, K10 cap {cap}: kernels "
                         f"differ from the plain step (max |err| {err}); counters "
                         f"{kctr.tolist()} vs {pctr.tolist()}")
                row["checks"].append(dict(steps=n, mode=mode, k10_cap=cap, max_abs_err=err,
                                          counters=kctr.tolist()))
                del ktab
        del ptab
    row["captures"] = S.capture_stats(st)[0] - captures0
    print(f"key-row step {label} ({layout}, B={st.B}, G={C // st.B}, M={st.M}, from step "
          f"{int(ctr0[2])}): every table tensor (claim included) and the 14 counters "
          f"identical to the plain step after 1 step (chunk graph, eager chunk, K10 on one "
          f"block) and after 32 steps (graph, eager), K10 at cap {S.K10_CAP} and at cap 0; "
          f"{row['captures']} graph captures")
    if not timing:
        return row

    bufs = S._step_buffers(st, tab0.t_key.device, layout)
    stream = torch.cuda.current_stream().cuda_stream
    work, snap = clone_table(tab0), clone_table(tab0)
    ctr = ctr0.clone()
    ctr[1] = 0
    goal, thr = ctr[0], ctr[7]

    def copy_tab(dst, src):
        for k in fields:
            getattr(dst, k).copy_(getattr(src, k))

    def restore_tab():
        copy_tab(work, snap)
        ctr.copy_(ctr0)
        ctr[1] = 0
        bufs.run.fill_(1)

    bufs.run.fill_(1)
    k3, k9, k10 = (_kernels.bind(*a)
                   for a in S._step_args(st, work, bufs, ctr, ub, fill, 0, S.K10_CAP, stream))
    k10_grid = _kernels.bind(*S._keyrow_insert_args(st, work, bufs, ctr, fill, 0, 0, stream))
    unpacked = layout == "unpacked"
    if unpacked:
        plain3 = lambda: E._select_open_plain(st, work.t_state, work.t_fpar, goal, thr)
        t_f = snap.t_fpar[:C] >> st.nb
        v_open = torch.where((snap.t_state[:C] == 1) & (t_f < goal), t_f, E.INF)
        lib_bytes = C * 8 + st.B * 16  # int64 f read, B values and indices written
    else:
        plain3 = lambda: E._select_best_plain(st, work.t_best, work.t_closed, goal, thr)
        best0, closed0 = snap.t_best[:C], snap.t_closed[:C]
        v_open = torch.where((best0 < closed0) & ((best0 >> st.nb) < goal - st.f0), best0,
                             E.INFP)
        lib_bytes = C * 4 + st.B * 12
    v_open = v_open.view(st.B, C // st.B)
    k3_ms = time_restored(k3, restore_tab, 20)
    k3_plain_ms = time_restored(plain3, restore_tab, 5)
    k3_lib_ms = time_ms(lambda: torch.min(v_open, dim=1), reps=20)
    k3_lib_dev = device_ms(lambda: torch.min(v_open, dim=1), 20,
                           keep=lambda k: (not k.startswith(("aten::", "cuda", "Memcpy"))
                                           and "spin_kernel" not in k))
    # after K3: its table, state and list, then K9
    restore_tab()
    k3()
    after3, state3 = clone_table(work), bufs.state.clone()

    def restore3():
        restore_tab()
        copy_tab(work, after3)
        bufs.state.copy_(state3)

    k9_ms = time_restored(k9, restore3, 20)
    restore3()
    k9()
    # after K9: its table (packed: t_best, where its round-0 matches
    # settled), the goal, its state and pending list, then K10
    state9, ctr9, after9 = bufs.state.clone(), ctr.clone(), clone_table(work)
    n_lanes = int(state9[S.STATE_NVALID])  # surviving lanes
    n_pend = int(state9[S.STATE_NPEND])    # of them, K10's list
    pend9 = bufs.pend[:n_pend].clone()
    blocks9, threads9, passes9 = S.k9_launch_shape(st.B, st.M, S._sms(tab0.t_key.device))

    def restore9():
        restore_tab()
        copy_tab(work, after9)
        ctr.copy_(ctr9)
        bufs.state.copy_(state9)
        bufs.pend[:n_pend].copy_(pend9)

    k10_ms = time_restored(k10, restore9, 20)
    k10_grid_ms = time_restored(k10_grid, restore9, 20)
    k10_outputs = lambda: ([getattr(work, k)[:C].clone() for k in fields]
                           + [ctr.clone(), bufs.state[S.STATE_CALLS:].clone()])
    restore9()
    k10_grid()
    torch.cuda.synchronize()
    grid_out = k10_outputs()
    restore9()
    k10()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grid_out, k10_outputs())):
        fail(f"key-row step {label}: K10's block path and its grid path differ")
    s10 = bufs.state.tolist()
    n_sel, rounds = s10[S.STATE_NSEL], s10[S.STATE_CALLS]
    counts = [s10[S.STATE_CNT + k] for k in range(rounds)]
    tail = counts[0] if rounds else 0
    syncs = S.k10_grid_syncs(rounds, n_pend, tail, S.K10_CAP, unpacked)
    syncs_grid = S.k10_grid_syncs(rounds, n_pend, tail, 0, unpacked)
    new_keys = int((work.t_key[:C, 0] != -1).sum() - (after3.t_key[:C, 0] != -1).sum())
    improved = int((work.t_g[:C] != after3.t_g[:C]).sum()) if unpacked else 0
    step_ms = time_restored(lambda: (k3(), k9(), k10()), restore_tab, 20)
    k3_dev = device_ms(k3, 20, restore_tab)
    k9_dev = device_ms(k9, 20, restore3)
    k10_dev = device_ms(k10, 20, restore9)
    k10_grid_dev = device_ms(k10_grid, 20, restore9)
    ph = {}
    if k10_phase_fns is not None:
        for key, c in (("phases", S.K10_CAP), ("grid_phases", 0)):
            ph[key] = k10_phases(k10_phase_fns, S._keyrow_insert_args(
                st, work, bufs, ctr, fill, 0, c, stream), bufs.tail, restore9)
            print(f"  K10 phases at cap {c} ({n_pend} lanes, K10_PHASES build, block 0's "
                  f"%globaltimer, median of 20): {k10_phase_line(ph[key])}")
    step_dev = device_ms(lambda: (k3(), k9(), k10()), 20, restore_tab)
    base = None
    if baseline is not None:
        # the other tree's K10 on K9's state, at this cap and at cap 0
        base = {f"cap_{c}": k10_turns(
            f"{label} step {int(ctr0[2])}, K10 cap {c}", baseline,
            S._keyrow_insert_args(st, work, bufs, ctr, fill, 0, c, stream), restore9,
            k10_outputs) for c in (S.K10_CAP, 0)}
    # the plain pieces on the same table: the plain select (not timed),
    # then _expand -> prune -> candidates for K9 and the insert for K10
    restore_tab()
    fns = E._LAYOUT_FNS[layout]
    coords, g, par, f_par, active, *_ = fns.select(st, work, goal, thr,
                                                  best=E._PLAIN_ARGMIN[layout])
    selected = clone_table(work)

    def plain9():
        sel = torch.nonzero(active)[:, 0]
        g_c, f_c, m_c, valid, _, child = E._expand(
            st, coords[sel], g[sel], par[sel], torch.ones_like(sel, dtype=torch.bool),
            f_parent=None if f_par is None else f_par[sel])
        keep = torch.nonzero(valid & (f_c <= ub))[:, 0]
        return fns.candidates(st, child[keep], g_c[keep], f_c[keep], m_c[keep], keep), valid

    k9_plain_ms = time_ms(plain9, reps=5)
    cand, valid9 = plain9()
    masks9 = int(valid9.sum())  # child <= final: the masks whose lookups K9 runs
    k10_plain_ms = time_restored(lambda: fns.insert(st, work, *cand),
                                 lambda: copy_tab(work, selected), 5)
    step_plain_ms = time_restored(
        lambda: E._run_chunk_plain(st, work, ctr0, 1, ub, fill, layout, plain_select=True),
        restore_tab, 5)
    P, T, PW = st.P, st.T3, bufs.pend.shape[1]
    # K3: both tables read (packed: t_best and t_closed, 8 B a slot;
    # unpacked: t_state and t_fpar, 12 B), slots/vmin/active written, the
    # active slots closed and listed.  K9: a list entry, the row (packed: its
    # KW words; unpacked: W words, t_g and t_fpar), P T8 rows and 8T corners
    # a row, then a pending entry a surviving lane.  K10: the pending list,
    # a key row a live lane a round, a key row and a claim word a new key,
    # then packed a t_best word a settled lane, unpacked t_g and t_state
    # read a settled lane and t_g, t_fpar and t_state written an improved
    # slot.
    bytes3 = C * (12 if unpacked else 8) + st.B * 17 + n_sel * (4 + 8)
    row_bytes = (W * 4 + 4 + 8) if unpacked else st.KW * 4
    # K9 (packed) also reads each surviving lane's home row and writes
    # t_best for the ones it settles
    matched = n_lanes - n_pend
    bytes9 = (n_sel * (8 + row_bytes + 32 * P + 32 * T) + n_pend * PW * 4
              + (0 if unpacked else n_lanes * W * 4 + matched * 4))
    # K9's operations, on the masks that pass the validity test (the others
    # skip the lookups): P term lookups with two int64 adds each (4 int32
    # operations) and T corners with one int64 add (2) over the int32 rate;
    # and, beside it, one shared-memory wavefront a warp's lookup (32 masks)
    ops9 = masks9 * (4 * P + 2 * T)
    k9_shared_ms = masks9 / 32 * (P + T) / SHARED_WAVEFRONTS_PER_S * 1e3
    live = n_pend + sum(counts[:-1])
    settled = n_pend - (counts[-1] if rounds else 0)
    bytes10 = (n_pend * PW * 4 + live * W * 4 + new_keys * (st.KW * 4 + 4)
               + (settled * 8 + improved * 16 if unpacked else settled * 4))
    ms = lambda b: b / HBM_BYTES_PER_S * 1e3
    k9_bytes_ms, k9_ops_ms = ms(bytes9), max(ops9 / INT32_OPS_PER_S * 1e3, k9_shared_ms)
    row.update(
        selected=n_sel, lanes=n_lanes, rounds=rounds, unsettled=counts, new_keys=new_keys,
        improved_slots=improved,
        k3=dict(ms=k3_ms, device_ms=k3_dev, plain_ms=k3_plain_ms, library_ms=k3_lib_ms,
                library_device_ms=k3_lib_dev, library_bytes=lib_bytes,
                library_bound_ms=ms(lib_bytes), bound_ms=ms(bytes3), bytes=bytes3),
        k9=dict(ms=k9_ms, device_ms=k9_dev, plain_ms=k9_plain_ms,
                bound_ms=max(k9_bytes_ms, k9_ops_ms),
                bound_by="bytes" if k9_bytes_ms >= k9_ops_ms else "operations",
                bytes=bytes9, bytes_bound_ms=k9_bytes_ms, ops=ops9, ops_bound_ms=k9_ops_ms,
                int32_bound_ms=ops9 / INT32_OPS_PER_S * 1e3, shared_bound_ms=k9_shared_ms,
                masks=masks9,
                blocks=blocks9, threads=threads9, passes=passes9, rows=n_sel, lanes=n_lanes,
                pending=n_pend, settled_in_k9=matched),
        k10=dict(ms=k10_ms, device_ms=k10_dev, plain_ms=k10_plain_ms, bound_ms=ms(bytes10),
                 bytes=bytes10, tail=tail, grid_syncs=syncs,
                 path=S.k10_path(n_pend, rounds, tail, S.K10_CAP),
                 grid_ms=k10_grid_ms, grid_device_ms=k10_grid_dev, grid_path_syncs=syncs_grid,
                 list=n_pend, baseline=base, **ph),
        step=dict(ms=step_ms, device_ms=step_dev, plain_ms=step_plain_ms,
                  bound_ms=ms(bytes3 + bytes9 + bytes10), bytes=bytes3 + bytes9 + bytes10))
    k3_name = "K3 (unpacked)" if unpacked else "K3"
    print(f"  K9 launch: {blocks9} blocks of {threads9} threads, a block a row, {passes9} "
          f"pass(es) a row over {st.M} masks; {n_sel} rows listed; {n_lanes} surviving lanes "
          f"(kNValid), {n_pend} pending for K10 (kNPend), {matched} settled in K9 by the "
          f"round-0 match; K9's bound: bytes {k9_bytes_ms:.5f} ms ({bytes9} B), operations "
          f"{k9_ops_ms:.5f} ms (of {masks9} valid masks of {n_sel * st.M}: {ops9} int32 "
          f"operations at {INT32_OPS_PER_S / 1e12:.2f} TOP/s "
          f"{ops9 / INT32_OPS_PER_S * 1e3:.5f} ms, {masks9 * (P + T) // 32} shared-memory "
          f"wavefronts {k9_shared_ms:.5f} ms): {row['k9']['bound_by']}")
    print(f"  step {int(ctr0[2])}: {n_sel} rows, {n_lanes} lanes, {rounds} claim rounds "
          f"(unsettled after each: {counts}), {new_keys} new keys; wrapper call (CUDA "
          f"events) / device (CUPTI): {k3_name} {k3_ms:.4f} / {k3_dev:.4f} ms (plain "
          f"{k3_plain_ms:.4f}, bound {ms(bytes3):.5f}; torch.min over (B, G) alone "
          f"{k3_lib_ms:.4f} / {k3_lib_dev:.4f} ms, its bound {ms(lib_bytes):.5f}); K9 "
          f"{k9_ms:.4f} / {k9_dev:.4f} ms (plain _expand -> prune -> candidates "
          f"{k9_plain_ms:.4f}, bound {row['k9']['bound_ms']:.5f} by "
          f"{row['k9']['bound_by']}); K10 {k10_ms:.4f} / {k10_dev:.4f} ms "
          f"({row['k10']['path']} path: list {n_pend}, tail {tail} lanes, {syncs} grid syncs; "
          f"at cap 0 every round on the grid {k10_grid_ms:.4f} / {k10_grid_dev:.4f} ms, "
          f"{syncs_grid} grid syncs; plain insert {k10_plain_ms:.4f}, bound "
          f"{ms(bytes10):.5f}); step {step_ms:.4f} / "
          f"{step_dev:.4f} ms (plain {step_plain_ms:.4f}, bound "
          f"{ms(bytes3 + bytes9 + bytes10):.5f} by bytes)")
    del work, snap, after3, after9, selected
    return row


def data_path(name: str) -> str:
    return os.path.join(ROOT, "tests", "data", f"{name}.fasta")


def data_gold(name: str, g: int) -> dict:
    """The golden record of a tests/data input: its g and its sequences
    (no golden alignment exists for it)."""
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta

    return {"optimal_g": g, "seqs": list(problem_from_fasta(data_path(name)).seqs),
            "alignment": None}


def check_alignment(name: str, alignment, gold: dict, want_identical: bool):
    """Degapped rows equal to the inputs; byte-identity with the golden
    alignment where there is one (None where there is none)."""
    want_rows = gold.get("seqs") or [r.replace("-", "") for r in gold["alignment"]]
    if [r.replace("-", "") for r in alignment] != want_rows:
        fail(f"{name}: degapped alignment rows differ from the inputs")
    identical = None if gold["alignment"] is None else alignment == gold["alignment"]
    if want_identical and not identical:
        fail(f"{name}: alignment differs from the golden")
    return identical


def main_path(name: str, path: str, gold: dict, want_identical: bool,
              triples: str, want_layout: str = "sig", engines: dict = None,
              k7_timing: bool = False) -> dict:
    """One run of the CLI entry with the frontier engine (--engine
    frontier: the CLI's default, auto, takes the native engine for the
    small inputs); ``triples`` "auto" runs it with its defaults (no
    --triples), "off" pins the pairwise heuristic.  Phase 1 must launch K1
    and K8 once each and give the host fill's weights; the step kernels
    of the layout must run, and K7 once, and no plain step
    function nor the plain walk; then K7 against _walk on the run's
    finished table (check_k7, timed with ``k7_timing``); ``engines`` keeps
    the run's engine under ``name``."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch import cli

    argv = [path, "--device", "cuda", "--engine", "frontier"]
    if triples != "auto":
        argv += ["--triples", triples]
    args = cli.make_parser().parse_args(argv)
    if args.triples != triples:
        fail(f"{name}: the CLI default is --triples {args.triples}, not {triples}")
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    with contextlib.redirect_stdout(out), plain_step_guard() as plain, \
            walk_capture() as seen:
        rep = cli.execute(args)
    counts = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    check_weights(name, rep.heuristic, rep.problem.seqs, counts)
    res = rep.result
    if res.g != gold["optimal_g"]:
        fail(f"{name}: g={res.g}, want {gold['optimal_g']}")
    if "Final Score:" not in out.getvalue():
        fail(f"{name}: no Final Score line")
    # FrontierSearch._finish ran attach_path_g(goal_g=g): the recomputed
    # path cost equals g, or the run would have raised
    identical = check_alignment(name, rep.alignment, gold, want_identical)
    eng = rep.engine
    if eng.layout != want_layout:
        fail(f"{name}: table layout {eng.layout}, want {want_layout}")
    cubes = len(getattr(eng.heuristic, "triangles", None) or [])
    if triples == "auto" and cubes == 0:
        fail(f"{name}: --triples auto built no cube")
    # the kernels of this path: K1 always, K2 whenever cubes were built, and
    # the layout's step kernels
    for k in ["pair_wavefront"] + (["triple_wavefront"] if cubes else []):
        if counts[k] <= 0:
            fail(f"{name}: kernel {k} was not launched on the main path")
    check_path_kernels(name, eng, res, counts, plain)
    want = MAIN_PATH_COUNTS.get((name, triples))
    if want and (res.nodes_expanded, res.nodes_reopened, res.steps) != want:
        fail(f"{name} --triples {triples}: expanded, reopened, steps "
             f"{(res.nodes_expanded, res.nodes_reopened, res.steps)}, want {want}")
    if engines is not None:
        engines[name] = eng
    info = dict(triples=triples, layout=eng.layout, cubes=cubes, g=res.g,
                path_nodes=len(res.closed), pairs=eng.st.P, key_words=eng.st.KW,
                identical=identical, expanded=res.nodes_expanded,
                reopened=res.nodes_reopened, steps=res.steps,
                capacity=eng.st.C, batch=eng.st.B, fill_target=eng.fill_target,
                regrown=eng.regrown,
                walls=rep.walls, nodes_per_s=res.nodes_expanded / rep.walls["phase2"],
                launches=counts, graph_captures=eng.graph_captures,
                upper_bound_s=eng.ub_wall, cubes_s=eng.cubes_wall,
                engine_walls=eng.last_phase_walls, peak_device_bytes=peak,
                acct=eng.last_acct, open_size=res.open_size)
    print(f"{name} --triples {triples}: layout {eng.layout}, {cubes} cubes; g={res.g} "
          f"ok, path cost == g, alignment byte-identical to golden: {identical}; "
          f"Phase 1/2/3 = {rep.walls['phase1']:.3f} / {rep.walls['phase2']:.3f} / "
          f"{rep.walls['phase3']:.3f} s (cube build {eng.cubes_wall:.3f} s, host "
          f"upper-bound beam {eng.ub_wall:.3f} s and path walk "
          f"{eng.last_phase_walls['walk']:.3f} s of Phase 2); expanded "
          f"{res.nodes_expanded}, reopened {res.nodes_reopened}, steps {res.steps}, "
          f"{info['nodes_per_s']:.0f} nodes/s, capacity {eng.st.C} "
          f"(regrown: {eng.regrown}), batch {eng.st.B}, fill target "
          f"{eng.fill_target}; peak device memory {peak / 2**20:.1f} MiB; "
          f"launches {counts}; chunk graphs captured {eng.graph_captures}; walls: "
          f"{loop_walls(eng)}; open size {res.open_size}")
    info["k7"] = check_k7(f"{name} --triples {triples}", seen, k7_timing)
    return info


def pinned_layout(name: str, path: str, gold: dict, layout: str,
                  want_identical: bool, k7_timing: bool = False) -> dict:
    """One run of the engine entry (as --profile drives it) with the table
    layout pinned, under --triples auto, then build_alignment; K7 as in
    main_path."""
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    from mpi_pastar_msa_tpu_torch import _kernels

    p = problem_from_fasta(path)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    t0 = time.perf_counter()
    with plain_step_guard() as plain, walk_capture() as seen:
        eng = FrontierSearch(p, HPairHeuristic.build(p, "cuda"), device="cuda",
                             layout=layout)
        res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    check_weights(f"{name} layout {layout}", eng.heuristic, p.seqs, counts)
    if eng.layout != layout:
        fail(f"{name}: pinned {layout}, ran {eng.layout}")
    if res.g != gold["optimal_g"]:
        fail(f"{name} layout {layout}: g={res.g}, want {gold['optimal_g']}")
    # attach_path_g(goal_g=g) in _finish: the path cost equals g
    identical = check_alignment(f"{name} layout {layout}",
                                build_alignment(p, res.closed), gold, want_identical)
    check_path_kernels(f"{name} layout {layout}", eng, res, counts, plain)
    info = dict(layout=layout, g=res.g, identical=identical, launches=counts,
                graph_captures=eng.graph_captures,
                expanded=res.nodes_expanded, reopened=res.nodes_reopened,
                steps=res.steps, capacity=eng.st.C, batch=eng.st.B,
                regrown=eng.regrown, wall_s=wall, upper_bound_s=eng.ub_wall,
                engine_walls=eng.last_phase_walls, peak_device_bytes=peak,
                acct=eng.last_acct, open_size=res.open_size)
    print(f"{name} layout {layout} (pinned, --triples auto): g={res.g} ok, path "
          f"cost == g, alignment byte-identical to golden: {identical}; wall "
          f"{wall:.3f} s (upper-bound beam {eng.ub_wall:.3f} s, walk "
          f"{eng.last_phase_walls['walk']:.3f} s); expanded {res.nodes_expanded}, "
          f"reopened {res.nodes_reopened}, steps {res.steps}, capacity {eng.st.C} "
          f"(regrown: {eng.regrown}), batch {eng.st.B}; peak device memory "
          f"{peak / 2**20:.1f} MiB; launches {counts}; walls: {loop_walls(eng)}")
    info["k7"] = check_k7(f"{name} layout {layout}", seen, k7_timing)
    return info


def degenerate_input() -> dict:
    """Non-positive Altschul weights: no finite upper bound, so the engine
    must warn, take the unpacked layout and complete."""
    from mpi_pastar_msa_tpu_torch.core.problem import Problem
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    from mpi_pastar_msa_tpu_torch import _kernels

    p = Problem(("WYWY", "WYY", "YWW"))
    _kernels.reset_counts()
    with warnings.catch_warnings(record=True) as caught, plain_step_guard() as plain, \
            walk_capture() as seen:
        warnings.simplefilter("always")
        eng = FrontierSearch(p, HPairHeuristic.build(p, "cuda"), device="cuda",
                             batch=16, capacity=1 << 12)
        res = eng.run()
    counts = dict(_kernels.launches)
    if not any("optimality is undefined" in str(w.message) for w in caught):
        fail("degenerate input: no warning")
    if eng.layout != "unpacked" or not res.closed:
        fail(f"degenerate input: layout {eng.layout}, {len(res.closed)} path nodes")
    check_path_kernels("degenerate input", eng, res, counts, plain)
    print(f"degenerate input (WYWY, WYY, YWW): warned, layout {eng.layout}, "
          f"completed with g={res.g} after {res.nodes_expanded} expansions and "
          f"{res.steps} steps; walk {eng.last_phase_walls['walk']:.4f} s; launches {counts}")
    return dict(layout=eng.layout, g=res.g, expanded=res.nodes_expanded, steps=res.steps,
                launches=counts, engine_walls=eng.last_phase_walls,
                k7=check_k7("degenerate input", seen))


def sharded_step_bounds(B: int, N: int, T: int, walk: dict, ndev: int = 4,
                        cap: int = None) -> dict:
    """Bounds of the sharded step's device functions (parallel/sharded.py)
    at one card of an ``ndev``-card mesh, from the sharded engine's shapes
    (B rows selected a shard, M = 2^N - 1 masks, T cubes, the exchange cap
    ``cap``, by default the engine's own, min(L, max(256, 2L / ndev))):
    device memory bytes over HBM_BYTES_PER_S, NVLink bytes (what a card
    sends) over NVLINK_BYTES_PER_S, the larger named.
    - _route_cap :87 / _route_ragged :169, a step: L = B M candidates of
      4 words (dest, f, 2 wire fields) and a carry ring of L rows of 4
      words read; ndev x cap rows of 3 words received and the ring
      rewritten, cap = min(L, max(256, 2L / ndev)) (the JAX default);
      ndev - 1 of ndev wire blocks sent;
    - _make_tri_partial :250 with _sharded_h3 :302, a step: B x N
      coordinates read, ndev B x N gathered, ndev B x ceil(T / ndev) cube
      corner rows of 8 words read, (B, M + 1) int32 written; the
      reduce-scatter sends ndev - 1 of ndev (ndev B, M + 1) blocks;
    - _consensus :312, a step: a 4-word all_gather;
    - _make_batched_walk :482, once a run: ``walk`` (sharded_walk_bytes,
      from the run's tables): the probe rows every shard's lookups read to
      their first hit or their miss, and one psum of K = 8 masks a
      round."""
    M = (1 << N) - 1
    L = B * M
    if cap is None:
        cap = min(L, max(256, 2 * L // ndev))
    route_mem = 4 * (L * 4 + L * 4 + ndev * cap * 3 + L * 4)
    route_link = 4 * (ndev - 1) * cap * 3
    t_loc = -(-T // ndev)
    h3_mem = 4 * (B * N + ndev * B * N + ndev * B * t_loc * 8 + B * (M + 1))
    h3_link = 4 * ((ndev - 1) * B * N + (ndev - 1) * B * (M + 1))
    cons_link = 4 * 4 * (ndev - 1)
    walk_mem = walk["bytes"]
    walk_link = 4 * 8 * walk["rounds"]
    out = {}
    for name, mem, link in (("route", route_mem, route_link), ("sharded_h3", h3_mem, h3_link),
                            ("consensus", 0, cons_link), ("walk", walk_mem, walk_link)):
        mem_ms, link_ms = mem / HBM_BYTES_PER_S * 1e3, link / NVLINK_BYTES_PER_S * 1e3
        out[name] = dict(mem_bytes=mem, link_bytes=link, mem_ms=mem_ms, link_ms=link_ms,
                         bound_ms=max(mem_ms, link_ms),
                         bound_by="bytes" if mem_ms >= link_ms else "link bytes")
    step = ("route", "sharded_h3", "consensus")
    out["step_bound_ms"] = sum(out[k]["bound_ms"] for k in step)
    out.update(ndev=ndev, B=B, M=M, cap=cap)
    print(f"  sharded step at kinase on {ndev} shards, a shard: route (L = {L}, cap "
          f"{cap}) {route_mem / 1e6:.2f} MB memory, {route_link / 1e6:.2f} MB sent, "
          f"{out['route']['bound_ms']:.5f} ms; sharded h3 {h3_mem / 1e6:.2f} MB, "
          f"{h3_link / 1e6:.2f} MB sent, {out['sharded_h3']['bound_ms']:.5f} ms; consensus "
          f"{cons_link} B sent; a step {out['step_bound_ms']:.5f} ms; batched walk "
          f"{walk_mem} B ({walk['rounds']} rounds, {walk['lookups']} lookups), "
          f"{out['walk']['bound_ms']:.6f} ms a run")
    return out


# the sharded step's kernels (parallel/sharded.py on a card), by layout:
# K3, the coordinates K12 gathers, K12, the sharded expand, K11's two
# passes, the insert; and the loop's (LOOP_KERNELS: the consensus and the
# exchange every step, walk_advance under the chunked driver's walk of
# rounds).  The walk: path_walk_shards once where the chunked driver's
# card form has one card, else K7's hop-limited mode a round a shard
LOOP_KERNELS = ["consensus", "exchange", "walk_advance"]
SHARDED_KERNELS = {
    "sig": ["select_best", "sig_coords", "tri_partial", "sig_expand_sharded", "route_count",
            "route_pack", "sig_probe"],
    "packed": ["select_best", "keyrow_coords", "tri_partial", "keyrow_expand_sharded",
               "route_count_rows", "route_pack_rows", "keyrow_insert_recv"],
    "unpacked": ["select_best_unpacked", "keyrow_expand_sharded", "route_count_rows",
                 "route_pack_rows", "keyrow_insert_recv"]}
# the plain versions a CUDA shard must never call (names in
# parallel/sharded.py's namespace)
PLAIN_SHARDED = ("route_plain", "tri_partial_plain", "sig_coords_plain",
                 "expand_sharded_plain", "walk_hops_plain", "_insert_sig",
                 "_select_best_plain", "_expand", "keyrow_coords_plain",
                 "expand_keyrow_sharded_plain", "insert_pending_plain", "finish_plain",
                 "_select_open_plain", "_insert_core", "_insert_core_packed",
                 "consensus_plain", "exchange_plain", "walk_advance_plain")


@contextlib.contextmanager
def sharded_guard(capture_step: int = 0):
    """Count the calls of the sharded engine's plain functions
    (PLAIN_SHARDED) made inside, keep every shard the run makes, and at
    step ``capture_step`` (> 0) copy the inputs and outputs of the shard
    that selected the most rows there (the lowest index on a tie)
    of each kernel of its step (sig_coords or keyrow_coords, K12, K4s or
    K9s, K11, and on key rows K10) into ``cap``, and the card's consensus
    and exchange of that step (their inputs and outputs: ``k6s_*``,
    ``x_*``).  The capture reads the card between kernels: it runs under
    the host driver."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import step as S

    calls = dict.fromkeys(PLAIN_SHARDED, 0)
    saved = {name: getattr(SH, name) for name in PLAIN_SHARDED}
    methods = {name: getattr(SH._Shard, name)
               for name in ("select", "coords", "partial", "expand", "count", "pack")}
    card_methods = {name: getattr(SH._Card, name) for name in ("consensus", "exchange")}
    cap = {"shards": [], "step": 0, "at": capture_step, "nsel_at": {}}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    def on(sh):
        if not capture_step or cap["step"] != capture_step:
            return False
        n = cap["nsel_at"]
        return sh.me == max(sorted(n), key=lambda me: n[me])

    def select(sh):
        if sh.me == 0:
            cap["step"] += 1
            cap["nsel_at"] = {}
        if not any(x is sh for x in cap["shards"]):
            cap["shards"].append(sh)
        out = methods["select"](sh)
        if capture_step and cap["step"] == capture_step:
            cap["nsel_at"][sh.me] = int(sh.bufs.state[2])
        return out

    def coords(sh):
        out = methods["coords"](sh)
        if on(sh):
            keys = sh.tab.t_sig if sh.layout == "sig" else sh.tab.t_key
            cap.update(shard=sh, coords=out.clone(), sel=sh.bufs.sel.clone(),
                       state_sel=sh.bufs.state.clone(),
                       **{"t_sig" if sh.layout == "sig" else "t_key": keys.clone()})
        return out

    def partial(sh, coords_g):
        out = methods["partial"](sh, coords_g)
        if on(sh):
            cap.update(coords_g=coords_g.clone(), part=out.clone())
        return out

    def expand(sh, eng, h3):
        if on(sh):
            cap.update(shard=sh, eng=eng, h3=None if h3 is None else h3.clone(),
                       sel=sh.bufs.sel.clone(), state0=sh.bufs.state.clone(),
                       ctr0=sh.ctr.clone())
            if sh.layout == "sig":
                cap.update(t_sig=sh.tab.t_sig.clone(), t_best0=sh.tab.t_best.clone())
            else:
                cap.update(tab0=clone_table(sh.tab))
        out = methods["expand"](sh, eng, h3)
        if on(sh):
            torch.cuda.synchronize()
            n_pend = int(sh.bufs.state[6])
            cap.update(cand=sh.cand.clone(), pend=sh.bufs.pend[sh.R:sh.R + n_pend].clone(),
                       state1=sh.bufs.state.clone(), ctr1=sh.ctr.clone())
            if sh.layout == "sig":
                cap.update(t_best1=sh.tab.t_best.clone())
            else:
                cap.update(tab1=clone_table(sh.tab))
        return out

    def count(sh, eng):
        if on(sh):
            cap.update(ring=sh.ring.clone(), cand_route=sh.cand.clone(),
                       nsel=int(sh.bufs.state[2]), ring_len=int(sh.ring_len[sh.cur]))
        return methods["count"](sh, eng)

    def pack(sh, eng, S_all):
        out = methods["pack"](sh, eng, S_all)
        if on(sh):
            torch.cuda.synchronize()
            cap.update(S=None if S_all is None else S_all.clone(), wire=sh.wire.clone(),
                       ring1=sh.ring.clone(), route_out=sh.route_out.clone(),
                       ring_len1=int(sh.ring_len[sh.cur]))
        return out

    def at_step() -> bool:
        return bool(capture_step) and cap["step"] == capture_step

    def targets(card):
        return [tuple(t.clone() for t in x[:4]) + (x[4],) for x in card.targets()]

    def consensus(card, eng):
        mine = at_step() and "k6s_tg0" not in cap
        if mine:  # the reports as the consensus reads them, where they lie
            cap.update(k6s_card=card, k6s_rep=[tuple(t.clone() for t in r)
                                               for r in card.reports],
                       k6s_run0=card.run.clone(), k6s_cons0=card.cons.clone(),
                       k6s_tg0=targets(card))
        card_methods["consensus"](card, eng)
        if mine:
            torch.cuda.synchronize()
            cap.update(k6s_run1=card.run.clone(), k6s_cons1=card.cons.clone(),
                       k6s_tg1=targets(card))

    def exchange(card, eng, shards):
        rank = at_step() and not eng.card_form  # the rank form: every rank's
        if rank:
            (sh,) = card.shards
            # the dense exchange's received blocks, or every rank's wire
            # where the ragged one reads it
            src = (dict(recv=card.recv.clone()) if card.recv is not None
                   else dict(wires=[w.clone() for w in card.wires]))
            cap.setdefault("xr", []).append(dict(
                cons=card.cons.clone(), pend0=sh.pend.clone(), go=sh.go.clone(), me=sh.me,
                R=sh.R, pw=sh.pw, **src))
        mine = at_step() and "x_pend0" not in cap
        if mine:
            cap.update(x_cons=card.cons.clone(), x_wires=[sh.wire.clone() for sh in shards],
                       x_pend0=[sh.pend.clone() for sh in card.shards],
                       x_flags=[sh.go.clone() for sh in card.shards],
                       x_me=[sh.me for sh in card.shards], x_R=shards[0].R, x_pw=shards[0].pw)
        card_methods["exchange"](card, eng, shards)
        if rank:
            torch.cuda.synchronize()
            cap["xr"][-1]["pend1"] = card.shards[0].pend.clone()
        if mine:
            torch.cuda.synchronize()
            cap.update(x_pend1=[sh.pend.clone() for sh in card.shards])

    insert = S.insert_pending_cuda

    def insert_pending(st, tab, bufs, ctr, fill, pend_at, recv, **kw):
        mine = "shard" in cap and on(cap["shard"]) and tab is cap["shard"].tab
        if mine:
            n, n_front = int(bufs.state[6]), int(recv[0])
            at = pend_at - n_front
            cap.update(k10_tab0=clone_table(tab), k10_ctr0=ctr.clone(),
                       k10_state0=bufs.state.clone(), k10_rows=bufs.pend[at:at + n].clone(),
                       k10_pend_at=pend_at, k10_recv=recv.clone(), n_front=n_front, fill=fill)
        insert(st, tab, bufs, ctr, fill, pend_at, recv, **kw)
        if mine:
            torch.cuda.synchronize()
            cap.update(k10_tab1=clone_table(tab), k10_ctr1=ctr.clone(),
                       k10_state1=bufs.state.clone())

    for name, fn in saved.items():
        setattr(SH, name, counted(name, fn))
    for name, fn in (("select", select), ("coords", coords), ("partial", partial),
                     ("expand", expand), ("count", count), ("pack", pack)):
        setattr(SH._Shard, name, fn)
    SH._Card.consensus, SH._Card.exchange = consensus, exchange
    S.insert_pending_cuda = insert_pending
    try:
        yield calls, cap
    finally:
        for name, fn in saved.items():
            setattr(SH, name, fn)
        for name, fn in methods.items():
            setattr(SH._Shard, name, fn)
        for name, fn in card_methods.items():
            setattr(SH._Card, name, fn)
        S.insert_pending_cuda = insert


@contextlib.contextmanager
def walk_edges():
    """Count, for each walk_advance launch captured into a graph inside,
    the node's incoming edges (utils/graph.py::last_node_edges: the
    predecessor's node type and whether the edge is programmatic), keyed
    "type:kind" joined by "+" over its edges; yields (the Counter, [the
    host seconds of the reads]: they run inside the walk's capture, whose
    wall includes them)."""
    from collections import Counter

    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.utils.graph import last_node_edges

    seen, spent, cuda_fn = Counter(), [0.0], SH.walk_advance_cuda

    def recorded(*args, **kw):
        cuda_fn(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            t0 = time.perf_counter()
            edges = last_node_edges(torch.cuda.current_stream())
            seen["+".join(sorted(f"{t}:{k}" for t, k, _ in edges))] += 1
            spent[0] += time.perf_counter() - t0

    SH.walk_advance_cuda = recorded
    try:
        yield seen, spent
    finally:
        SH.walk_advance_cuda = cuda_fn


def shard_bytes(sh) -> int:
    """Device bytes a shard holds: its table, counters, rings, cubes and
    step buffers."""
    seen, total = set(), 0

    def add(t):
        nonlocal total
        if isinstance(t, torch.Tensor) and t.is_cuda and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()

    for t in (*(getattr(sh.tab, f) for f in sh.tab.__dataclass_fields__), sh.ctr, *sh.rings,
              sh.cubes, sh.tri, getattr(sh, "cand", None), getattr(sh, "keys", None),
              getattr(sh, "wire", None), getattr(sh, "route_out", None), sh.recv, sh.go,
              getattr(sh, "coords_out", None), getattr(sh, "part", None)):
        add(t)
    for f in ("slots", "vmin", "active", "state", "sel", "partial", "ticket", "run", "pend",
              "lane_cur", "lane_dest", "lane_word", "tail", "params"):
        add(getattr(sh.bufs, f, None))
    return total


def sharded_run(label: str, path: str, gold: dict, devices, want_identical: bool,
                capture_step: int = 0, profile: bool = False, eng=None, **kw) -> dict:
    """One ShardedFrontierSearch run (the engine entry) on ``devices`` (or
    of ``eng``, an engine made before): the golden g, path cost g
    (attach_path_g), degapped rows; every sharded step kernel of its layout
    launched (SHARDED_KERNELS: K3, the coordinates and K12 where the cubes
    are split, the sharded expand, K11's passes, the insert; LOOP_KERNELS:
    the consensus and the exchange; the walk: where the chunked driver's
    card form has one card path_walk_shards once and one read, its masks
    and rounds the host walk's on the finished tables, else K7's hop mode
    a round a shard and, under the chunked driver, walk_advance) and no
    plain version; under the chunked driver
    two step graphs captured (one a ring parity), ``chunk_steps`` replays
    and one host read a chunk; the layout, the capacity it
    started at and reached and any overflow retry; the step's wall (with
    and without the graph's capture), host reads, wire and migrated rows,
    peak carry, walk rounds, reads and wall, peak memory per shard and in
    total."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.parallel.sharded import ShardedFrontierSearch
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment

    problem = problem_from_fasta(path)
    gc.collect()  # an earlier run's shards and captures, before the peak is reset
    n_cards = torch.cuda.device_count()
    for i in range(n_cards):
        torch.cuda.synchronize(i)
        torch.cuda.reset_peak_memory_stats(i)
    _kernels.reset_counts()
    t0 = time.perf_counter()
    with sharded_guard(capture_step) as (plain, cap), walk_edges() as (edges, edges_s):
        if eng is None:
            eng = ShardedFrontierSearch(problem, devices=devices, **kw)
        capacity0 = eng.st.C
        build_s = time.perf_counter() - t0
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx

            with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                res = eng.run()
                torch.cuda.synchronize()
        else:
            res = eng.run()
        torch.cuda.synchronize()
        for i in range(n_cards):
            torch.cuda.synchronize(i)
    wall = time.perf_counter() - t0
    counts = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    peaks = [torch.cuda.max_memory_allocated(i) for i in range(n_cards)]
    if res.g != gold["optimal_g"]:
        fail(f"{label}: g={res.g}, want {gold['optimal_g']}")
    alignment = build_alignment(problem, res.closed)
    identical = check_alignment(label, alignment, gold, want_identical)
    if any(plain.values()):
        fail(f"{label}: plain versions ran on the card: {plain}")
    st = eng.last_stats
    wire_path = not (eng.ndev == 1 and eng.exchange == "dense")
    chunked = st["driver"] == "chunked"
    # the rank form's ragged exchange is sized on the host where the mesh
    # maps no peer's wire (cards without peer access)
    # the chunked driver's walk on one card is one launch of
    # path_walk_shards and one read; elsewhere rounds of K7's hop mode (and
    # walk_advance under the chunked driver)
    one_launch = wire_path and st.get("walk_form") == "launch"
    if chunked and wire_path and one_launch != (st.get("card_form") and st.get("cards") == 1):
        fail(f"{label}: the walk's form {st.get('walk_form')} on {st.get('cards')} card(s)")
    walk_kernels = ["path_walk_shards"] if one_launch else ["path_walk_hops"] + (
        ["walk_advance"] if chunked else [])
    want = [k for k in SHARDED_KERNELS[eng.layout] + LOOP_KERNELS[:2] + walk_kernels
            if (eng.cubes_split or k not in ("sig_coords", "keyrow_coords", "tri_partial"))
            and (st.get("card_form") or eng.exchange == "dense" or eng.wires is not None
                 or k != "exchange")]
    if wire_path:
        for k in want:
            if counts.get(k, 0) <= 0:
                fail(f"{label}: kernel {k} was not launched on the sharded path")
        # the chunked walk of rounds: a warm-up round, then WALK_ROUNDS
        # replays of the one-round graph a host read
        from mpi_pastar_msa_tpu_torch.parallel.sharded import WALK_ROUNDS

        walk_launches = ((st["walk_reads"] * WALK_ROUNDS + 1) * eng.ndev if chunked
                         else st["walk_rounds"] * eng.ndev)
        if one_launch and (counts["path_walk_shards"], counts["path_walk_hops"],
                           counts["walk_advance"], st["walk_reads"]) != (1, 0, 0, 1):
            fail(f"{label}: the one-launch walk launched path_walk_shards "
                 f"{counts['path_walk_shards']} times, K7 hop mode {counts['path_walk_hops']}, "
                 f"walk_advance {counts['walk_advance']}, in {st['walk_reads']} reads")
        if not one_launch and counts["path_walk_hops"] != walk_launches:
            fail(f"{label}: K7 hop mode launched {counts['path_walk_hops']} times for "
                 f"{st['walk_rounds']} rounds ({st['walk_reads']} reads) on {eng.ndev} shards")
        if one_launch:
            # the one launch's masks and rounds again on the finished
            # tables, against the host walk in rounds
            host_walk = eng._walk(eng.shards)
            got = eng._walk_loop(eng.shards, form="launch")
            if got[:2] != host_walk or got[1] != st["walk_rounds"]:
                fail(f"{label}: the one-launch walk's {len(got[0])} masks in {got[1]} rounds "
                     f"(the run's {st['walk_rounds']}) differ from the host walk's "
                     f"{len(host_walk[0])} in {host_walk[1]}")
        if chunked and not (st["graph_captures"] == 2
                            and st["graph_replays"] == st["host_reads"] * eng.chunk_steps
                            and st["host_reads"] == -(-st["steps"] // eng.chunk_steps)):
            fail(f"{label}: {st['graph_captures']} step graphs captured, "
                 f"{st['graph_replays']} graph replays and {st['host_reads']} host reads for "
                 f"{st['steps']} steps in chunks of {eng.chunk_steps}")
    if any(d.type != "cuda" for d in eng.local_devices):
        fail(f"{label}: a shard is not on a card: {eng.local_devices}")
    shards = cap["shards"]
    cap["path"] = list(res.closed)
    steps = max(st["steps"], 1)
    info = dict(g=res.g, identical=identical, ndev=eng.ndev, devices=[str(d) for d in devices],
                layout=eng.layout, exchange=eng.exchange, exchange_cap=eng.exchange_cap,
                hash=eng.hash_type, shard_cubes=eng.shard_cubes, cubes_split=eng.cubes_split,
                capacity=eng.st.C, capacity_start=capacity0, retries=eng.retries,
                batch=eng.st.B,
                steps=res.steps, expanded=res.nodes_expanded, reopened=res.nodes_reopened,
                migrated=res.nodes_migrated, shard_stats=res.shard_stats,
                driver=st["driver"], host_reads=st["host_reads"],
                host_reads_a_step=st["host_reads"] / steps,
                graph_captures=st.get("graph_captures", 0),
                graph_replays=st.get("graph_replays", 0), capture_s=st.get("capture_s", 0.0),
                capture_parts={k: st[k] for k in ("capture_warm_s", "capture_host_s",
                                                  "capture_instantiate_s") if k in st},
                step_wall_no_capture_ms=(st["search_s"] - st.get("capture_s", 0.0)) / steps * 1e3,
                replay_ms_a_step=st.get("replay_s", 0.0) / steps * 1e3,
                read_ms_a_step=st.get("read_s", 0.0) / steps * 1e3,
                walk_reads=st["walk_reads"],
                wire_rows_a_step=st["wire_rows"] / steps,
                migrated_a_step=st["migrated"] / steps, peak_carry=st["peak_carry"],
                walk_rounds=st["walk_rounds"], walk_s=st["walk_s"],
                walk_form=st.get("walk_form"),
                walk_parts={k: st[k] for k in ("walk_warm_s", "walk_capture_s") if k in st},
                search_s=st["search_s"], step_wall_ms=st["search_s"] / steps * 1e3,
                engine_build_s=build_s, wall_s=wall, launches=counts,
                peak_device_bytes=peak, peak_bytes_a_card=peaks, cards=st.get("cards", 1),
                card_form=st.get("card_form", False), walk_edges=dict(edges),
                walk_edges_s=edges_s[0],
                shard_bytes=[shard_bytes(sh) for sh in shards] if wire_path else None,
                path_nodes=len(res.closed))
    if edges and len({c.dev for c in eng.cards}) > 1 and set(edges) != {"empty:full"}:
        fail(f"{label}: walk_advance's edges in the captured round {dict(edges)}, want one "
             f"full edge from the join after the runs of several cards")
    if profile:
        events = [e for e in prof.key_averages() if e.count]
        dev_us = sum(e.device_time_total for e in events if own_event(e.key))
        info["step_device_ms"] = dev_us / 1e3 / steps
        # each kernel's device us a step (its name as CUPTI gives it)
        info["step_kernels_us"] = {e.key: e.device_time_total / steps for e in events
                                   if own_event(e.key) and e.device_time_total > 0}
        # with PyTorch's own kernels of the step (the gathers' stack, the
        # reports' cat, the reduce-scatter's sum), not its host ops
        all_us = sum(e.device_time_total for e in events
                     if not e.key.startswith(("aten::", "cuda", "Memcpy")))
        info["step_device_all_ms"] = all_us / 1e3 / steps
    print(f"{label}: {eng.ndev} shard(s) on {info['devices']} ({info['cards']} card(s), "
          f"{'card' if info['card_form'] else 'rank'} form), layout {eng.layout}, exchange "
          f"{eng.exchange} (cap {eng.exchange_cap}), hash {eng.hash_type}, cubes split "
          f"{eng.cubes_split}, capacity {eng.st.C} a shard (started at {capacity0}; overflow "
          f"retries {eng.retries or 'none'}), batch {eng.st.B}; g={res.g} ok, path cost == g, "
          f"alignment byte-identical to golden: {identical}; steps {res.steps}, expanded "
          f"{res.nodes_expanded}, migrated {res.nodes_migrated}; driver {st['driver']} "
          f"({info['graph_replays']} graph launches, {info['graph_captures']} captures in "
          f"{info['capture_s']:.3f} s: {info['capture_parts']}); a step: wall "
          f"{info['step_wall_ms']:.3f} ms "
          f"({info['step_wall_no_capture_ms']:.3f} without the capture"
          + (f"; the replays' launches {info['replay_ms_a_step']:.3f}, the reads "
             f"{info['read_ms_a_step']:.3f} on the host" if chunked else "") + ")"
          + (f", device {info['step_device_ms']:.3f} ms (with PyTorch's kernels "
             f"{info['step_device_all_ms']:.3f})" if profile else "")
          + f", host reads {info['host_reads_a_step']:.4f}, wire rows "
          f"{info['wire_rows_a_step']:.1f}, migrated {info['migrated_a_step']:.1f}; peak carry "
          f"{st['peak_carry']}; walk ({st.get('walk_form')}) {st['walk_rounds']} rounds "
          f"({st['walk_reads']} host reads) in {st['walk_s'] * 1e3:.2f} ms"
          + (f" (warm-up round {st['walk_warm_s'] * 1e3:.2f}, capture "
             f"{st['walk_capture_s'] * 1e3:.2f})" if "walk_warm_s" in st else "")
          + (f", walk_advance's edges in the captured round {dict(edges)} (read in "
             f"{edges_s[0] * 1e3:.2f} ms of the capture)" if edges else "")
          + "; "
          f"peak memory {peak / 2**20:.1f} MiB"
          + (f" (cards {[round(b / 2**20, 1) for b in peaks]} MiB)" if n_cards > 1 else "")
          + (f" (shards {[round(b / 2**20, 1) for b in info['shard_bytes']]} MiB)"
             if info["shard_bytes"] else "")
          + "; launches " + str({k: counts[k] for k in SHARDED_KERNELS[eng.layout]
                                 + LOOP_KERNELS + ["path_walk_hops", "path_walk_shards",
                                                   "path_walk"]}))
    return info, eng, cap


def sharded_walk_bytes(st, shards, final, layout: str = "sig") -> dict:
    """The bytes the sharded walk (_make_batched_walk) must move on this
    run's tables: each round every shard walks at most WALK_HOPS hops from
    the round's coordinate (walk_bytes: the shard that holds it reads its
    hits' rows and the stopping miss, every other shard one miss), and the
    summed run advances the coordinate, until the origin."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    K, c = SH.WALK_HOPS, np.asarray(final, dtype=np.int64)
    nbytes = lookups = rounds = 0
    while c.any():
        rounds += 1
        moved = None
        for shd in shards:
            wb = walk_bytes(st, shd.tab, layout, c, K, K + st.n + 1)
            nbytes, lookups = nbytes + wb["bytes"], lookups + wb["lookups"]
            run = SH.walk_hops_plain(st, shd.tab, c, K, layout)
            if int(run[-1]):
                moved = run[K: K + st.n].numpy().astype(np.int64)
        if moved is None:
            fail(f"sharded walk: no shard holds {c.tolist()}")
        c = moved
    return dict(bytes=nbytes, lookups=lookups, rounds=rounds)


def k11_bitonic_stages(n: int) -> int:
    """The barrier stages of the block bitonic K11 sorted with up to
    commit c408a21 (its route_pack.cu) for a segment of n keys, by that
    source's loop bounds, not measured: log2(np2)(log2(np2) + 1) / 2, np2
    the power of two at or above n (besides a barrier after its load and
    one before its reduction)."""
    lg = max(n - 1, 0).bit_length()
    return lg * (lg + 1) // 2


# the C entries' form of K11 in this tree: "v2" (each ring's live length
# beside it, the counts in two buffers that alternate, no zero launch);
# "v1" (from 91dece6 to b8321dc: route_count zeroes out in a launch of its
# own, route_pack writes the whole ring); "v0" (c408a21's: v1 without the
# run flag)
K11_API = "v2"


class K11Run:
    """One build of K11 on fixed inputs (``inp``: cand, carry, n_lanes, M,
    ndev, me, cap, S or None, seg, and for key rows ``fill``, the empty
    row: then the C entries route_count_rows and route_pack_rows; on the
    form "v2" ``carry_len``, the carry's live length, by default all its
    rows), with outputs of its own (a new ring of unknown contents: its
    word Ccar): count() and pack() each call one C entry, call() both; on
    "v2" each count() takes the other of the two count buffers, which the
    last count zeroed, and pack() the last count's.  ``fns`` is another
    build's C entries (load_k11_baseline, load_k11_barriers,
    load_k11_phases) and their form under "api"; by default this tree's,
    through _kernels.launch."""

    def __init__(self, inp: dict, fns=None):
        from mpi_pastar_msa_tpu_torch import _kernels

        cand, carry, ndev, cap = inp["cand"], inp["carry"], inp["ndev"], inp["cap"]
        dev = cand.device
        lanes_cap, ccar, M = cand.shape[0], carry.shape[0], inp["M"]
        fill = inp.get("fill")
        self.api = K11_API if fns is None else fns.get("api", K11_API)
        i32 = dict(dtype=torch.int32, device=dev)
        self.nsel = torch.tensor(inp["n_lanes"] // M, dtype=torch.int64, device=dev)
        self.out = torch.empty(ndev + 3, **i32)
        self.keys = torch.empty(2 * ndev * inp["seg"], dtype=torch.int64, device=dev)
        self.wire = torch.zeros((max(ndev * cap, lanes_cap + ccar),
                                 3 if fill is None else cand.shape[1] - 2), **i32)
        self.ring = torch.empty_like(carry)
        self.counts = torch.zeros((2, ndev + 1), **i32)
        self.carry_len = torch.tensor([inp.get("carry_len", ccar)], **i32)
        self.ring_len = torch.tensor([ccar], **i32)
        self.parity = 1  # the first count takes buffer 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        S = None if inp["S"] is None else inp["S"].data_ptr()
        # key rows: the row's words, its key words (the empty row's -1s)
        # and the empty fsort
        rows = () if fill is None else (cand.shape[1], fill[2:].count(-1), fill[1])
        self.names = (("route_count", "route_pack") if fill is None
                      else ("route_count_rows", "route_pack_rows"))
        c, r, nsel = cand.data_ptr(), carry.data_ptr(), self.nsel.data_ptr()
        o, k, w, ring = (t.data_ptr() for t in (self.out, self.keys, self.wire, self.ring))
        seg, me = inp["seg"], inp["me"]
        if self.api == "v2":
            cnt = [self.counts[p].data_ptr() for p in (0, 1)]
            self.args = [{
                self.names[0]: (c, r, self.carry_len.data_ptr(), nsel, M, lanes_cap, ccar, ndev,
                                seg, *rows, cnt[p], cnt[1 - p], o, k, None, stream),
                self.names[1]: (c, r, nsel, M, ccar, ndev, me, cap, S, seg, *rows, cnt[p], o, k,
                                w, ring, self.ring_len.data_ptr(), None, stream)}
                for p in (0, 1)]
        else:
            run = () if self.api == "v0" else (None,)
            self.args = [{
                self.names[0]: (c, r, nsel, M, lanes_cap, ccar, ndev, seg, *rows, o, k, *run,
                                stream),
                self.names[1]: (c, r, nsel, M, ccar, ndev, me, cap, S, seg, *rows, o, k, w, ring,
                                *run, stream)}] * 2
        self.fns = fns
        self.launch = _kernels.launch

    def _go(self, name):
        args = self.args[self.parity][name]
        if self.fns is None:
            self.launch(name, *args)
        elif self.fns[name](*args):
            fail(f"{name} of {self.fns['src']} failed to launch")

    def count(self):
        self.parity = 1 - self.parity
        self._go(self.names[0])

    def pack(self):
        self._go(self.names[1])

    def call(self):
        self.count()
        self.pack()


def k11_sent_sizes(inp: dict, p_out):
    """The rows this shard sends each destination (route_sizes), from the
    plain version's counts."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    ndev = inp["ndev"]
    S = (inp["S"].cpu().numpy() if inp["S"] is not None
         else p_out[:ndev].long().repeat(ndev, 1).cpu().numpy())
    return SH.route_sizes(S, ndev, inp["cap"], inp["S"] is not None)[inp["me"]]


def k11_check(label: str, inp: dict, run: "K11Run"):
    """One call of ``run`` against route_plain on the same inputs, bit for
    bit: out (counts, migrants, carry overflow, ring min), the new ring and
    the wire rows sent.  Returns the plain version's out."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    run.call()
    torch.cuda.synchronize()
    ndev = inp["ndev"]
    p_wire, p_ring, p_out = SH.route_plain(inp["cand"], inp["n_lanes"], inp["carry"], ndev,
                                           inp["me"], inp["cap"], inp["S"], inp.get("fill"))
    A = k11_sent_sizes(inp, p_out)
    base = np.cumsum(A) - A if inp["S"] is not None else np.arange(ndev) * inp["cap"]
    sent = torch.cat([torch.arange(int(b), int(b) + int(a)) for a, b in zip(A, base)]
                     ).long().to(run.out.device)
    bad = []
    if not torch.equal(run.out, p_out):
        bad.append(f"out {run.out.tolist()} vs {p_out.tolist()}")
    if not torch.equal(run.ring, p_ring):
        bad.append("new ring")
    if not torch.equal(run.wire[sent], p_wire[sent]):
        bad.append("wire rows")
    if run.api == "v2" and int(run.ring_len) != int((p_ring[:, 0] < ndev).sum()):
        bad.append(f"the new ring's word {int(run.ring_len)}")
    if bad:
        fail(f"{label} differs from its plain version: {bad}")
    return p_out


def k11_barriers(count: dict, inp: dict, label: str) -> list:
    """Each destination's block barriers in route_pack's sort on ``inp``,
    counted by the K11_BARRIERS build (``count``, load_k11_barriers), whose
    route is checked against route_plain too."""
    run = K11Run(inp, count)
    k11_check(f"K11 ({label}, the K11_BARRIERS build)", inp, run)
    return count["barriers"](inp["ndev"])


def k11_turns(inp: dict, baseline: dict, label: str, reps: int = 20) -> dict:
    """Device ms (CUPTI) of each pass alone and of the call, and the call's
    wrapper ms (CUDA events), another tree's K11 (``baseline``) and this
    one in turns on ``inp``: old, new, new, old; both through a plain
    ctypes call of their C entries."""
    from mpi_pastar_msa_tpu_torch import _kernels

    names = (("route_count", "route_pack") if inp.get("fill") is None
             else ("route_count_rows", "route_pack_rows"))
    this = {"src": "this tree", "api": K11_API,
            **{n: getattr(_kernels.load(n), n) for n in names}}
    who = {"old": K11Run(inp, baseline), "new": K11Run(inp, this)}
    res = {k: {"old": [], "new": []} for k in (*names, "call", "call_wrapper")}
    for w in ("old", "new", "new", "old"):
        r = who[w]
        res[names[0]][w].append(device_ms(r.count, reps))
        r.count()  # pass 2 alone reads pass 1's counts and keys
        res[names[1]][w].append(device_ms(r.pack, reps))
        res["call"][w].append(device_ms(r.call, reps))
        res["call_wrapper"][w].append(time_ms(r.call, reps))
    print(f"    K11 in turns with {baseline['src']} ({label}; old, new, new, old): " + "; ".join(
        f"{k} {res[k]['old'][0]:.4f} / {res[k]['new'][0]:.4f} / {res[k]['new'][1]:.4f} / "
        f"{res[k]['old'][1]:.4f} ms" for k in res))
    return res


def k11_split(inp: dict, fns: dict, reps: int = 20) -> dict:
    """K11's split on ``inp``: the K11_PHASES build (``fns``,
    load_k11_phases) called once, then its call captured in a CUDA graph
    for each of its two count buffers, as the step graphs hold it, the two
    replayed in turns ``reps`` times in all, each replay's %globaltimer
    readings read.  Medians in microseconds: the zero launch
    (its start to count block 0's start; absent where there is none), the
    count (block 0's start to the last block's end) and block 0's span, on
    to the pack's first block, the sorting block of the destination with
    the most keys (its allowance; its sort from its start, and of it the
    keys' load by warp 0, every warp's network, the merge rounds; its
    copy), the
    ring tail's first block (its allowance, its fill), the pack (first
    block's start to last block's end) and the whole call; ``dest`` names
    that destination and ``keys`` its keys."""
    p_out = k11_plain_out(inp)
    ndev = inp["ndev"]
    d = max(range(min(ndev, 8)), key=lambda q: int(p_out[q]))
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        run = K11Run(inp, fns)
        run.call()
    torch.cuda.synchronize()
    graphs = [torch.cuda.CUDAGraph() for _ in range(2)]
    for graph in graphs:
        with torch.cuda.graph(graph, stream=s):
            run.call()
    torch.cuda.synchronize()
    fns["phases"]()
    spans = {}
    b, t0 = K11_STAMP_SORT + 6 * d, K11_STAMP_TAIL
    for rep in range(reps):
        graphs[rep % 2].replay()
        torch.cuda.synchronize()
        t = fns["phases"]()
        got = {"count_us": t[3] - t[1], "count_block0_us": t[2] - t[1],
               "to_pack_us": t[4] - t[3], "pack_us": t[5] - t[4],
               "call_us": t[5] - (t[0] or t[1]),
               "tail_allowance_us": t[t0 + 1] - t[t0], "tail_fill_us": t[t0 + 2] - t[t0 + 1]}
        if t[0]:
            got["zero_us"] = t[1] - t[0]
        if t[b + 5]:
            got.update(to_block_us=t[b] - t[4], allowance_us=t[b + 1] - t[b],
                       sort_us=t[b + 4] - t[b], load_us=t[b + 2] - t[b],
                       copy_us=t[b + 5] - t[b + 4])
            if t[b + 3]:  # a segment of more than a warp's run: merge rounds
                got.update(networks_us=t[b + 3] - t[b + 2], merges_us=t[b + 4] - t[b + 3])
        for k, v in got.items():
            spans.setdefault(k, []).append(v / 1e3)
    del graphs
    out = {k: statistics.median(v) for k, v in spans.items()}
    # whether its keys sort as 32 bits: their fsorts' spread within the
    # segment's position bits (route_pack.cu's sort_small)
    rows = torch.cat([inp["cand"][:inp["n_lanes"]],
                      inp["carry"][:inp.get("carry_len", inp["carry"].shape[0])]])
    f = rows[rows[:, 0] == d, 1].long()
    spread = int(f.max() - f.min())
    pb = inp["seg"].bit_length() - 1
    out.update(dest=d, keys=int(p_out[d]), spread=spread,
               narrow=(spread << pb) + inp["seg"] <= 0xFFFFFFFF)
    print(f"    K11 split ({reps} graph replays, median us; destination {d}, {int(p_out[d])} "
          f"keys, fsort spread {spread}, 32-bit keys {out['narrow']}): " + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in out.items()
                                 if k.endswith("_us")))
    return out


def k11_plain_out(inp: dict):
    """route_plain's out on ``inp``."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    return SH.route_plain(inp["cand"], inp["n_lanes"], inp["carry"], inp["ndev"], inp["me"],
                          inp["cap"], inp["S"], inp.get("fill"))[2]


def k11_sort_yardstick(inp: dict, run: "K11Run") -> dict:
    """torch.sort of the largest segment's int64 keys as route_count left
    them in ``run`` (a yardstick of the sort phase; the port never calls
    it): wrapper ms (CUDA events) and device ms (CUPTI, PyTorch's kernels)."""
    p_out = k11_plain_out(inp)
    d = max(range(inp["ndev"]), key=lambda q: int(p_out[q]))
    n = int(p_out[d])
    run.count()
    seg = run.keys[d * inp["seg"]:d * inp["seg"] + n].clone()
    ms = time_ms(lambda: torch.sort(seg), 20)
    dev = device_ms(lambda: torch.sort(seg), 20,
                    keep=lambda k: (not k.startswith(("aten::", "cuda", "Memcpy"))
                                    and "spin_kernel" not in k))
    print(f"    torch.sort of destination {d}'s {n} int64 keys: wrapper {ms:.4f} ms, device "
          f"{dev:.4f} ms")
    return dict(keys=n, ms=ms, device_ms=dev)


def start_k11_baseline(src: str, tmp: str):
    """Start nvcc on another tree's K11 (``src``: its route_pack.cu, or a
    checkout's root or csrc/ directory; the C entries route_count and
    route_pack of this tree's signatures less the run flag) in its own
    directory; returns
    (src, proc, lib)."""
    import shutil

    from mpi_pastar_msa_tpu_torch import _kernels

    cu = src if os.path.isfile(src) else next(
        p for p in (os.path.join(src, "route_pack.cu"),
                    os.path.join(src, "mpi_pastar_msa_tpu_torch", "csrc", "route_pack.cu"))
        if os.path.isfile(p))
    out = os.path.join(tmp, "k11_baseline")
    os.makedirs(out, exist_ok=True)
    shutil.copy(cu, out)
    lib = os.path.join(out, "libroute_pack.so")
    proc = subprocess.Popen(
        [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", lib, os.path.join(out, "route_pack.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return src, proc, lib


# the C entries of K11's form "v1" (up to b8321dc; "v0", c408a21's, the
# sig entries without the run flag)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
K11_V1_SIGNATURES = {
    "route_count": [_P, _P, _P, _I, _I, _I, _I, _L, _P, _P, _P, _P],
    "route_pack": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _L, _P, _P, _P, _P, _P, _P],
    "route_count_rows": [_P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _P, _P, _P, _P],
    "route_pack_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _L, _I, _I, _I, _P, _P, _P, _P,
                        _P, _P]}


def load_k11_baseline(job) -> dict:
    """The other tree's K11 (start_k11_baseline): its C entries (the key
    rows' too where its source has them) and their form under ``api``,
    told from its source ("v1" when route_count takes the run flag, "v0"
    before), and its source's name under ``src``."""
    import re

    src, proc, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"K11 baseline: nvcc failed for route_pack.cu of {src}:\n{log}")
    with open(os.path.join(os.path.dirname(lib), "route_pack.cu")) as f:
        text = f.read()
    head = re.search(r'extern "C" int route_count\((.*?)\)', text, re.S).group(1)
    api = "v1" if "run" in head else "v0"
    dll = ctypes.CDLL(lib)
    fns = {"src": src, "api": api}
    for name, sig in K11_V1_SIGNATURES.items():
        if f'extern "C" int {name}(' not in text:
            continue
        fn = getattr(dll, name)
        fn.argtypes = sig if api == "v1" else sig[:-2] + sig[-1:]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


# the segment sizes of --k11-sweep, rows a destination: kinase's step 200
# (636) and up to a whole shard's rows (lanes_cap + ccar = 31,744)
K11_SWEEP = (64, 636, 4096, 8192, 16384, 31744)


# kinase's key words (W) and each key-row layout's empty fsort
K11_W = 3
K11_LAYOUTS = ("sig", "packed", "unpacked")


def k11_fill(layout: str, ndev: int):
    """The empty ring row of ``layout`` at W = K11_W (None on sig rows:
    route_plain's default), as sharded.keyrow_fill gives it."""
    from mpi_pastar_msa_tpu_torch.search.engine import INF

    if layout == "sig":
        return None
    pw = K11_W + (4 if layout == "packed" else 5)
    return [ndev, 0x7FFFFFFF if layout == "packed" else INF] + [-1] * K11_W + [0] * (pw - K11_W)


# the spread of the synthetic rows' fsort: about kinase's (its median
# spread of a destination's fsorts a step, packed, is about 41,000)
K11_F_RANGE = 1 << 15


def k11_rows(dest, fill, g, ndev: int):
    """Rows (dest, fsort, payload) on the card for the int32 ``dest``s: a
    remote row's fsort below K11_F_RANGE and its payload random from ``g``
    (sig: home, sig; key rows: random words), every other row the empty
    one (``fill``, or sig's)."""
    dev = dest.device
    empty = [ndev, 0x7FFFFFFF, 0, -1] if fill is None else fill
    rows = torch.tensor(empty, dtype=torch.int32, device=dev).repeat(dest.numel(), 1)
    live = dest < ndev
    k = int(live.sum())
    rows[:, 0] = dest
    rows[live, 1] = torch.randint(0, K11_F_RANGE, (k,), generator=g, device=dev).int()
    if fill is None:
        rows[live, 2] = torch.randint(0, 1 << 20, (k,), generator=g, device=dev).int()
        rows[live, 3] = torch.randint(0, 1 << 30, (k,), generator=g, device=dev).int()
    else:
        rows[live, 2:] = torch.randint(-2**31, 2**31 - 1, (k, rows.shape[1] - 2), generator=g,
                                       device=dev).int()
    return rows


def k11_synthetic(n: int, ndev: int = 4, cap: int = 7936, ccar: int = 15872, M: int = 31,
                  seed: int = 0, layout: str = "sig") -> dict:
    """K11's inputs at kinase's shapes on 4 shards (shard 0, cap 7,936, a
    ring of 15,872 rows, M = 31) with n rows for each other destination:
    a quarter of them (at most half the ring) live in the carry ring (its
    first rows: ``carry_len``), the rest among the lanes with n / 2 lanes
    that stay; rows of ``layout`` (sig: 4 words; packed and unpacked key
    rows of 2 + W + 4 and 2 + W + 5 words at kinase's W = 3, ``fill``
    their empty row), f and payload random from ``seed`` on the card; the
    ragged send counts as if every shard sent alike."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    fill = k11_fill(layout, ndev)
    dest = torch.arange(1, ndev, device=dev).repeat_interleave(n).int()
    dest = dest[torch.randperm(dest.numel(), generator=g, device=dev)]
    in_ring = min(ccar // 2, dest.numel() // 4)
    lanes = torch.cat([dest[in_ring:], torch.full((n // 2,), ndev, dtype=torch.int32,
                                                  device=dev)])
    lanes = lanes[torch.randperm(lanes.numel(), generator=g, device=dev)]
    n_lanes = -(-lanes.numel() // M) * M
    cand_dest = torch.full((n_lanes,), ndev, dtype=torch.int32, device=dev)
    cand_dest[:lanes.numel()] = lanes
    ring_dest = torch.full((ccar,), ndev, dtype=torch.int32, device=dev)
    ring_dest[:in_ring] = dest[:in_ring]
    counts = torch.bincount(dest.long(), minlength=ndev)[:ndev].int()
    return dict(cand=k11_rows(cand_dest, fill, g, ndev), carry=k11_rows(ring_dest, fill, g, ndev),
                n_lanes=n_lanes, M=M, ndev=ndev, me=0, cap=cap,
                S=counts.repeat(ndev, 1).contiguous(),
                seg=1 << (n_lanes + ccar - 1).bit_length(), fill=fill, carry_len=in_ring)


def k11_sweep(count: dict, baseline=None) -> dict:
    """K11 at each segment size of K11_SWEEP (k11_synthetic, ragged) on sig
    rows and on packed and unpacked key rows: checked against route_plain,
    then the device ms of each pass alone and of the call, in turns with
    another tree's K11 (checked too) when there is one; a destination's
    sort barriers, counted by the K11_BARRIERS build (``count``), and
    c408a21's bitonic stages by its loop bounds; then the rings shrinking
    and growing on two buffers (k11_ping_pong)."""
    out = {}
    for layout in K11_LAYOUTS:
        print(f"K11 sweep (kinase's shapes, 4 shards, ragged, {layout} rows; n rows a "
              f"destination):")
        for n in K11_SWEEP:
            inp = k11_synthetic(n, layout=layout)
            run = K11Run(inp)
            k11_check(f"K11 (sweep, {layout}, n = {n})", inp, run)
            row = dict(n=n, rows=inp["n_lanes"] + inp["carry"].shape[0],
                       width=inp["cand"].shape[1],
                       barriers=max(k11_barriers(count, inp, f"sweep, {layout}, n = {n}")),
                       bitonic_stages=k11_bitonic_stages(n))
            if baseline is not None and run.names[0] in baseline:
                old = K11Run(inp, baseline)
                k11_check(f"K11 of {baseline['src']} (sweep, {layout}, n = {n})", inp, old)
                row["turns"] = k11_turns(inp, baseline, f"{layout}, n = {n}")
            else:
                run.count()
                row.update(count_device_ms=device_ms(run.count, 20),
                           pack_device_ms=device_ms(run.pack, 20),
                           call_device_ms=device_ms(run.call, 20))
                print(f"    n = {n}: count {row['count_device_ms']:.4f}, pack "
                      f"{row['pack_device_ms']:.4f}, call {row['call_device_ms']:.4f} ms")
            print(f"  n = {n}: {row['barriers']} block barriers (counted); c408a21's bitonic "
                  f"{row['bitonic_stages']} stages (its loop bounds)")
            out[f"{layout}_{n}"] = row
            del inp, run
        out[f"{layout}_ping_pong"] = k11_ping_pong(layout)
    return out


# the steps of k11_ping_pong: the dense allowance's cap at 600 rows a
# destination, so that the ring holds 0, 1,650, 150, 0, 1,650 rows
K11_PING_PONG_CAPS = (7936, 50, 1100, 7936, 50)


def k11_ping_pong(layout: str, n: int = 600, ndev: int = 4, ccar: int = 15872,
                  M: int = 31) -> dict:
    """K11 (this tree's C entries) over successive steps on one shard's two
    ring buffers and their live-length words, as the engine alternates
    them: each step new lanes with n rows for each other destination, the
    ring the last step wrote, the dense allowance at the step's cap
    (K11_PING_PONG_CAPS: the ring grows, shrinks, empties, grows); after
    each, out, the whole new ring, the rows sent and the new ring's word
    against route_plain on the step's lanes and whole ring, bit for bit.
    Returns each step's spilled rows."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    fill = k11_fill(layout, ndev)
    empty = [ndev, 0x7FFFFFFF, 0, -1] if fill is None else fill
    width = len(empty)
    i32 = dict(dtype=torch.int32, device=dev)
    rings = [torch.tensor(empty, **i32).repeat(ccar, 1) for _ in range(2)]
    ring_len = torch.zeros(2, **i32)
    counts = torch.zeros((2, ndev + 1), **i32)
    lanes_cap = -(-(3 * n + n // 2) // M) * M
    seg = 1 << (lanes_cap + ccar - 1).bit_length()
    keys = torch.empty(2 * ndev * seg, dtype=torch.int64, device=dev)
    out = torch.empty(ndev + 3, **i32)
    wire = torch.zeros((max(ndev * max(K11_PING_PONG_CAPS), lanes_cap + ccar),
                        3 if fill is None else width - 2), **i32)
    nsel = torch.tensor(lanes_cap // M, dtype=torch.int64, device=dev)
    rows = () if fill is None else (width, K11_W, fill[1])
    names = ("route_count", "route_pack") if fill is None else ("route_count_rows",
                                                                "route_pack_rows")
    stream = torch.cuda.current_stream(dev).cuda_stream
    spills = []
    for step, cap in enumerate(K11_PING_PONG_CAPS):
        p = step % 2
        dest = torch.cat([torch.arange(1, ndev, device=dev).repeat_interleave(n).int(),
                          torch.full((lanes_cap - 3 * n,), ndev, **i32)])
        cand = k11_rows(dest[torch.randperm(lanes_cap, generator=g, device=dev)], fill, g, ndev)
        carry, nxt = rings[p], rings[1 - p]
        w_p, r_p, o_p = SH.route_plain(cand, lanes_cap, carry, ndev, 0, cap, None, fill)
        _kernels.launch(names[0], cand.data_ptr(), carry.data_ptr(), ring_len[p].data_ptr(),
                        nsel.data_ptr(), M, lanes_cap, ccar, ndev, seg, *rows,
                        counts[p].data_ptr(), counts[1 - p].data_ptr(), out.data_ptr(),
                        keys.data_ptr(), None, stream)
        _kernels.launch(names[1], cand.data_ptr(), carry.data_ptr(), nsel.data_ptr(), M, ccar,
                        ndev, 0, cap, None, seg, *rows, counts[p].data_ptr(), out.data_ptr(),
                        keys.data_ptr(), wire.data_ptr(), nxt.data_ptr(),
                        ring_len[1 - p].data_ptr(), None, stream)
        torch.cuda.synchronize()
        live = int((r_p[:, 0] < ndev).sum())
        sent = torch.cat([torch.arange(d * cap, d * cap + min(int(o_p[d]), cap))
                          for d in range(ndev)]).long().to(dev)
        bad = [what for what, ok in (
            ("out", torch.equal(out, o_p)), ("new ring", torch.equal(nxt, r_p)),
            ("wire rows", torch.equal(wire[sent], w_p[sent])),
            ("its word", int(ring_len[1 - p]) == live)) if not ok]
        if bad:
            fail(f"K11 ({layout} rows) differs from route_plain at step {step} of the ring "
                 f"turns (cap {cap}, {live} rows kept): {bad}")
        spills.append(live)
    print(f"  K11 over two rings ({layout} rows): rows kept {spills}, each step equal to "
          f"route_plain")
    return dict(caps=list(K11_PING_PONG_CAPS), kept=spills)


def timed_check(out: dict, name: str, err, fn, plain_fn, nbytes: int, restore=None) -> None:
    """out[name]: a checked kernel's wrapper (CUDA events, median of 20)
    and device (CUPTI) times, its plain version's, and its bound by bytes
    (``nbytes`` over HBM_BYTES_PER_S); with ``restore``, each run after
    restore() has reset what the kernel changes."""
    ms = time_restored(fn, restore, 20) if restore else time_ms(fn, 20)
    dev = device_ms(fn, 20, restore)
    pms = time_restored(plain_fn, restore, 5) if restore else time_ms(plain_fn, 5, 1)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    out[name] = dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=pms, bytes=nbytes,
                     bound_ms=bound, bound_by="bytes", library_ms=None)
    print(f"  {name}: max |err| {err}; wrapper {ms:.4f} ms, device {dev:.4f} ms, plain "
          f"{pms:.3f} ms, bound {bound:.6f} ms ({nbytes} B)")


def k11_sig_checks(cap: dict, k11_count: dict, k11_baseline=None, k11_phases=None) -> dict:
    """K11 on sig rows on shard ``target``'s inputs of a captured step,
    under the dense and the run's ragged allowance (or the ragged one as if
    every shard sent alike): against route_plain bit for bit, wrapper,
    device, plain times and bound by bytes, each pass alone, each
    destination's sort barriers as the K11_BARRIERS build (``k11_count``)
    counts them beside c408a21's bitonic stages, with ``k11_phases`` the
    K11_PHASES build's split, and another tree's K11 checked and timed in
    turns (``k11_baseline``)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    sh, eng = cap["shard"], cap["eng"]
    ndev, me, M = eng.ndev, sh.me, sh.st.M
    out = {}
    report = functools.partial(timed_check, out)
    S_all = cap["S"]
    if S_all is None:
        S_all = cap["route_out"][:ndev].repeat(ndev, 1).to(torch.int32)
    live = k11_live_rows(cap, ndev)
    for mode, Smat in (("dense", None), ("ragged", S_all)):
        inp = dict(cand=cap["cand_route"], carry=cap["ring"], n_lanes=cap["nsel"] * M, M=M,
                   ndev=ndev, me=me, cap=eng.exchange_cap, S=Smat, seg=sh.seg, carry_len=live)
        run = K11Run(inp)
        p_out = k11_check(f"K11 ({mode})", inp, run)
        A = k11_sent_sizes(inp, p_out)
        remote = int(p_out[:ndev].sum())
        ccar = inp["carry"].shape[0]
        nbytes = k11_bytes(inp, p_out, A)
        report(f"route_{mode}", 0, run.call,
               lambda inp=inp: SH.route_plain(inp["cand"], inp["n_lanes"], inp["carry"], ndev,
                                              me, inp["cap"], inp["S"]), nbytes)
        run.count()
        passes = {"route_count": dict(ms=time_ms(run.count, 20),
                                      device_ms=device_ms(run.count, 20)),
                  "route_pack": dict(ms=time_ms(run.pack, 20), device_ms=device_ms(run.pack, 20))}
        print("    passes alone: " + ", ".join(
            f"{k} wrapper {v['ms']:.4f} ms, device {v['device_ms']:.4f} ms"
            for k, v in passes.items()))
        barriers = k11_barriers(k11_count, inp, mode)
        bitonic = [k11_bitonic_stages(int(c)) for c in p_out[:ndev]]
        out[f"route_{mode}"].update(
            rows=inp["n_lanes"] + ccar, remote=remote, sent=int(A.sum()),
            spilled=remote - int(A.sum()), passes=passes, segments=p_out[:ndev].tolist(),
            barriers=barriers, bitonic_stages=bitonic)
        print(f"    segments {p_out[:ndev].tolist()}: block barriers {barriers} (counted by "
              f"the K11_BARRIERS build; c408a21's bitonic: {bitonic} stages by its loop "
              f"bounds)")
        if k11_phases:
            out[f"route_{mode}"]["split"] = k11_split(inp, k11_phases)
        if k11_baseline is not None:
            old = K11Run(inp, k11_baseline)
            k11_check(f"K11 of {k11_baseline['src']} ({mode})", inp, old)
            out[f"route_{mode}"]["turns"] = k11_turns(inp, k11_baseline,
                                                      f"step {cap['at']}, {mode}")
    return out


def sharded_kernel_checks(cap: dict, shards, k11_count: dict, k11_baseline=None,
                          k11_phases=None) -> dict:
    """Each new kernel of the sharded step against its plain version on
    the card, bit for bit, on shard ``target``'s inputs of the captured
    step: sig_coords and K12 (tri_partial), K4 sharded (its candidate
    rows, t_best after its round-0 match, its pending lanes as a multiset,
    the surviving and pending counts, the goal), K11 under the dense and
    the ragged allowance (counts, migrants, carry overflow, ring min, the
    new ring, the rows sent; each destination's sort barriers, counted by
    the K11_BARRIERS build ``k11_count``, and c408a21's bitonic stages by
    its loop bounds beside them; with ``k11_baseline``, another tree's K11
    checked too and timed in turns); then K7's hop mode against its plain
    version on every shard's finished table from every path node.  Wrapper
    (CUDA events), device (CUPTI) and plain times, and each bound by
    bytes."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import step as S
    from mpi_pastar_msa_tpu_torch.search.engine import SigTable

    sh, eng = cap["shard"], cap["eng"]
    st, ndev, me = sh.st, eng.ndev, sh.me
    M, B = st.M, st.B
    out = {}
    n_sel = int(cap["state0"][2])
    report = functools.partial(timed_check, out)

    print(f"sharded kernel checks (shard {me} of {ndev}, step {cap['at']}, {n_sel} rows):")
    # sig_coords
    if "coords" in cap:
        state = cap["state_sel"]
        want = SH.sig_coords_plain(st, cap["t_sig"], cap["sel"], int(state[2]), B)
        err = int((want.long() - cap["coords"].long()).abs().max())
        if err:
            fail(f"sig_coords differs from its plain version by {err}")
        co = torch.empty_like(cap["coords"])
        bitw = torch.tensor(st.bitw, dtype=torch.int32, device=sh.dev)
        nsel_t = state[2:3].clone()

        def run_coords():
            _kernels.launch("sig_coords", cap["t_sig"].data_ptr(), cap["sel"].data_ptr(),
                            nsel_t.data_ptr(), bitw.data_ptr(), st.n, st.bbits, B,
                            co.data_ptr(), None, torch.cuda.current_stream().cuda_stream)

        report("sig_coords", err, run_coords,
               lambda: SH.sig_coords_plain(st, cap["t_sig"], cap["sel"], int(state[2]), B),
               int(state[2]) * 12 + B * st.n * 4)
        # K12
        tri = sh.tri if sh.tri.numel() else None
        want = SH.tri_partial_plain(cap["coords_g"], sh.cubes, sh.tri, M, st.S)
        err = int((want.long() - cap["part"].long()).abs().max())
        if err:
            fail(f"K12 (tri_partial) differs from its plain version by {err}")
        rows, Tl = cap["coords_g"].shape[0], sh.tri.shape[0]
        report("tri_partial", err,
               lambda: SH._tri_partial_cuda(cap["coords_g"], sh.cubes, tri, st.n, st.S),
               lambda: SH.tri_partial_plain(cap["coords_g"], sh.cubes, sh.tri, M, st.S),
               rows * (st.n * 4 + Tl * 8 * 4 + (M + 1) * 4))
    # K4 sharded
    tab = SigTable(cap["t_sig"].clone(), cap["t_best0"].clone(), cap["t_sig"].clone())
    goal, cand, pending, n_valid = SH.expand_sharded_plain(
        st, tab, cap["sel"], n_sel, eng.ub, cap["h3"], eng.own, ndev, me)
    L = n_sel * M
    bad = []
    if not torch.equal(cand[:L], cap["cand"][:L]):
        bad.append("candidate rows")
    if not torch.equal(tab.t_best[:st.C], cap["t_best1"][:st.C]):  # the plain one writes trash
        bad.append("t_best after round 0")
    srt = lambda t: sorted(map(tuple, t.tolist()))
    if srt(pending) != srt(cap["pend"]):
        bad.append("pending lanes")
    if n_valid != int(cap["state1"][5]) or pending.shape[0] != int(cap["state1"][6]):
        bad.append("surviving or pending counts")
    if min(goal, int(cap["ctr0"][0])) != int(cap["ctr1"][0]):
        bad.append("goal g")
    if bad:
        fail(f"K4 sharded differs from its plain version: {bad}")
    tb, stt, ctr = cap["t_best0"].clone(), cap["state0"].clone(), cap["ctr0"].clone()
    bufs = S.StepBuffers.select_only(st, sh.dev)
    bufs.sel, bufs.state, bufs.run = cap["sel"], stt, torch.ones(1, dtype=torch.int32,
                                                                    device=sh.dev)
    bufs.pend = torch.empty_like(sh.bufs.pend)
    bufs.params = sh.bufs.params
    tab_k = SigTable(cap["t_sig"], tb, cap["t_sig"])
    cand_k = torch.empty_like(sh.cand)

    def restore4():
        tb.copy_(cap["t_best0"])
        stt.copy_(cap["state0"])
        ctr.copy_(cap["ctr0"])

    def plain4():
        t = SigTable(cap["t_sig"], cap["t_best0"].clone(), cap["t_sig"])
        SH.expand_sharded_plain(st, t, cap["sel"], n_sel, eng.ub, cap["h3"], eng.own, ndev, me)

    # as the step launches it: the rows form from sig_coords' coordinates
    report("sig_expand_sharded", 0,
           lambda: S.expand_sharded_cuda(st, tab_k, bufs, ctr, eng.ub, cap["h3"], cand_k, sh.R,
                                         eng.hash_params, ndev, me, coords=cap.get("coords")),
           plain4, n_sel * (8 + 4 + st.P * 20 + (M + 1) * 4 + M * 16)
           + int(cap["state1"][5]) * 32 + pending.shape[0] * 12, restore=restore4)
    out["sig_expand_sharded"].update(rows=n_sel, lanes_valid=n_valid,
                                     pending=int(pending.shape[0]))
    # K11, both allowances
    out.update(k11_sig_checks(cap, k11_count, k11_baseline, k11_phases))
    # K7's hop mode on every shard's table from every path node
    checked, err = 0, 0
    for shd in shards:
        for coord in cap["path"]:
            k = S.walk_hops_cuda(st, shd.tab, coord, SH.WALK_HOPS).cpu()
            p = SH.walk_hops_plain(st, shd.tab, coord, SH.WALK_HOPS)
            err = max(err, int((k.long() - p.long()).abs().max()))
            checked += 1
    if err:
        fail(f"K7 hop mode differs from its plain version by {err}")
    final = [int(v) for v in eng.problem.final_coord]
    owner = next(x for x in shards if int(SH.walk_hops_plain(st, x.tab, final, 1)[-1]))
    out["walk"] = sharded_walk_bytes(st, shards, final)
    wb = walk_bytes(st, owner.tab, "sig", final, SH.WALK_HOPS, SH.WALK_HOPS + st.n + 1)
    report("path_walk_hops", err, lambda: S.walk_hops_cuda(st, owner.tab, final, SH.WALK_HOPS),
           lambda: SH.walk_hops_plain(st, owner.tab, final, SH.WALK_HOPS), wb["bytes"])
    out["path_walk_hops"].update(checked_calls=checked, lookups=wb["lookups"],
                                 probe_rows=wb["probe_rows"])
    return out


def k11_live_rows(cap: dict, ndev: int) -> int:
    """The live rows of the captured step's ring (its first rows, the rest
    the empty row), which the shard's word beside the ring must give, as
    its word beside the new ring the new ring's."""
    got = []
    for ring, word in ((cap["ring"], cap["ring_len"]), (cap["ring1"], cap["ring_len1"])):
        live = int((ring[:, 0] < ndev).sum())
        if not bool((ring[:live, 0] < ndev).all()) or word != live:
            fail(f"K11: a ring's live rows are not its first {live} rows, or its word reads "
                 f"{word}")
        got.append(live)
    return got[0]


def k11_bytes(inp: dict, p_out, A) -> int:
    """K11's bytes on ``inp`` (inputs read once, outputs written once):
    the dest word of every lane and live ring row, the remote rows' other
    words, the send counts (ragged), the row count and the ring's word; the
    wire rows sent, the spilled rows kept, out and the new ring's word (the
    empty row over rows the old buffer held live beyond them: none in the
    steady state timed)."""
    ndev, ccar = inp["ndev"], inp["carry"].shape[0]
    width = inp["cand"].shape[1]
    remote, sent = int(p_out[:ndev].sum()), int(A.sum())
    kept = min(remote - sent, ccar)
    return ((inp["n_lanes"] + inp.get("carry_len", ccar)) * 4 + remote * (width - 1) * 4
            + (0 if inp["S"] is None else ndev * ndev * 4) + 8 + 4
            + sent * (width - 2) * 4 + kept * width * 4 + (ndev + 3) * 4 + 4)


def k11_rows_checks(cap: dict, k11: dict = None) -> dict:
    """K11 on key rows on shard ``target``'s inputs of a captured step
    (sharded_guard), under the dense and the run's ragged allowance (or
    the ragged one as if every shard sent alike): against route_plain bit
    for bit (k11_check), its wrapper, device, plain times and bound by
    bytes, each pass alone, and with ``k11`` (a dict of builds) the
    K11_PHASES build's split (``phases``) with torch.sort of the segment
    beside it, each destination's sort barriers (``count``, the
    K11_BARRIERS build) and another tree's K11 checked and timed in turns
    (``baseline``)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    k11 = k11 or {}
    sh, eng = cap["shard"], cap["eng"]
    ndev, me, M = eng.ndev, sh.me, sh.st.M
    out = {}
    report = functools.partial(timed_check, out)
    S_all = cap["S"]
    if S_all is None:
        S_all = cap["route_out"][:ndev].repeat(ndev, 1).to(torch.int32)
    live = k11_live_rows(cap, ndev)
    for mode, Smat in (("dense", None), ("ragged", S_all)):
        inp = dict(cand=cap["cand_route"], carry=cap["ring"], n_lanes=cap["nsel"] * M, M=M,
                   ndev=ndev, me=me, cap=eng.exchange_cap, S=Smat, seg=sh.seg, fill=sh.fill,
                   carry_len=live)
        run = K11Run(inp)
        p_out = k11_check(f"K11 on {sh.layout} rows ({mode})", inp, run)
        A = k11_sent_sizes(inp, p_out)
        remote = int(p_out[:ndev].sum())
        ccar, width = inp["carry"].shape[0], inp["cand"].shape[1]
        nbytes = k11_bytes(inp, p_out, A)
        report(f"route_rows_{mode}", 0, run.call,
               lambda inp=inp: SH.route_plain(inp["cand"], inp["n_lanes"], inp["carry"], ndev,
                                              me, inp["cap"], inp["S"], inp["fill"]), nbytes)
        run.count()
        row = out[f"route_rows_{mode}"]
        row.update(
            rows=inp["n_lanes"] + ccar, remote=remote, sent=int(A.sum()), width=width,
            spilled=remote - int(A.sum()), segments=p_out[:ndev].tolist(), passes={
                "route_count_rows": dict(ms=time_ms(run.count, 20),
                                         device_ms=device_ms(run.count, 20)),
                "route_pack_rows": dict(ms=time_ms(run.pack, 20),
                                        device_ms=device_ms(run.pack, 20))})
        print("    passes alone: " + ", ".join(
            f"{k} wrapper {v['ms']:.4f} ms, device {v['device_ms']:.4f} ms"
            for k, v in row["passes"].items()))
        if k11.get("phases"):
            row["split"] = k11_split(inp, k11["phases"])
            row["torch_sort"] = k11_sort_yardstick(inp, run)
        for name, fns in k11.get("copy_variants", {}).items():
            print(f"    {fns['src']}:")
            row[f"split_{name}"] = k11_split(inp, fns)
        if k11.get("count"):
            row["barriers"] = k11_barriers(k11["count"], inp, f"{sh.layout} rows, {mode}")
            print(f"    segments {row['segments']}: block barriers {row['barriers']} (counted "
                  f"by the K11_BARRIERS build)")
        if k11.get("baseline") and "route_count_rows" in k11["baseline"]:
            old = K11Run(inp, k11["baseline"])
            k11_check(f"K11 of {k11['baseline']['src']} on {sh.layout} rows ({mode})", inp, old)
            row["turns"] = k11_turns(inp, k11["baseline"],
                                     f"{sh.layout} rows, step {cap['at']}, {mode}")
    return out


# --- K9s (keyrow_expand_sharded): its rows form against its block form,
# the K9S_PHASES split, the rows sweep and another tree's K9s in turns

# the rows a block of the sweep (0: the block form, a block a row)
K9S_SWEEP = (0, 1, 2, 4, 8)
# keyrow_expand.cu's K9S_PHASES readings (kK9sStamps), and what ends at
# each of block 0's readings 3 .. 13
K9S_STAMPS = 14
K9S_MARKS = ("edge_us", "prologue_us", "key_row_us", "t8_us", "masks_us", "home_probe_us",
             "stage_us", "cand_stores_us", "place_us", "pend_stores_us", "tail_us")


def start_k9s_baseline(src: str, tmp: str):
    """Start nvcc on another tree's K9 (``src``: a checkout's root or its
    csrc/ directory; keyrow_expand.cu and the headers it includes) in its
    own directory; returns (src, proc, lib)."""
    import shutil

    from mpi_pastar_msa_tpu_torch import _kernels

    csrc = src if os.path.isfile(os.path.join(src, "keyrow_expand.cu")) else os.path.join(
        src, "mpi_pastar_msa_tpu_torch", "csrc")
    out = os.path.join(tmp, "k9s_baseline")
    os.makedirs(out, exist_ok=True)
    for f in ("keyrow_expand.cu", "expand_row.cuh", "owner.cuh", "step_state.cuh"):
        shutil.copy(os.path.join(csrc, f), out)
    lib = os.path.join(out, "libkeyrow_expand.so")
    proc = subprocess.Popen(
        [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", lib, os.path.join(out, "keyrow_expand.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return src, proc, lib


def load_k9s_baseline(job) -> dict:
    """The other tree's K9 (start_k9s_baseline): its two C entries, the
    sharded one with or without this tree's last argument before the
    stream (rows a block: ``rows`` says whether it takes it), and its
    source under ``src``."""
    from mpi_pastar_msa_tpu_torch import _kernels

    src, proc, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"K9s baseline: nvcc failed for keyrow_expand.cu of {src}:\n{log}")
    with open(os.path.join(os.path.dirname(lib), "keyrow_expand.cu")) as f:
        rows = "int tag_base, int rows, void* stream" in f.read()
    dll = ctypes.CDLL(lib)
    sig = _kernels.SIGNATURES["keyrow_expand_sharded"]
    fns = {"src": src, "rows": rows}
    for name, argtypes in (("keyrow_expand", _kernels.SIGNATURES["keyrow_expand"]),
                           ("keyrow_expand_sharded", sig if rows else sig[:-2] + sig[-1:])):
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def load_k9s_phases(job) -> dict:
    """The K9S_PHASES build (start_phases_build("keyrow_expand", macro=
    "K9S_PHASES")): its sharded C entry (this tree's signature, the form of
    a load_k9s_baseline dict) and ``phases()``, the readings of the
    launches since the last read, which it resets."""
    from mpi_pastar_msa_tpu_torch import _kernels

    name, proc, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc failed for the K9S_PHASES build of keyrow_expand.cu:\n{log}")
    dll = ctypes.CDLL(lib)
    fn = dll.keyrow_expand_sharded
    fn.argtypes, fn.restype = _kernels.SIGNATURES["keyrow_expand_sharded"], ctypes.c_int
    read = dll.keyrow_expand_phases
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int

    def phases() -> list:
        got = (ctypes.c_ulonglong * K9S_STAMPS)()
        if read(ctypes.cast(got, ctypes.c_void_p), K9S_STAMPS):
            fail("keyrow_expand_phases of the K9S_PHASES build failed")
        return list(got)

    return {"src": "the K9S_PHASES build", "rows": True, "keyrow_expand_sharded": fn,
            "phases": phases}


class K9sRun:
    """K9s on a captured step's inputs (``cap``: sharded_guard's, key rows)
    with buffers of its own: ``go()`` launches it once with ``rows`` rows a
    block (0: the block form) through this tree's wrapper, its C entry or
    another build's (``fns``: load_k9s_baseline, load_k9s_phases; a build
    without the rows argument runs its block form); ``restore()`` puts
    back what a launch changes (t_best on the packed layout, the state
    vector, the counters)."""

    def __init__(self, cap: dict, rows: int, fns=None):
        from mpi_pastar_msa_tpu_torch import _kernels
        from mpi_pastar_msa_tpu_torch.search import step as S

        sh, eng = cap["shard"], cap["eng"]
        self.cap, self.layout, self.rows = cap, sh.layout, rows
        self.tab = clone_table(cap["tab0"])
        bufs = S.StepBuffers.select_only(sh.st, sh.dev)
        bufs.sel, bufs.state = cap["sel"], cap["state0"].clone()
        bufs.run = torch.ones(1, dtype=torch.int32, device=sh.dev)
        bufs.pend = torch.empty_like(sh.bufs.pend)
        bufs.params = sh.bufs.params
        self.bufs, self.ctr = bufs, cap["ctr0"].clone()
        self.cand = torch.empty_like(sh.cand)
        self.fns = fns
        if fns is not None and not fns["rows"] and rows:
            fail(f"K9s of {fns['src']}: no rows form (rows {rows})")
        fn = None if fns is None else fns["keyrow_expand_sharded"]

        def launch(name, *args):
            if fn is None:
                return _kernels.launch(name, *args)
            if fn(*(args if fns["rows"] else args[:-2] + args[-1:])):
                fail(f"K9s of {fns['src']} failed to launch")

        self.go = lambda: S.expand_keyrow_sharded_cuda(
            sh.st, self.tab, bufs, self.ctr, eng.ub, cap["h3"], self.cand, sh.R,
            eng.hash_params, eng.ndev, sh.me, sh.tag_base, launch=launch, rows=rows)

    def restore(self):
        if self.layout == "packed":
            self.tab.t_best.copy_(self.cap["tab0"].t_best)
        self.bufs.state.copy_(self.cap["state0"])
        self.ctr.copy_(self.cap["ctr0"])


def k9s_plain(cap: dict):
    """expand_keyrow_sharded_plain on a captured step: (goal, cand,
    pending, surviving lanes, the table after its round-0 match)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    sh, eng = cap["shard"], cap["eng"]
    tab = clone_table(cap["tab0"])
    goal, cand, pending, n_valid = SH.expand_keyrow_sharded_plain(
        sh.st, tab, sh.layout, cap["sel"], int(cap["state0"][2]), eng.ub, cap["h3"], eng.own,
        eng.ndev, sh.me, sh.tag_base)
    return goal, cand, pending, n_valid, tab


def k9s_check(label: str, run: K9sRun, want) -> None:
    """One launch of ``run`` against the plain version (``want``:
    k9s_plain), bit for bit: the candidate rows, every table tensor after
    its round-0 match, the pending entries as a multiset, the surviving and
    pending counts, the goal."""
    cap = run.cap
    sh = cap["shard"]
    st = sh.st
    goal, cand, pending, n_valid, tab = want
    L = int(cap["state0"][2]) * st.M
    run.restore()
    run.go()
    torch.cuda.synchronize()
    n_pend = int(run.bufs.state[6])
    got = run.bufs.pend[sh.R:sh.R + n_pend]
    srt = lambda t: sorted(map(tuple, t.tolist()))
    bad = []
    if not torch.equal(run.cand[:L], cand[:L]):
        bad.append("candidate rows")
    bad += [f for f in tab.__dataclass_fields__
            if not torch.equal(getattr(run.tab, f)[:st.C], getattr(tab, f)[:st.C])]
    if srt(got) != srt(pending):
        bad.append("pending entries")
    if int(run.bufs.state[5]) != n_valid or n_pend != pending.shape[0]:
        bad.append(f"surviving or pending counts {int(run.bufs.state[5])}, {n_pend} against "
                   f"{n_valid}, {pending.shape[0]}")
    if int(run.ctr[0]) != min(goal, int(cap["ctr0"][0])):
        bad.append("goal g")
    if bad:
        fail(f"K9s {label} differs from its plain version: {bad}")


def k9s_split(run: K9sRun, reps: int = 20) -> dict:
    """K9s's split on ``run`` (a K9sRun of the K9S_PHASES build): the
    state's restore and the launch captured in a CUDA graph, replayed
    ``reps`` times, each replay's %globaltimer readings read.  Medians in
    microseconds: block 0's spans between its readings (K9S_MARKS), its
    whole span, and the call (the first block's start to the last block's
    end)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        run.restore()
        run.go()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        run.restore()
        run.go()
    torch.cuda.synchronize()
    run.fns["phases"]()
    spans = {}
    for _ in range(reps):
        graph.replay()
        torch.cuda.synchronize()
        t = run.fns["phases"]()
        got = {"call_us": t[1] - t[0], "block0_us": t[13] - t[2],
               "to_block0_us": t[2] - t[0]}
        got.update({name: t[k + 3] - t[k + 2] for k, name in enumerate(K9S_MARKS)})
        for k, v in got.items():
            spans.setdefault(k, []).append(v / 1e3)
    del graph
    return {k: statistics.median(v) for k, v in spans.items()}


def k9s_latency_floor(floor: dict, chase: dict) -> dict:
    """K9s's (and K4s's) latency floor: a launch and four dependent L2
    accesses (the list entry, the row, its T8 rows with its children's
    home rows, the place atomic), and beside it from device memory."""
    return dict(latency_floor_ms=floor["device_ms"] + 4 * chase["l2_ns"] / 1e6,
                latency_floor_dram_ms=floor["device_ms"] + 4 * chase["dram_ns"] / 1e6)


def k9s_checks(cap: dict, k9s: dict) -> dict:
    """K9s on a captured step (``cap``, key rows): for each rows a block of
    ``k9s["rows"]`` (K9S_SWEEP by default; 0 the block form), a launch
    against the plain version bit for bit (k9s_check), its device (CUPTI)
    and wrapper (CUDA events) times, and with ``k9s["phases"]`` the
    K9S_PHASES build's split; with ``k9s["baseline"]``, another tree's K9s
    checked the same way and timed in turns with this tree's at K9S_ROWS
    (old, new, new, old)."""
    from mpi_pastar_msa_tpu_torch.search import step as S

    sh = cap["shard"]
    want = k9s_plain(cap)
    out = {"layout": sh.layout, "rows_listed": int(cap["state0"][2]), "M": sh.st.M,
           "sweep": {}}
    for rows in k9s.get("rows") or K9S_SWEEP:
        run = K9sRun(cap, rows)
        k9s_check(f"({sh.layout}, {rows} rows a block)", run, want)
        row = dict(device_ms=device_ms(run.go, 20, run.restore),
                   ms=time_restored(run.go, run.restore, 20),
                   shape=S.k9s_launch_shape(sh.st.B, sh.st.M, S._sms(sh.dev), rows))
        if k9s.get("phases"):
            prun = K9sRun(cap, rows, k9s["phases"])
            k9s_check(f"({sh.layout}, {rows} rows a block, the K9S_PHASES build)", prun, want)
            row["split"] = k9s_split(prun)
        out["sweep"][rows] = row
        print(f"  K9s {sh.layout}, {rows} rows a block {row['shape']}: device "
              f"{row['device_ms']:.4f} ms, wrapper {row['ms']:.4f} ms" + (
                  "; split (us): " + ", ".join(f"{k[:-3]} {v:.3f}"
                                               for k, v in row["split"].items())
                  if "split" in row else ""))
    base = k9s.get("baseline")
    if base is not None:
        old, new = K9sRun(cap, 0, base), K9sRun(cap, S.K9S_ROWS)
        k9s_check(f"of {base['src']} ({sh.layout})", old, want)
        res = {"device": {"old": [], "new": []}, "wrapper": {"old": [], "new": []}}
        for w in ("old", "new", "new", "old"):
            r = old if w == "old" else new
            res["device"][w].append(device_ms(r.go, 20, r.restore))
            res["wrapper"][w].append(time_restored(r.go, r.restore, 20))
        out["turns"] = res
        print(f"  K9s in turns with {base['src']} ({sh.layout}; old, new, new, old): " + "; ".join(
            f"{k} {v['old'][0]:.4f} / {v['new'][0]:.4f} / {v['new'][1]:.4f} / "
            f"{v['old'][1]:.4f} ms" for k, v in res.items()))
    return out


def k9_unsharded_turns(label: str, path: str, warm: int, baseline: dict) -> dict:
    """The unsharded K9 (``keyrow_expand``) of this tree and of another
    (``baseline``, load_k9s_baseline) on one step of ``path``'s search
    (``warm`` steps in, after K3): the two launches' table, state, counters
    and pending entries (as a multiset) equal; device ms (CUPTI) in turns
    (old, new, new, old)."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.search import step as S

    eng, tab0, ctr0 = warm_engine(path, "auto", warm)
    st, layout = eng.st, eng.layout
    bufs = S._step_buffers(st, tab0.t_key.device, layout)
    stream = torch.cuda.current_stream().cuda_stream
    work, ctr = clone_table(tab0), ctr0.clone()
    ctr[1] = 0
    bufs.run.fill_(1)
    k3, k9, _ = S._step_args(st, work, bufs, ctr, eng.ub, eng.fill_target, 0, S.K10_CAP, stream)
    _kernels.launch(*k3)
    torch.cuda.synchronize()
    after3, state3, ctr3 = clone_table(work), bufs.state.clone(), ctr.clone()

    def old():
        if baseline["keyrow_expand"](*k9[1:]):
            fail(f"K9 of {baseline['src']} failed to launch")

    fns = {"new": lambda: _kernels.launch(*k9), "old": old}

    def restore():
        for f in after3.__dataclass_fields__:
            getattr(work, f).copy_(getattr(after3, f))
        bufs.state.copy_(state3)
        ctr.copy_(ctr3)

    outs = {}
    for w in ("new", "old"):
        restore()
        fns[w]()
        torch.cuda.synchronize()
        n = int(bufs.state[6])
        outs[w] = ([getattr(work, f)[:st.C].clone() for f in after3.__dataclass_fields__]
                   + [bufs.state.clone(), ctr.clone(),
                      sorted(map(tuple, bufs.pend[:n].tolist()))])
    if not all((a == b) if isinstance(a, list) else torch.equal(a, b)
               for a, b in zip(outs["new"], outs["old"])):
        fail(f"K9 {label}: this tree's and {baseline['src']}'s differ")
    res = {"old": [], "new": []}
    for w in ("old", "new", "new", "old"):
        res[w].append(device_ms(fns[w], 20, restore))
    print(f"  K9 {label} ({layout}, M = {st.M}) equal to {baseline['src']}'s; device in turns "
          f"(old, new, new, old): {res['old'][0]:.4f} / {res['new'][0]:.4f} / "
          f"{res['new'][1]:.4f} / {res['old'][1]:.4f} ms")
    return res


def k9s_phase(paths, gold, k9s: dict) -> dict:
    """K9s alone (``--k9s-only``): kinase on 4 shards of one card under the
    host driver, packed (auto) and pinned to unpacked, each to the golden g
    with step 200 captured, and the random 4 x 12-16 input (M = 15) on 4
    shards, packed and unpacked, step 6 captured: k9s_checks on each
    (``k9s``: rows, phases, baseline); with a baseline, the unsharded K9 at
    globin6 step 60 and synth10 step 20 in turns with the other tree's;
    then traced dense chunked runs of kinase (their device time a step, by
    kernel), K9s's block form, then its rows form."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch.core.problem import Problem
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.bruteforce import optimal_cost

    card = torch.device("cuda", 0)
    k = gold["kinase.fasta"]
    out = {}
    for layout, kw in (("packed", {}), ("unpacked", {"layout": "unpacked"})):
        out[f"kinase_{layout}"], eng, cap = sharded_run(
            f"kinase sharded 4, {layout}, host driver", paths["kinase.fasta"], k, [card] * 4,
            layout == "packed", capture_step=200, driver="host", **kw)
        if "cand" not in cap:
            fail(f"kinase sharded {layout}: the search ended before the captured step")
        print(f"K9s on shard {cap['shard'].me}'s step 200 (kinase, {layout}):")
        out[f"checks_{layout}"] = k9s_checks(cap, k9s)
        del eng, cap
    rs = np.random.RandomState(31)
    seqs = tuple("".join(rs.choice(list("ACDEFGHIKLMNPQRSTVWY"), size=rs.randint(12, 17)))
                 for _ in range(4))
    want = optimal_cost(Problem(seqs), HPairHeuristic.build(Problem(seqs), "cpu"))
    with tempfile.NamedTemporaryFile("w", suffix=".fasta", delete=False) as f:
        f.write("".join(f">s{i}\n{q}\n" for i, q in enumerate(seqs)))
    for layout in ("packed", "unpacked"):
        out[f"random_{layout}"], eng, cap = sharded_run(
            f"random 4 x 12-16 sharded 4, {layout}, host driver", f.name,
            {"optimal_g": want, "seqs": list(seqs), "alignment": None}, [card] * 4, False,
            capture_step=6, driver="host", hash_type="FSUM", hash_shift=0, batch=16,
            layout=layout)
        if "cand" not in cap:
            fail(f"random sharded {layout}: the search ended before the captured step")
        print(f"K9s on shard {cap['shard'].me}'s step 6 (random 4 x 12-16, {layout}):")
        out[f"random_checks_{layout}"] = k9s_checks(cap, k9s)
        del eng, cap
    os.unlink(f.name)
    if k9s.get("baseline"):
        for name, steps in (("globin6", 60), ("synth10", 20)):
            out[f"k9_{name}"] = k9_unsharded_turns(f"{name} step {steps}", data_path(name),
                                                   steps, k9s["baseline"])
    # the traced dense step with K9s's block form (K9S_ROWS 0 for the run),
    # then with its rows form
    from mpi_pastar_msa_tpu_torch.search import step as S

    rows = S.K9S_ROWS
    for key, r in (("kinase_dense_block_form", 0), ("kinase_dense", rows)):
        S.K9S_ROWS = r
        try:
            out[key], eng, _ = sharded_run(f"kinase sharded 4, dense, K9s rows {r}",
                                           paths["kinase.fasta"], k, [card] * 4, True,
                                           profile=True, exchange="dense")
        finally:
            S.K9S_ROWS = rows
        del eng
        print(f"  the dense step's device us by kernel (K9s rows {r}): " + ", ".join(
            f"{name} {us:.2f}" for name, us in out[key]["step_kernels_us"].items()))
    return out


# --- K4s (sig_expand_sharded): its rows form against the warp-strided
# form, the K4S_PHASES split, the rows sweep and another tree's K4s in turns

# the rows a block of the sweep (0: the warp-strided form)
K4S_SWEEP = (0, 1, 2, 4, 8)
# sig_expand.cu's K4S_PHASES readings (kK4sStamps), and what ends at each
# of block 0's readings 3 .. 12
K4S_STAMPS = 13
K4S_MARKS = ("edge_us", "round1_us", "decode_us", "round2_us", "masks_us", "match_us",
             "cand_stores_us", "place_us", "pend_stores_us", "tail_us")
# synth5's certified optimum (tests/test_export_cache.py), and the sharded
# steps whose K4s the smoke checks: kinase pinned to sig at step 200,
# synth5 under auto at step 150 (its run on 4 shards ends at step 186),
# synth6 (N = 6: the warp-strided form) at step 40
SYNTH5_G = 266713
K4S_STEP, K4S_STEP_N5, K4S_STEP_N6 = 200, 150, 40


def start_k4s_baseline(src: str, tmp: str):
    """Start nvcc on another tree's K4 (``src``: a checkout's root or its
    csrc/ directory; sig_expand.cu and the headers it includes) in its own
    directory; returns (src, proc, lib)."""
    import shutil

    from mpi_pastar_msa_tpu_torch import _kernels

    csrc = src if os.path.isfile(os.path.join(src, "sig_expand.cu")) else os.path.join(
        src, "mpi_pastar_msa_tpu_torch", "csrc")
    out = os.path.join(tmp, "k4s_baseline")
    os.makedirs(out, exist_ok=True)
    for f in ("sig_expand.cu", "expand_row.cuh", "owner.cuh", "sig_key.cuh", "step_state.cuh"):
        shutil.copy(os.path.join(csrc, f), out)
    lib = os.path.join(out, "libsig_expand.so")
    proc = subprocess.Popen(
        [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", lib, os.path.join(out, "sig_expand.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return src, proc, lib


def load_k4s_baseline(job) -> dict:
    """The other tree's K4s (start_k4s_baseline): its sharded C entry, with
    or without this tree's last two arguments before the stream (the
    coordinates and the rows a block: ``rows`` says whether it takes them),
    and its source under ``src``."""
    from mpi_pastar_msa_tpu_torch import _kernels

    src, proc, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"K4s baseline: nvcc failed for sig_expand.cu of {src}:\n{log}")
    with open(os.path.join(os.path.dirname(lib), "sig_expand.cu")) as f:
        rows = "const void* coords, int rows, void* stream" in f.read()
    sig = _kernels.SIGNATURES["sig_expand_sharded"]
    fn = ctypes.CDLL(lib).sig_expand_sharded
    fn.argtypes, fn.restype = (sig if rows else sig[:-3] + sig[-1:]), ctypes.c_int
    return {"src": src, "rows": rows, "sig_expand_sharded": fn}


def load_k4s_phases(job) -> dict:
    """The K4S_PHASES build (start_phases_build("sig_expand", macro=
    "K4S_PHASES")): its sharded C entry (this tree's signature, the form of
    a load_k4s_baseline dict) and ``phases()``, the readings of the
    launches since the last read, which it resets."""
    from mpi_pastar_msa_tpu_torch import _kernels

    name, proc, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc failed for the K4S_PHASES build of sig_expand.cu:\n{log}")
    dll = ctypes.CDLL(lib)
    fn = dll.sig_expand_sharded
    fn.argtypes, fn.restype = _kernels.SIGNATURES["sig_expand_sharded"], ctypes.c_int
    read = dll.sig_expand_phases
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int

    def phases() -> list:
        got = (ctypes.c_ulonglong * K4S_STAMPS)()
        if read(ctypes.cast(got, ctypes.c_void_p), K4S_STAMPS):
            fail("sig_expand_phases of the K4S_PHASES build failed")
        return list(got)

    return {"src": "the K4S_PHASES build", "rows": True, "sig_expand_sharded": fn,
            "phases": phases}


class K4sRun:
    """K4s on a captured sig step's inputs (``cap``: sharded_guard's) with
    buffers of its own: ``go()`` launches it once with ``rows`` rows a
    block (0: the warp-strided form; k4s_rows keeps it at N >= 6) through
    this tree's wrapper, its C entry or another build's (``fns``:
    load_k4s_baseline, load_k4s_phases; a build without the last two
    arguments runs its warp-strided form), from the step's sig_coords
    output (``coords``, where the step ran it) or decoding the sig words;
    ``restore()`` puts back what a launch changes (t_best, the state
    vector, the counters)."""

    def __init__(self, cap: dict, rows: int, fns=None, coords: bool = True):
        from mpi_pastar_msa_tpu_torch import _kernels
        from mpi_pastar_msa_tpu_torch.search import step as S
        from mpi_pastar_msa_tpu_torch.search.engine import SigTable

        sh, eng = cap["shard"], cap["eng"]
        self.cap, self.rows = cap, rows
        self.tab = SigTable(cap["t_sig"], cap["t_best0"].clone(), cap["t_sig"])
        bufs = S.StepBuffers.select_only(sh.st, sh.dev)
        bufs.sel, bufs.state = cap["sel"], cap["state0"].clone()
        bufs.run = torch.ones(1, dtype=torch.int32, device=sh.dev)
        bufs.pend = torch.empty_like(sh.bufs.pend)
        bufs.params = sh.bufs.params
        self.bufs, self.ctr = bufs, cap["ctr0"].clone()
        self.cand = torch.empty_like(sh.cand)
        self.fns = fns
        if fns is not None and not fns["rows"] and rows:
            fail(f"K4s of {fns['src']}: no rows form (rows {rows})")
        fn = None if fns is None else fns["sig_expand_sharded"]
        co = cap.get("coords") if coords else None

        def launch(name, *args):
            if fn is None:
                return _kernels.launch(name, *args)
            if fn(*(args if fns["rows"] else args[:-3] + args[-1:])):
                fail(f"K4s of {fns['src']} failed to launch")

        self.go = lambda: S.expand_sharded_cuda(
            sh.st, self.tab, bufs, self.ctr, eng.ub, cap["h3"], self.cand, sh.R,
            eng.hash_params, eng.ndev, sh.me, launch=launch, coords=co, rows=rows)

    def restore(self):
        self.tab.t_best.copy_(self.cap["t_best0"])
        self.bufs.state.copy_(self.cap["state0"])
        self.ctr.copy_(self.cap["ctr0"])


def k4s_plain(cap: dict):
    """expand_sharded_plain on a captured sig step: (goal, cand, pending,
    surviving lanes, t_best after its round-0 match)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search.engine import SigTable

    sh, eng = cap["shard"], cap["eng"]
    tab = SigTable(cap["t_sig"], cap["t_best0"].clone(), cap["t_sig"])
    goal, cand, pending, n_valid = SH.expand_sharded_plain(
        sh.st, tab, cap["sel"], int(cap["state0"][2]), eng.ub, cap["h3"], eng.own, eng.ndev,
        sh.me)
    return goal, cand, pending, n_valid, tab.t_best


def k4s_check(label: str, run: K4sRun, want) -> None:
    """One launch of ``run`` against the plain version (``want``:
    k4s_plain), bit for bit: the candidate rows, t_best after its round-0
    match, the pending lanes as a multiset, the surviving and pending
    counts, the goal."""
    cap = run.cap
    sh = cap["shard"]
    st = sh.st
    goal, cand, pending, n_valid, t_best = want
    L = int(cap["state0"][2]) * st.M
    run.restore()
    run.go()
    torch.cuda.synchronize()
    n_pend = int(run.bufs.state[6])
    got = run.bufs.pend[sh.R:sh.R + n_pend]
    srt = lambda t: sorted(map(tuple, t.tolist()))
    bad = []
    if not torch.equal(run.cand[:L], cand[:L]):
        bad.append("candidate rows")
    if not torch.equal(run.tab.t_best[:st.C], t_best[:st.C]):  # the plain one writes trash
        bad.append("t_best after round 0")
    if srt(got) != srt(pending):
        bad.append("pending lanes")
    if int(run.bufs.state[5]) != n_valid or n_pend != pending.shape[0]:
        bad.append(f"surviving or pending counts {int(run.bufs.state[5])}, {n_pend} against "
                   f"{n_valid}, {pending.shape[0]}")
    if int(run.ctr[0]) != min(goal, int(cap["ctr0"][0])):
        bad.append("goal g")
    if bad:
        fail(f"K4s {label} differs from its plain version: {bad}")


def k4s_split(run: K4sRun, reps: int = 20) -> dict:
    """K4s's split on ``run`` (a K4sRun of the K4S_PHASES build, rows form):
    the state's restore and the launch captured in a CUDA graph, replayed
    ``reps`` times, each replay's %globaltimer readings read.  Medians in
    microseconds: block 0's spans between its readings (K4S_MARKS), its
    whole span, and the call (the first block's start to the last block's
    end)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        run.restore()
        run.go()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        run.restore()
        run.go()
    torch.cuda.synchronize()
    run.fns["phases"]()
    spans = {}
    for _ in range(reps):
        graph.replay()
        torch.cuda.synchronize()
        t = run.fns["phases"]()
        got = {"call_us": t[1] - t[0], "block0_us": t[12] - t[2],
               "to_block0_us": t[2] - t[0]}
        got.update({name: t[k + 3] - t[k + 2] for k, name in enumerate(K4S_MARKS)})
        for k, v in got.items():
            spans.setdefault(k, []).append(v / 1e3)
    del graph
    return {k: statistics.median(v) for k, v in spans.items()}


def k4s_checks(cap: dict, k4s: dict) -> dict:
    """K4s on a captured sig step (``cap``): for each rows a block of
    ``k4s["rows"]`` (K4S_SWEEP by default; 0 the warp-strided form; at N
    >= 6 every one runs that form), a launch against the plain version bit
    for bit (k4s_check), its device (CUPTI) and wrapper (CUDA events)
    times, and with ``k4s["phases"]`` the K4S_PHASES build's split; the
    rows form at K4S_ROWS decoding the sig words (as with no sharded
    cubes) checked and timed too; with ``k4s["baseline"]``, another tree's
    K4s checked the same way and timed in turns with this tree's at
    K4S_ROWS (old, new, new, old)."""
    from mpi_pastar_msa_tpu_torch.search import step as S

    sh = cap["shard"]
    st = sh.st
    want = k4s_plain(cap)
    out = {"rows_listed": int(cap["state0"][2]), "M": st.M, "coords": "coords" in cap,
           "lanes_valid": want[3], "pending": int(want[2].shape[0]), "sweep": {}}
    sweep = k4s.get("rows") or K4S_SWEEP
    if st.M > S.K9S_ROWS_MAX_M:
        sweep = (0,)  # N >= 6: the warp-strided form whatever rows says
    for rows in sweep:
        run = K4sRun(cap, rows)
        k4s_check(f"({rows} rows a block)", run, want)
        row = dict(device_ms=device_ms(run.go, 20, run.restore),
                   ms=time_restored(run.go, run.restore, 20), form_rows=S.k4s_rows(st.M, rows))
        if k4s.get("phases") and row["form_rows"]:
            prun = K4sRun(cap, rows, k4s["phases"])
            k4s_check(f"({rows} rows a block, the K4S_PHASES build)", prun, want)
            row["split"] = k4s_split(prun)
        out["sweep"][rows] = row
        print(f"  K4s, {rows} rows a block (form {row['form_rows']}): device "
              f"{row['device_ms']:.4f} ms, wrapper {row['ms']:.4f} ms" + (
                  "; split (us): " + ", ".join(f"{k[:-3]} {v:.3f}"
                                               for k, v in row["split"].items())
                  if "split" in row else ""))
    if st.M <= S.K9S_ROWS_MAX_M and "coords" in cap:
        run = K4sRun(cap, S.K4S_ROWS, coords=False)
        k4s_check(f"({S.K4S_ROWS} rows a block, decoding the sig words)", run, want)
        out["decode"] = dict(device_ms=device_ms(run.go, 20, run.restore),
                             ms=time_restored(run.go, run.restore, 20))
        print(f"  K4s, {S.K4S_ROWS} rows a block decoding the sig words: device "
              f"{out['decode']['device_ms']:.4f} ms, wrapper {out['decode']['ms']:.4f} ms")
    base = k4s.get("baseline")
    if base is not None:
        old, new = K4sRun(cap, 0, base), K4sRun(cap, S.K4S_ROWS)
        k4s_check(f"of {base['src']}", old, want)
        res = {"device": {"old": [], "new": []}, "wrapper": {"old": [], "new": []}}
        for w in ("old", "new", "new", "old"):
            r = old if w == "old" else new
            res["device"][w].append(device_ms(r.go, 20, r.restore))
            res["wrapper"][w].append(time_restored(r.go, r.restore, 20))
        out["turns"] = res
        print(f"  K4s in turns with {base['src']} (old, new, new, old): " + "; ".join(
            f"{k} {v['old'][0]:.4f} / {v['new'][0]:.4f} / {v['new'][1]:.4f} / "
            f"{v['old'][1]:.4f} ms" for k, v in res.items()))
    return out


def k4s_runs(paths, gold, k4s: dict, kinase: bool = True) -> dict:
    """K4s's inputs and checks, 4 shards of one card: synth5 under auto
    (sig at 2^21 slots a shard: 40 key bits) to its optimum under the
    chunked driver (the main path's driver: its K4s launches counted),
    then under the host driver with step K4S_STEP_N5 captured; with
    ``kinase``, kinase pinned to sig at 2^23 slots a shard, the same step
    captured; synth5 with its cubes not split (shard_cubes False: no h3 and
    no sig_coords, each shard reads its own cubes and K4s decodes the sig
    words), the same step captured; k4s_checks on each (``k4s``: rows,
    phases, baseline); synth6 (N = 6, sig under auto) with step
    K4S_STEP_N6 captured, its warp-strided form checked."""
    card = torch.device("cuda", 0)
    out = {}
    s5 = data_gold("synth5", SYNTH5_G)
    out["synth5_chunked"], eng, _ = sharded_run("synth5 sharded 4, auto (chunked driver)",
                                                data_path("synth5"), s5, [card] * 4, False)
    if eng.layout != "sig" or out["synth5_chunked"]["driver"] != "chunked":
        fail(f"synth5 sharded: layout {eng.layout}, driver {out['synth5_chunked']['driver']}; "
             f"want sig, chunked")
    eng.driver = "host"
    runs = ((("kinase_sig", "kinase sharded 4, pinned sig", paths["kinase.fasta"],
              gold["kinase.fasta"], True, dict(layout="sig", capacity=1 << 23), K4S_STEP,
              None),) if kinase else ()) + (
            ("synth5", "synth5 sharded 4, auto", data_path("synth5"), s5, False, {},
             K4S_STEP_N5, eng),
            ("synth5_own_cubes", "synth5 sharded 4, auto, cubes not split",
             data_path("synth5"), s5, False, dict(shard_cubes=False), K4S_STEP_N5, None),
            ("synth6", "synth6 sharded 4, auto", data_path("synth6"),
             data_gold("synth6", SYNTH6_G), False, {}, K4S_STEP_N6, None))
    del eng
    for key, label, path, g, ident, kw, at, e in runs:
        out[key], e, cap = sharded_run(f"{label}, host driver", path, g, [card] * 4, ident,
                                       capture_step=at, eng=e,
                                       **({} if e is not None else dict(kw, driver="host")))
        if e.layout != "sig" or "cand" not in cap:
            fail(f"{label}: layout {e.layout}, or the search ended before step {at}")
        if e.cubes_split != (cap["h3"] is not None) or e.cubes_split != ("coords" in cap):
            fail(f"{label}: cubes split {e.cubes_split}, but h3 and sig_coords "
                 f"{cap['h3'] is not None}, {'coords' in cap}")
        print(f"K4s on shard {cap['shard'].me}'s step {at} ({label}, N = {e.st.n}, "
              f"{int(cap['state0'][2])} rows):")
        out[f"checks_{key}"] = k4s_checks(cap, k4s)
        del e, cap
    return out


def k4s_dense_forms(paths, gold) -> dict:
    """Traced dense chunked runs of kinase pinned to sig (2^23 a shard),
    one engine: K4s's warp-strided form (K4S_ROWS 0 for the run), then its
    rows form; each run's device time a step, by kernel."""
    from mpi_pastar_msa_tpu_torch.search import step as S

    card = torch.device("cuda", 0)
    out, eng, rows = {}, None, S.K4S_ROWS
    for key, r in (("sig_dense_strided_form", 0), ("sig_dense", rows)):
        S.K4S_ROWS = r
        try:
            out[key], eng, _ = sharded_run(f"kinase sharded 4, pinned sig, dense, K4s rows {r}",
                                           paths["kinase.fasta"], gold["kinase.fasta"],
                                           [card] * 4, True, profile=True, eng=eng,
                                           **({} if eng else dict(exchange="dense",
                                                                  layout="sig",
                                                                  capacity=1 << 23)))
        finally:
            S.K4S_ROWS = rows
        print(f"  the dense sig step's device us by kernel (K4s rows {r}): " + ", ".join(
            f"{name} {us:.2f}" for name, us in out[key]["step_kernels_us"].items()))
    return out


def k4s_phase(paths, gold, k4s: dict) -> dict:
    """K4s alone (``--k4s-only``): k4s_runs (kinase pinned to sig, synth5
    chunked then host, synth6), then the traced dense sig step with each
    form (k4s_dense_forms)."""
    out = k4s_runs(paths, gold, k4s)
    out.update(k4s_dense_forms(paths, gold))
    return out


def keyrow_kernel_checks(cap: dict, shards, k10_phase_fns=None, baseline=None,
                         k11=None, k9s=None) -> dict:
    """The sharded step's kernels on key rows against their plain versions
    on the card, bit for bit, on shard ``target``'s inputs of the captured
    step (sharded_guard) of a packed or unpacked run: keyrow_coords and
    K12 (packed), K9s (its candidate rows, every table tensor after its
    round-0 match, its pending entries as a multiset, the surviving and
    pending counts, the goal), K11 on key rows under the run's ragged and
    the dense allowance (counts, migrants, carry overflow, ring min, the
    new ring, the rows sent), K10 over the received rows and the
    self-owned lanes (every table tensor, the claim words included, the 14
    counters and its rounds, against insert_pending_plain and
    finish_plain; the kernel run on them again against the same, its path
    (block or grid) and list length; with ``k10_phase_fns``, the
    K10_PHASES build's split of it; with ``baseline``, another tree's K10
    checked and timed in turns with it), then K7's hop mode against its
    plain version on every shard's finished table from every path node.
    Wrapper (CUDA events), device (CUPTI) and plain times, and each bound
    by bytes; with ``k9s`` (a dict of builds), k9s_checks: K9s's rows
    sweep, split and another tree's K9s in turns."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import step as S

    sh, eng = cap["shard"], cap["eng"]
    st, ndev, me, layout = sh.st, eng.ndev, sh.me, sh.layout
    M, B, W, C = st.M, st.B, st.W, st.C
    pw = SH.pend_words(st, layout)
    out = {}
    report = functools.partial(timed_check, out)
    n_sel = int(cap["state0"][2])
    L = n_sel * M
    fields = list(cap["tab0"].__dataclass_fields__)
    srt = lambda t: sorted(map(tuple, t.tolist()))
    print(f"sharded kernel checks on {layout} rows (shard {me} of {ndev}, step {cap['at']}, "
          f"{n_sel} rows, {cap['n_front']} received):")
    if "coords" in cap:  # keyrow_coords and K12 (the cubes split: packed)
        nsel = int(cap["state_sel"][2])
        want = SH.keyrow_coords_plain(st, cap["t_key"], cap["sel"], nsel, B)
        err = int((want.long() - cap["coords"].long()).abs().max())
        if err:
            fail(f"keyrow_coords differs from its plain version by {err}")
        co = torch.empty_like(cap["coords"])
        nsel_t = cap["state_sel"][2:3].clone()

        def run_coords():
            _kernels.launch("keyrow_coords", cap["t_key"].data_ptr(), cap["t_key"].shape[1],
                            cap["sel"].data_ptr(), nsel_t.data_ptr(), st.n, B, co.data_ptr(),
                            None, torch.cuda.current_stream().cuda_stream)

        report("keyrow_coords", err, run_coords,
               lambda: SH.keyrow_coords_plain(st, cap["t_key"], cap["sel"], nsel, B),
               nsel * (8 + W * 4) + B * st.n * 4)
        want = SH.tri_partial_plain(cap["coords_g"], sh.cubes, sh.tri, M, st.S)
        if not torch.equal(want, cap["part"]):
            fail("K12 (tri_partial) on the packed run differs from its plain version")
    # K9s
    tab = clone_table(cap["tab0"])
    goal, cand, pending, n_valid = SH.expand_keyrow_sharded_plain(
        st, tab, layout, cap["sel"], n_sel, eng.ub, cap["h3"], eng.own, ndev, me, sh.tag_base)
    bad = []
    if not torch.equal(cand[:L], cap["cand"][:L]):
        bad.append("candidate rows")
    bad += [f for f in fields if not torch.equal(getattr(tab, f)[:C], getattr(cap["tab1"], f)[:C])]
    if srt(pending) != srt(cap["pend"]):
        bad.append("pending entries")
    if n_valid != int(cap["state1"][5]) or pending.shape[0] != int(cap["state1"][6]):
        bad.append("surviving or pending counts")
    if min(goal, int(cap["ctr0"][0])) != int(cap["ctr1"][0]):
        bad.append("goal g")
    if bad:
        fail(f"K9s ({layout}) differs from its plain version: {bad}")
    tab_k, stt, ctr = clone_table(cap["tab0"]), cap["state0"].clone(), cap["ctr0"].clone()
    bufs = S.StepBuffers.select_only(st, sh.dev)
    bufs.sel, bufs.state, bufs.run = cap["sel"], stt, torch.ones(1, dtype=torch.int32,
                                                                    device=sh.dev)
    bufs.pend = torch.empty_like(sh.bufs.pend)
    bufs.params = sh.bufs.params
    cand_k = torch.empty_like(sh.cand)

    def restore9():
        if layout == "packed":
            tab_k.t_best.copy_(cap["tab0"].t_best)
        stt.copy_(cap["state0"])
        ctr.copy_(cap["ctr0"])

    def plain9():
        t = cap["tab0"]
        if layout == "packed":
            t = type(t)(t.t_key, t.t_best.clone(), t.t_closed, t.claim)
        SH.expand_keyrow_sharded_plain(st, t, layout, cap["sel"], n_sel, eng.ub, cap["h3"],
                                       eng.own, ndev, me, sh.tag_base)

    kws = cap["tab0"].t_key.shape[1]
    row_in = 8 + kws * 4 + (12 if layout == "unpacked" else 0) + st.P * 20 + (
        (M + 1) * 4 if cap["h3"] is not None else st.T3 * 8 * 4)
    report("keyrow_expand_sharded", 0,
           lambda: S.expand_keyrow_sharded_cuda(st, tab_k, bufs, ctr, eng.ub, cap["h3"], cand_k,
                                                sh.R, eng.hash_params, ndev, me, sh.tag_base),
           plain9, n_sel * row_in + L * (2 + pw) * 4
           + (n_valid * W * 4 if layout == "packed" else 0) + pending.shape[0] * pw * 4,
           restore=restore9)
    out["keyrow_expand_sharded"].update(rows=n_sel, lanes=L, lanes_valid=n_valid,
                                        pending=int(pending.shape[0]))
    if k9s is not None:
        out["keyrow_expand_sharded"]["k9s"] = k9s_checks(cap, k9s)
    # K11 on key rows, both allowances
    out.update(k11_rows_checks(cap, k11))
    # K10 over [received; self-owned]
    tab = clone_table(cap["k10_tab0"])
    c = cap["k10_ctr0"].clone()
    s0 = cap["k10_state0"]
    n_front, rows = cap["n_front"], cap["k10_rows"]
    ovf, reopen, rounds, un, tail = SH.insert_pending_plain(st, tab, layout, rows, n_front)
    state = [0, int(s0[1]), int(s0[2]), int(s0[3]) + reopen, int(s0[4])]
    SH.finish_plain(c, state, cap["fill"], int(s0[5]), ovf, rounds, un, tail)
    bad = [f for f in fields if not torch.equal(getattr(tab, f)[:C],
                                                 getattr(cap["k10_tab1"], f)[:C])]
    if not torch.equal(c, cap["k10_ctr1"]):
        bad.append(f"counters {cap['k10_ctr1'].tolist()} vs {c.tolist()}")
    if int(cap["k10_state1"][7]) != rounds:
        bad.append(f"rounds {int(cap['k10_state1'][7])} vs {rounds}")
    if bad:
        fail(f"K10 on received rows ({layout}) differs from its plain version: {bad}")
    changed = sum(int((getattr(cap["k10_tab1"], f)[:C] != getattr(cap["k10_tab0"], f)[:C])
                      .reshape(C, -1).any(1).sum()) * getattr(cap["k10_tab0"], f)[0].numel()
                  * getattr(cap["k10_tab0"], f).element_size() for f in fields)
    tab_k = clone_table(cap["k10_tab0"])
    bufs = S.StepBuffers.select_only(st, sh.dev)
    bufs.state = cap["k10_state0"].clone()
    bufs.run = torch.ones(1, dtype=torch.int32, device=sh.dev)
    bufs.pend = torch.empty_like(sh.bufs.pend)
    pend_at, recv = cap["k10_pend_at"], cap["k10_recv"]
    bufs.pend[pend_at - n_front:pend_at - n_front + rows.shape[0]].copy_(rows)
    bufs.lane_cur, bufs.lane_dest = (torch.empty_like(sh.bufs.lane_cur) for _ in range(2))
    bufs.tail = torch.empty_like(sh.bufs.tail)
    ctr = cap["k10_ctr0"].clone()

    def restore10():
        for f in fields:
            getattr(tab_k, f).copy_(getattr(cap["k10_tab0"], f))
        bufs.state.copy_(cap["k10_state0"])
        ctr.copy_(cap["k10_ctr0"])

    # the kernel on the captured inputs again, against the plain version
    restore10()
    S.insert_pending_cuda(st, tab_k, bufs, ctr, cap["fill"], pend_at, recv)
    torch.cuda.synchronize()
    bad = [f for f in fields if not torch.equal(getattr(tab_k, f)[:C], getattr(tab, f)[:C])]
    if not torch.equal(ctr, c) or int(bufs.state[S.STATE_CALLS]) != rounds:
        bad.append(f"counters {ctr.tolist()} vs {c.tolist()}, or rounds")
    if bad:
        fail(f"K10 on received rows ({layout}), run again, differs from its plain version: {bad}")
    n_list = int(rows.shape[0])
    unsettled = [int(v) for v in bufs.state[S.STATE_CNT:S.STATE_CNT + rounds].tolist()]
    path = S.k10_path(n_list, rounds, unsettled[0] if rounds else 0, S.K10_CAP)
    report("keyrow_insert_recv", 0,
           lambda: S.insert_pending_cuda(st, tab_k, bufs, ctr, cap["fill"], pend_at, recv),
           lambda: SH.insert_pending_plain(st, tab_k, layout, rows, n_front),
           rows.shape[0] * (pw + W) * 4 + changed, restore=restore10)
    k10 = out["keyrow_insert_recv"]
    k10.update(lanes=n_list, received=n_front, rounds=rounds, overflow=ovf,
               changed_bytes=changed, path=path, list=n_list, unsettled=unsettled)
    args = S._keyrow_insert_args(st, tab_k, bufs, ctr, cap["fill"], 0, S.K10_CAP,
                                 torch.cuda.current_stream().cuda_stream, pend_at=pend_at,
                                 recv=recv)
    if k10_phase_fns is not None:
        k10["phases"] = k10_phases(k10_phase_fns, args, bufs.tail, restore10)
        print(f"    K10 phases ({path} path, {n_list} lanes, K10_PHASES build, block 0's "
              f"%globaltimer, median of 20): {k10_phase_line(k10['phases'])}")
    if baseline is not None and "keyrow_insert_recv" in baseline:
        k10["baseline"] = k10_turns(
            f"K10 on received rows ({layout}, step {cap['at']})", baseline, args, restore10,
            lambda: [getattr(tab_k, f)[:C].clone() for f in fields]
            + [ctr.clone(), bufs.state[S.STATE_CALLS:].clone()])
    # K7's hop mode on every shard's table from every path node
    checked, err = 0, 0
    for shd in shards:
        for coord in cap["path"]:
            k = S.walk_hops_cuda(st, shd.tab, coord, SH.WALK_HOPS, layout).cpu()
            p = SH.walk_hops_plain(st, shd.tab, coord, SH.WALK_HOPS, layout)
            err = max(err, int((k.long() - p.long()).abs().max()))
            checked += 1
    if err:
        fail(f"K7 hop mode on {layout} rows differs from its plain version by {err}")
    final = [int(v) for v in eng.problem.final_coord]
    owner = next(x for x in shards if int(SH.walk_hops_plain(st, x.tab, final, 1, layout)[-1]))
    out["walk"] = sharded_walk_bytes(st, shards, final, layout)
    wb = walk_bytes(st, owner.tab, layout, final, SH.WALK_HOPS, SH.WALK_HOPS + st.n + 1)
    report("path_walk_hops", err,
           lambda: S.walk_hops_cuda(st, owner.tab, final, SH.WALK_HOPS, layout),
           lambda: SH.walk_hops_plain(st, owner.tab, final, SH.WALK_HOPS, layout), wb["bytes"])
    out["path_walk_hops"].update(checked_calls=checked, lookups=wb["lookups"],
                                 probe_rows=wb["probe_rows"])
    return out


def run_ranks(argv, ranks: int, timeout: int, label: str):
    """``argv`` as ``ranks`` processes of one torch.distributed group
    (NCCL for the shards' tensors, gloo for the problem's broadcast), a
    card each; every process is stopped at ``timeout`` seconds.  Returns
    each rank's output and the wall."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    t0 = time.perf_counter()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))[0])
    except subprocess.TimeoutExpired:
        fail(f"{label} of {ranks} ranks exceeded {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{label}, rank {rank}: exit {p.returncode}\n{text[-3000:]}")
    return outs, time.perf_counter() - t0


def process_mesh_run(path: str, gold: dict, ranks: int, timeout: int = 400) -> dict:
    """Kinase on a ProcessMesh of ``ranks`` NCCL ranks, a card each: the
    CLI (``--exchange auto``: ragged, as JAX's on cards, under the chunked
    driver, each rank replaying its own step graphs with the mesh's
    collectives captured in them and its exchange reading the other ranks'
    wires through CUDA IPC), every rank the golden Final Score; then
    tools/process_mesh_turns.py, the engine in turns (ragged chunked,
    ragged host, dense chunked, ragged chunked; chunks of 256), every rank
    each time the golden g and alignment, the chunked driver one host read
    a chunk and the host driver one a step, and the same table words
    under both drivers of one exchange (a hash a rank); each rank's
    driver, host reads, wire rows and wall a step and peak memory
    printed."""
    outs, wall = run_ranks([sys.executable, "-m", "mpi_pastar_msa_tpu_torch", "--engine",
                            "frontier", "--devices", str(ranks), path], ranks, timeout,
                           "ProcessMesh CLI run")
    want = f"g - {gold['optimal_g']} "
    for rank, text in enumerate(outs):
        if want not in text or "driver chunked," not in text or "exchange ragged " not in text:
            fail(f"ProcessMesh rank {rank}: no {want.strip()} under the chunked driver and "
                 f"the ragged exchange\n{text[-3000:]}")
    line = next((l for l in outs[0].splitlines() if l.startswith("sharded:")), "")
    print(f"kinase on a ProcessMesh of {ranks} ranks (NCCL, a card each), the CLI: every rank "
          f"{want.strip()} in {wall:.1f} s; rank 0: {line}")
    order = [("chunked", "ragged"), ("host", "ragged"), ("chunked", "dense"),
             ("chunked", "ragged")]
    touts, twall = run_ranks([sys.executable, os.path.join("tools", "process_mesh_turns.py"),
                              path, "--drivers", ",".join(d for d, _ in order),
                              "--exchange", ",".join(x for _, x in order)], ranks, timeout,
                             "ProcessMesh turns")
    runs = []
    for rank, text in enumerate(touts):
        mine = [json.loads(l.split(" ", 1)[1]) for l in text.splitlines()
                if l.startswith("RANK_RUN ")]
        if [(r["driver"], r["exchange"]) for r in mine] != order:
            fail(f"ProcessMesh turns, rank {rank}: runs "
                 f"{[(r['driver'], r['exchange']) for r in mine]}\n{text[-3000:]}")
        for r in mine:
            steps = max(r["steps"], 1)
            reads = -(-steps // 256) if r["driver"] == "chunked" else steps
            if (r["g"] != gold["optimal_g"] or r["alignment"] != gold["alignment"]
                    or r["host_reads"] != reads):
                fail(f"ProcessMesh turns, rank {rank}, {r['driver']} {r['exchange']}: g "
                     f"{r['g']}, {r['host_reads']} host reads for {steps} steps, alignment "
                     f"golden {r['alignment'] == gold['alignment']}")
            r.pop("alignment")
        for x in ("ragged", "dense"):
            if len({r["hash"] for r in mine if r["exchange"] == x}) != 1:
                fail(f"ProcessMesh turns, rank {rank}: the drivers' table words differ "
                     f"under the {x} exchange")
        runs.append(mine)
        print(f"  rank {rank}: " + "; ".join(
            f"{r['driver']} {r['exchange']} g {r['g']}, {r['host_reads_a_step']:.4f} host reads "
            f"a step, {r['wire_rows_a_step']:.1f} wire rows a step, {r['step_ms']:.3f} ms a "
            f"step ({r['step_ms_no_capture']:.3f} without the captures: {r['capture_parts']}), "
            f"peak {r['peak_bytes'] / 2**20:.1f} MiB, walk {r['walk_reads']} reads; launches "
            f"{ {k: r['launches'].get(k, 0) for k in LOOP_KERNELS} }" for r in mine))
    return dict(ranks=ranks, wall_s=wall, rank0=line, turns=runs, turns_wall_s=twall,
                order=order)


def loop_words(eng) -> list:
    """Every tensor a sharded run's step leaves that does not depend on the
    order lanes run in, named: each shard's table, counters, step state,
    both rings and which is current, received count, insert flag, the
    route's out, candidate rows and wire; the card's consensus vector (the
    telemetry)."""
    from mpi_pastar_msa_tpu_torch.search import step as S

    out = []
    for sh in eng.shards:
        out += [(f"{sh.me}.{f}", getattr(sh.tab, f)) for f in sh.tab.__dataclass_fields__]
        out += [(f"{sh.me}.{k}", t) for k, t in (
            ("ctr", sh.ctr), ("state", sh.state[:S.STATE_CNT]), ("ring0", sh.rings[0]),
            ("ring1", sh.rings[1]), ("cur", torch.tensor(sh.cur)), ("recv", sh.recv),
            ("go", sh.go), ("route_out", sh.route_out), ("cand", sh.cand), ("wire", sh.wire),
            ("ring_len", sh.ring_len), ("tally", sh.tally))]
    return out + [("cons", eng.cards[0].cons)]


@contextlib.contextmanager
def split_cards(groups):
    """The sharded engine's shards grouped into the cards ``groups``
    (positions of the local shards) in place of one card a device: the
    several-card step on one card."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    saved = SH._card_groups
    SH._card_groups = lambda devices: groups
    try:
        yield
    finally:
        SH._card_groups = saved


@contextlib.contextmanager
def rank_form():
    """The sharded engine's LocalMesh in the step's rank form (a card a
    shard, the mesh's collectives as copies into each rank's buffers, the
    dense exchange from each rank's received blocks): the step graph a
    ProcessMesh rank captures, with copies in NCCL's places, on one card
    (NCCL takes one rank a card)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    saved = SH._rank_form
    SH._rank_form = lambda mesh: True
    try:
        yield
    finally:
        SH._rank_form = saved


def words_equal(label: str, a, b) -> int:
    """Two finished runs' loop_words bit for bit (and every card's
    consensus vector of ``a`` the same): the number of tensors."""
    wa, wb = loop_words(a), loop_words(b)
    diff = [k for (k, x), (_, y) in zip(wa, wb) if not torch.equal(x, y)]
    diff += [f"card {i} cons" for i, c in enumerate(a.cards)
             if not torch.equal(c.cons.cpu(), a.cards[0].cons.cpu())]
    if diff or len(wa) != len(wb):
        fail(f"{label}: the chunked run differs from the host driver's: {diff[:8]}")
    return len(wa)


def split_consensus_check(eng, floor: dict) -> dict:
    """On a finished several-card run (split_cards): the first card's
    consensus over every shard's snapshot (report_table's three addresses
    a shard), its own shards the targets, against consensus_plain on the
    same card tensors with the run flag at 1, bit for bit; timed as
    timed_check from its inputs restored."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    card = eng.cards[0]
    dev = card.dev
    args = (eng.ndev, eng.exchange_cap, eng.exchange == "ragged", eng.layout, eng.st.nb,
            eng.st.f0, card.shards[0].ccar)
    tg0 = [tuple(t.clone() for t in x[:4]) + (x[4],) for x in card.targets()]
    cons0, run0 = card.cons.clone(), torch.ones(1, dtype=torch.int32, device=dev)
    outs = []
    for kernel in (True, False):
        tg = [tuple(t.clone() for t in x[:4]) + (x[4],) for x in tg0]
        cons, run = cons0.clone(), run0.clone()
        if kernel:
            SH.consensus_cuda(SH.report_table(card.reports), *args, run,
                              SH.target_table(tg, dev), cons)
        else:
            SH.consensus_plain(card.reports, *args, run, tg, cons)
        torch.cuda.synchronize()
        outs.append([cons, run] + [t for x in tg for t in x[:4]])
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(*outs))
    if err:
        fail(f"consensus over the snapshots of two cards differs from its plain version by {err}")
    tg = [tuple(t.clone() for t in x[:4]) + (x[4],) for x in tg0]
    cons, run = cons0.clone(), run0.clone()
    rtab, tgt = SH.report_table(card.reports), SH.target_table(tg, dev)

    def restore():
        for x, x0 in zip(tg, tg0):
            for t, t0 in zip(x[:4], x0[:4]):
                t.copy_(t0)
        cons.copy_(cons0)
        run.copy_(run0)

    out = {}
    ndev = eng.ndev
    nbytes = (ndev * (SH.R_ROUTE + ndev + 3) * 8 + (SH.C_HEAD + 4 * ndev) * 8
              + SH.cons_words(ndev) * 8 + 8 + len(tg) * (8 + 4 * 8 + 4 + 4))
    timed_check(out, "consensus", err, lambda: SH.consensus_cuda(rtab, *args, run, tgt, cons),
                lambda: SH.consensus_plain(card.reports, *args, run, tg, cons), nbytes,
                restore=restore)
    out["consensus"].update(launch_floor_ms=floor["device_ms"], targets=len(tg), reports=ndev,
                            cards=len(eng.cards))
    return out["consensus"]


def rank_exchange_check(cap: dict, eng, floor: dict) -> dict:
    """The rank form's exchange at the captured step (sharded_guard's
    ``xr``: every rank's consensus vector, its exchange's source, pending
    list and insert flag before its exchange, and its pending list after):
    on each rank the kernel from the captured inputs, exchange_plain on the
    same, and the run's own output, bit for bit; the source is the rank's
    received blocks under the dense exchange (``received``: sender i's rows
    at row i cap), checked also against exchange_plain over the senders'
    own wires at that step (the card form's reading), or every rank's wire
    by address under the ragged one.  Timed on the rank that receives the
    most rows as timed_check (the rows read and written, the flag, A's
    column)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    ndev, xcap = eng.ndev, eng.exchange_cap
    ranks = cap.get("xr", [])
    if len(ranks) != ndev:
        fail(f"rank form: {len(ranks)} ranks' exchanges captured, want {ndev}")
    ragged = eng.exchange == "ragged"

    def args_of(x):
        wires = x["wires"] if ragged else [x["recv"]] * ndev
        return wires, (x["cons"], ndev, xcap, ragged, x["R"])

    err, best = 0, None
    for x in ranks:
        pw, me = x["pw"], x["me"]
        outs = []
        for way in ("kernel", "plain") + (() if ragged else ("senders",)):
            pend = x["pend0"].clone()
            wires, head = args_of(x)
            if way == "kernel":
                SH.exchange_cuda(*head, pw, SH.exchange_table(wires, [pend], [x["go"]], [me]),
                                 received=not ragged)
            elif way == "plain":
                SH.exchange_plain(*head, wires, [pend], [x["go"]], [me], received=not ragged)
            else:
                SH.exchange_plain(*head, cap["x_wires"], [pend], [x["go"]], [me])
            torch.cuda.synchronize()
            outs.append(pend)
        outs.append(x["pend1"])
        err = max(err, *(int((outs[0].long() - o.long()).abs().max()) for o in outs[1:]))
        rows = int(SH.cons_sizes(x["cons"], ndev)[:, me].sum()) if int(x["go"][0]) else 0
        if best is None or rows > best[0]:
            best = (rows, x)
    what = "every rank's wire by address" if ragged else "the received blocks"
    if err:
        fail(f"exchange over {what} differs from its plain version by {err}")
    rows, x = best
    pw, me = x["pw"], x["me"]
    pend = x["pend0"].clone()
    wires, head = args_of(x)
    xtab = SH.exchange_table(wires, [pend], [x["go"]], [me])
    out, name = {}, "exchange_mapped" if ragged else "exchange_received"
    timed_check(out, name, err,
                lambda: SH.exchange_cuda(*head, pw, xtab, received=not ragged),
                lambda: SH.exchange_plain(*head, wires, [pend], [x["go"]], [me],
                                          received=not ragged),
                rows * pw * 4 * 2 + 4 + ndev * 8, restore=lambda: pend.copy_(x["pend0"]))
    out = out[name]
    sizes = SH.cons_sizes(x["cons"], ndev).cpu().tolist()
    out.update(launch_floor_ms=floor["device_ms"], rows=rows, row_words=pw, ranks=ndev,
               rank=me, sizes=sizes, step=cap["at"], exchange=eng.exchange)
    if rows <= 0:
        fail(f"rank form: no rank received a row at step {cap['at']}: A {sizes}")
    print(f"  rank form, step {cap['at']}, {eng.exchange}: every rank's exchange over {what} "
          f"equal to its plain version and to the run's"
          + ("" if ragged else " and to the senders' wires")
          + f"; rank {me} {rows} rows of {pw} words (A {sizes})")
    return out


def rank_form_phase(path: str, gold: dict, floor: dict) -> dict:
    """Kinase on [cuda:0] * 4 in the rank form (``rank_form``) under each
    exchange, ragged (auto on cards: every rank's exchange reading the
    senders' wires by address, the mesh's ``map_peers``, as a ProcessMesh
    rank reads them mapped through CUDA IPC) and dense (each rank's
    received blocks): the chunked driver (a ProcessMesh's step graph on
    one card, each rank's collectives captured as copies; a chunk 256
    replays of the two parity graphs, the four ranks in one graph a parity
    here), then the host driver on the same form with step 200 captured:
    g = 421546 and the golden alignment each, every table word equal
    between the drivers, the chunked run one host read a chunk in the
    search and in the walk (kinase: 3 for 525 steps, 3 for its rounds),
    the host driver's one a step; each wall a step with and without the
    captures; every rank's exchange at step 200 against its plain version
    (rank_exchange_check).  Returns the ragged run's record, the dense
    one's under "dense"."""
    from mpi_pastar_msa_tpu_torch.parallel.sharded import WALK_ROUNDS

    card = torch.device("cuda", 0)
    res = {}
    for exchange in ("ragged", "dense"):
        label = f"kinase sharded 4, rank form (copies in NCCL's places), {exchange}"
        with rank_form():
            out, re, _ = sharded_run(label, path, gold, [card] * 4, True, exchange=exchange,
                                     driver="chunked")
            host, he, cap = sharded_run(f"{label}, host driver", path, gold, [card] * 4, True,
                                        capture_step=200, exchange=exchange, driver="host")
        steps = max(out["steps"], 1)
        if (out["card_form"] or host["card_form"] or out["cards"] != 4
                or out["driver"] != "chunked" or out["exchange"] != exchange
                or out["host_reads"] != -(-steps // 256) or out["graph_captures"] != 2
                or host["host_reads"] != host["steps"]
                or out["walk_reads"] != -(-out["walk_rounds"] // WALK_ROUNDS)):
            fail(f"{label}: card form {out['card_form']}, {out['cards']} cards, driver "
                 f"{out['driver']}, exchange {out['exchange']}, {out['host_reads']} host "
                 f"reads for {steps} steps (host driver {host['host_reads']} for "
                 f"{host['steps']}), {out['graph_captures']} captures, {out['walk_reads']} "
                 f"walk reads for {out['walk_rounds']} rounds")
        out["words_equal"] = words_equal(f"{label} against the host driver", re, he)
        out["host_driver"] = {k: host[k] for k in ("step_wall_ms", "host_reads", "walk_reads",
                                                    "steps", "launches")}
        out["exchange_check"] = rank_exchange_check(cap, he, floor)
        del re, he, cap
        print(f"  {label}: {out['host_reads']} host reads for {out['steps']} steps "
              f"({out['host_reads_a_step']:.4f} a step), walk {out['walk_reads']} reads for "
              f"{out['walk_rounds']} rounds; a step {out['step_wall_ms']:.3f} ms, "
              f"{out['step_wall_no_capture_ms']:.3f} without the captures; equal to the host "
              f"driver ({host['step_wall_ms']:.3f} ms a step, {host['host_reads']} reads) on "
              f"{out['words_equal']} tensors")
        res[exchange] = out
    out = res["ragged"]
    out["dense"] = res["dense"]
    return out


def ipc_check(floor: dict) -> dict:
    """The ragged exchange of a ProcessMesh of cards from another process's
    wire, on this one card: two processes (tools/ipc_exchange_check.py
    --one-card; gloo carries the handles), each mapping the other's wire
    through CUDA IPC and running ``exchange`` from it, bit for bit with
    exchange_plain in every case; the kernel's and the plain version's
    times on kinase's sizes, its bound by bytes (both wires on this card:
    its memory's rate)."""
    outs, wall = run_ranks([sys.executable, os.path.join("tools", "ipc_exchange_check.py"),
                            "--one-card"], 2, 300, "IPC exchange check")
    ranks = []
    for rank, text in enumerate(outs):
        line = next((l for l in text.splitlines() if l.startswith("IPC_CHECK ")), None)
        if line is None:
            fail(f"IPC exchange check, rank {rank}: no result\n{text[-3000:]}")
        r = json.loads(line.split(" ", 1)[1])
        if r["max_abs_err"] or r["device"] != "cuda:0" or any(
                c["max_abs_err"] or c["rows"] <= 0 for c in r["cases"]):
            fail(f"IPC exchange check, rank {rank}: {r}")
        ranks.append(r)
    timed = [r["cases"][0] for r in ranks]
    best = max(timed, key=lambda c: c["rows"])
    out = dict(ranks=ranks, wall_s=wall, ms=best["ms"], device_ms=best["device_ms"],
               plain_ms=best["plain_ms"], rows=best["rows"], row_words=best["row_words"],
               bytes=best["bytes"], remote_bytes=best["remote_bytes"],
               bound_ms=best["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               launch_floor_ms=floor["device_ms"], max_abs_err=0)
    print(f"IPC exchange check: 2 processes on one card, each exchange from the other's "
          f"mapped wire equal to exchange_plain in {len(ranks[0]['cases'])} cases; at kinase's "
          f"sizes {best['rows']} rows of {best['row_words']} words: wrapper {best['ms']:.4f} ms "
          f"(CUDA events), device {best['device_ms']:.4f} ms, plain {best['plain_ms']:.4f} ms, "
          f"bound {out['bound_ms']:.6f} ms "
          f"(bytes); {wall:.1f} s with the processes' start")
    return out


def driver_turns(label: str, path: str, steps: int = 256, **kw):
    """One engine on [cuda:0] * 4 (``kw``: its layout and the rest), run
    ``steps`` steps (one chunk) under the chunked driver, ``steps``
    replays of the two step graphs, then the same steps under the host
    driver: every table tensor, ring,
    counter and telemetry word of the two equal (loop_words), and each
    driver's wall a step (the chunked one with and without its capture).
    Returns (report, the engine, ready for a full run: max_steps and
    chunk_steps the defaults, the host driver)."""
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.parallel.sharded import ShardedFrontierSearch

    card = torch.device("cuda", 0)
    eng = ShardedFrontierSearch(problem_from_fasta(path), devices=[card] * 4, max_steps=steps,
                                chunk_steps=steps, **kw)
    words, stats = {}, {}
    for driver in ("chunked", "host"):
        eng.driver = driver
        try:
            eng.run()
        except RuntimeError as e:
            if "max_steps exceeded" not in str(e):
                raise
        torch.cuda.synchronize()
        words[driver] = [(k, t.clone()) for k, t in loop_words(eng)]
        stats[driver] = dict(eng.last_stats)
    diff = [k for (k, a), (_, b) in zip(words["chunked"], words["host"]) if not torch.equal(a, b)]
    keys = ("steps", "wire_rows", "migrated", "peak_carry")
    if diff or any(stats["chunked"][k] != stats["host"][k] for k in keys):
        fail(f"{label}: {steps} steps of the chunked driver differ from the host driver's: "
             f"{diff[:8]}; {[(k, stats['chunked'][k], stats['host'][k]) for k in keys]}")
    c, h = stats["chunked"], stats["host"]
    n = max(c["steps"], 1)
    out = dict(layout=eng.layout, steps=c["steps"], words=len(words["host"]),
               word_bytes=sum(t.numel() * t.element_size() for _, t in words["host"]),
               chunked_step_ms=c["search_s"] / n * 1e3,
               chunked_step_no_capture_ms=(c["search_s"] - c["capture_s"]) / n * 1e3,
               capture_s=c["capture_s"], chunked_reads=c["host_reads"],
               capture_parts={k: c[k] for k in ("capture_warm_s", "capture_host_s",
                                                 "capture_instantiate_s")},
               host_step_ms=h["search_s"] / n * 1e3, host_reads=h["host_reads"])
    print(f"{label} ({eng.layout}), {c['steps']} steps in turns: chunked (step graphs) and host "
          f"drivers equal on {len(words['host'])} tensors ({out['word_bytes'] / 2**20:.1f} MiB: "
          f"tables, rings, counters, telemetry); a step {out['chunked_step_ms']:.3f} ms "
          f"({out['chunked_step_no_capture_ms']:.3f} without the capture of "
          f"{c['capture_s']:.3f} s: {out['capture_parts']}), {c['host_reads']} host read(s), "
          f"against "
          f"{out['host_step_ms']:.3f} ms and {h['host_reads']} reads")
    eng.shards = eng.cards = None  # free the tables before the full run
    eng.max_steps, eng.chunk_steps, eng.driver = 500_000, 256, "host"
    return out, eng


def loop_kernel_checks(cap: dict, floor: dict, k6s_baseline=None) -> dict:
    """The loop's kernels of the captured step (sharded_guard, host driver)
    against their plain versions on the card, bit for bit: the consensus
    (its vector, every shard's counters, state, received count and flag,
    the run flag) and the exchange (every receiver's pending list); each
    timed from its inputs restored (wrapper, device, plain) beside its
    bound by bytes and the launch floor; with ``k6s_baseline``, another
    tree's consensus checked the same way and timed in turns with this
    one (consensus_turns)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    out = {}
    report = functools.partial(timed_check, out)
    card, eng = cap["k6s_card"], cap["eng"]
    ndev, ragged = eng.ndev, eng.exchange == "ragged"
    args = (ndev, eng.exchange_cap, ragged, eng.layout, eng.st.nb, eng.st.f0,
            card.shards[0].ccar)
    # the reports: each shard's words where they lie (the card form), as
    # captured before the consensus
    rep = cap["k6s_rep"]
    tg = [tuple(t.clone() for t in x[:4]) + (x[4],) for x in cap["k6s_tg0"]]
    # a target's report words are its own counters and state (the live
    # words of one card): the copies stand in for both
    own = {x[4]: x for x in tg}
    rep = [(own[me][0], own[me][1], r[2]) if me in own else r for me, r in enumerate(rep)]
    run, cons = cap["k6s_run0"].clone(), cap["k6s_cons0"].clone()

    def restore_c():
        for x, x0 in zip(tg, cap["k6s_tg0"]):
            for t, t0 in zip(x[:4], x0[:4]):
                t.copy_(t0)
        run.copy_(cap["k6s_run0"])
        cons.copy_(cap["k6s_cons0"])

    SH.consensus_plain(rep, *args, run, tg, cons)
    got = [cons, run] + [t for x in tg for t in x[:4]]
    want = [cap["k6s_cons1"], cap["k6s_run1"]] + [t for x in cap["k6s_tg1"] for t in x[:4]]
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    if err:
        fail(f"consensus differs from its plain version by {err}")
    dev = cons.device
    tgt = SH.target_table(tg, dev)
    rtab = SH.report_table(rep)
    words = SH.cons_words(ndev)
    # the reports (each shard's words where they lie) and the telemetry
    # read, the vector written, each target's counters (goal), state (3
    # words and the pending count) and two flags (the tables' addresses
    # ride in the launch's parameters)
    nbytes = (ndev * (SH.R_ROUTE + ndev + 3) * 8 + (SH.C_HEAD + 4 * ndev) * 8 + words * 8
              + 8 + len(tg) * (8 + 4 * 8 + 4 + 4))
    restore_c()
    report("consensus", err, lambda: SH.consensus_cuda(rtab, *args, run, tgt, cons),
           lambda: SH.consensus_plain(rep, *args, run, tg, cons), nbytes, restore=restore_c)
    if k6s_baseline is not None and "consensus" in k6s_baseline:
        out["consensus"]["turns"] = consensus_turns(rep, args, run, tg, cons, restore_c, want,
                                                    k6s_baseline)
    A = SH.cons_sizes(cap["x_cons"], ndev).cpu().numpy()
    out["consensus"].update(launch_floor_ms=floor["device_ms"], targets=len(tg),
                            sizes=A.tolist(), stopped=int(cap["k6s_run1"][0]) == 0)
    # the exchange: the rows received by every shard of the card
    R, pw, me = cap["x_R"], cap["x_pw"], cap["x_me"]
    pends = [p.clone() for p in cap["x_pend0"]]
    SH.exchange_plain(cap["x_cons"], ndev, eng.exchange_cap, ragged, R, cap["x_wires"], pends,
                      cap["x_flags"], me)
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(pends, cap["x_pend1"]))
    if err:
        fail(f"exchange differs from its plain version by {err}")
    xtab = SH.exchange_table(cap["x_wires"], pends, cap["x_flags"], me)

    def restore_x():
        for p, p0 in zip(pends, cap["x_pend0"]):
            p.copy_(p0)

    # the rows moved, read and written once, each receiver's flag and A's
    # words it reads (its column, ragged the rows before it)
    rows = int(sum(A[:, r].sum() for r in me))
    nbytes = rows * pw * 4 * 2 + len(me) * 4 + sum(
        ndev * (r + 1 if ragged else 1) for r in me) * 8
    new_x = lambda: SH.exchange_cuda(cap["x_cons"], ndev, eng.exchange_cap, ragged, R, pw, xtab)
    report("exchange", err, new_x,
           lambda: SH.exchange_plain(cap["x_cons"], ndev, eng.exchange_cap, ragged, R,
                                     cap["x_wires"], pends, cap["x_flags"], me),
           nbytes, restore=restore_x)
    out["exchange"].update(launch_floor_ms=floor["device_ms"], rows=rows, row_words=pw)
    if k6s_baseline is not None and "exchange" in k6s_baseline:
        out["exchange"]["turns"] = exchange_turns(
            cap, ndev, eng.exchange_cap, ragged, pends, new_x, restore_x, k6s_baseline)
    print(f"  consensus: {len(tg)} targets, A {A.tolist()}; exchange: {rows} rows of {pw} words")
    return out


def start_k6s_baseline(src: str, tmp: str):
    """Start nvcc on another tree's K6s (``src``: its shard_loop.cu, or a
    checkout's root or csrc/ directory; built with the headers beside it)
    in its own directory; returns (src, the source file, proc, lib)."""
    from mpi_pastar_msa_tpu_torch import _kernels

    cu = src if os.path.isfile(src) else next(
        p for p in (os.path.join(src, "shard_loop.cu"),
                    os.path.join(src, "mpi_pastar_msa_tpu_torch", "csrc", "shard_loop.cu"))
        if os.path.isfile(p))
    out = os.path.join(tmp, "k6s_baseline")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libshard_loop.so")
    proc = subprocess.Popen(
        [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-I", os.path.dirname(os.path.abspath(cu)), "-o",
         lib, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return src, cu, proc, lib


# the C entry of the exchange before its address table rode in the
# launch's parameters: cons, ndev, cap, ragged, R, a row's words, then
# int64 tables on the card of the wires, pending lists, insert flags, the
# receivers' count and their indices, stream
EXCHANGE_DEVICE_TABLES_SIGNATURE = [_P] + [_I] * 5 + [_P] * 3 + [_I, _P, _P]


def load_k6s_baseline(job) -> dict:
    """The other tree's K6s (start_k6s_baseline): each C entry of
    K6S_BASELINE_FORMS whose form its source has (40505e8's consensus, its
    target table on the card; da6a26a's exchange, its address tables on
    the card; walk_advance of this tree's signature, its runs in a host
    table), bound with its argument types, and its source's name under
    ``src``; the turns of an entry it lacks are not run, and a source with
    none of the forms fails."""
    from mpi_pastar_msa_tpu_torch import _kernels

    src, cu, proc, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"K6s baseline: nvcc failed for shard_loop.cu of {src}:\n{log}")
    so, text = ctypes.CDLL(lib), open(cu).read()
    out = {"src": src}
    for name, mark, sig in K6S_BASELINE_FORMS:
        if mark in text:
            fn = getattr(so, name)
            fn.argtypes = sig or _kernels.SIGNATURES[name]
            fn.restype = ctypes.c_int
            out[name] = fn
    if len(out) == 1:
        fail(f"K6s baseline {src}: none of {[f[0] for f in K6S_BASELINE_FORMS]} in a form "
             f"its turns call")
    print(f"  K6s baseline {src}: {[k for k in out if k != 'src']} in turns with this tree's")
    return out


def exchange_turns(cap: dict, ndev: int, xcap: int, ragged: bool, pends, new, restore,
                   baseline: dict, reps: int = 20) -> dict:
    """Another tree's exchange (``baseline``: da6a26a's, its address tables
    on the card, each receiver's loads one after another) on the sharded
    step's inputs, its pending lists checked against this tree's result bit
    for bit, then the two timed in turns from the inputs restored (old,
    new, new, old): device ms (CUPTI) and ms a call (CUDA events)."""
    from mpi_pastar_msa_tpu_torch.search.step import _stream

    dev = pends[0].device
    ptrs = lambda ts: torch.tensor([t.data_ptr() for t in ts], dtype=torch.int64).to(dev)
    tables = (ptrs(cap["x_wires"]), ptrs(pends), ptrs(cap["x_flags"]),
              torch.tensor(cap["x_me"], dtype=torch.int64).to(dev))
    cargs = (cap["x_cons"].data_ptr(), ndev, xcap, int(ragged), cap["x_R"], cap["x_pw"],
             tables[0].data_ptr(), tables[1].data_ptr(), tables[2].data_ptr(), len(pends),
             tables[3].data_ptr(), _stream(dev))

    def old():
        if baseline["exchange"](*cargs):
            fail(f"exchange of {baseline['src']} failed to launch")

    restore()
    new()
    torch.cuda.synchronize()
    want = [p.clone() for p in pends]
    restore()
    old()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(pends, want)):
        fail(f"exchange of {baseline['src']} differs from this one")
    who = {"old": old, "new": new}
    res = {"device_ms": {"old": [], "new": []}, "ms": {"old": [], "new": []}}
    for w in ("old", "new", "new", "old"):
        res["device_ms"][w].append(device_ms(who[w], reps, restore))
        res["ms"][w].append(time_restored(who[w], restore, reps))
    print(f"  exchange in turns with {baseline['src']} (old, new, new, old): " + "; ".join(
        f"{k} {res[k]['old'][0]:.4f} / {res[k]['new'][0]:.4f} / {res[k]['new'][1]:.4f} / "
        f"{res[k]['old'][1]:.4f} ms" for k in res))
    return res


# the C entry of the consensus before its reports and targets were two
# tables (40505e8 to e0246c6): the gathered reports (or null: the targets' own words),
# ndev, cap, ragged, unpacked, n, f0, ring rows, run, a table of (counters,
# state, route out, received count, insert flag, index) a target, their
# count, cons, stream
CONSENSUS_TARGETS_SIGNATURE = [_P, _I, _I, _I, _I, _I, _L, _L, _P, _P, _I, _P, _P]

# the other tree's C entries that load_k6s_baseline binds, each where its
# source has the form its turns time: (name, a mark of that form in the
# source, argument types; None: this tree's)
K6S_BASELINE_FORMS = (
    ("consensus", "consensus(const void* rep, int ndev", CONSENSUS_TARGETS_SIGNATURE),
    ("exchange", "const void* wires, const void* pends", EXCHANGE_DEVICE_TABLES_SIGNATURE),
    ("walk_advance", "walk_advance(const void* wtab,", None))


def consensus_turns(rep, args, run, tg, cons, restore, want, baseline: dict,
                    reps: int = 20) -> dict:
    """Another tree's consensus (``baseline``: 40505e8's, one block, its
    target table on the card, the reports its targets' own words) checked
    against this tree's plain result ``want`` on the same inputs, bit for
    bit, then the two timed in turns from the inputs restored (old, new,
    new, old): device ms (CUPTI) and ms a call (CUDA events), both through
    a plain ctypes call of their C entries (this tree's reads its two
    tables in host memory)."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search.step import _stream

    ndev, cap, ragged, layout, nb, f0, ccar = args
    if isinstance(rep, torch.Tensor) or len(tg) != ndev:
        fail("consensus turns: the old C entry reads every shard's words as its targets")
    old_tab = torch.tensor([[c.data_ptr(), s_.data_ptr(), rep[me][2].data_ptr(), r.data_ptr(),
                             g.data_ptr(), me] for c, s_, r, g, me in tg],
                           dtype=torch.int64).to(cons.device)
    head = (ndev, cap, int(ragged), int(layout == "unpacked"), nb, f0, ccar, run.data_ptr())
    old_args = tuple(t(a) for t, a in zip(CONSENSUS_TARGETS_SIGNATURE, (None,) + head + (
        old_tab.data_ptr(), len(tg), cons.data_ptr(), _stream(cons.device))))
    rtab, tgt = SH.report_table(rep), SH.target_table(tg, cons.device)
    new_args = tuple(t(a) for t, a in zip(_kernels.SIGNATURES["consensus"], (
        rtab.data_ptr(), rtab.shape[1]) + head + (tgt.data_ptr(), len(tg), cons.data_ptr(),
                                                  _stream(cons.device))))

    def bound(fn, cargs):
        def go():
            if fn(*cargs):
                fail(f"consensus of {baseline['src']} failed to launch")
        return go

    who = {"old": bound(baseline["consensus"], old_args),
           "new": bound(getattr(_kernels.load("consensus"), "consensus"), new_args)}
    restore()
    who["old"]()
    torch.cuda.synchronize()
    got = [cons, run] + [t for x in tg for t in x[:4]]
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    if err:
        fail(f"consensus of {baseline['src']} differs from the plain version by {err}")
    res = {"device_ms": {"old": [], "new": []}, "ms": {"old": [], "new": []}}
    for w in ("old", "new", "new", "old"):
        res["device_ms"][w].append(device_ms(who[w], reps, restore))
        res["ms"][w].append(time_restored(who[w], restore, reps))
    print(f"  consensus in turns with {baseline['src']} (old, new, new, old): " + "; ".join(
        f"{k} {res[k]['old'][0]:.4f} / {res[k]['new'][0]:.4f} / {res[k]['new'][1]:.4f} / "
        f"{res[k]['old'][1]:.4f} ms" for k in res))
    return res


def walk_round_spans(eng, shards, rounds: int) -> dict:
    """The walk loop's round form (``eng._walk_loop``) traced with torch.profiler
    (CUPTI): for each of its first ``rounds`` rounds after the warm-up (the
    rounds whose flag is 1), the device span from the round's first
    path_walk_hops start to walk_advance's end, walk_advance's start after
    the round's last path_walk_hops' end (negative where its launch
    overlapped that kernel's drain) and walk_advance's own time; the
    median and the range of each, in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_preamble()
        eng._walk_loop(shards, form="rounds")
        torch.cuda.synchronize()
    ks = sorted((e.time_range.start, e.time_range.end, "walk_advance_kernel" in e.name)
                for e in prof.events() if e.device_type == DeviceType.CUDA
                and ("walk_advance_kernel" in e.name or "path_walk_kernel" in e.name))
    spans, gaps, own = [], [], []
    first = last = None
    for a, b, advance in ks:
        if not advance:
            first = a if first is None else first
            last = b
        elif first is not None:
            spans.append(b - first)
            gaps.append(a - last)
            own.append(b - a)
            first = None
    if len(spans) < rounds + 1:
        fail(f"the walk loop's trace holds {len(spans)} rounds, want at least {rounds + 1}")
    stat = lambda us: dict(median_ms=statistics.median(us) / 1e3, min_ms=min(us) / 1e3,
                           max_ms=max(us) / 1e3)
    keep = slice(1, rounds + 1)  # the warm-up round (flags 0) comes first
    return dict(rounds=rounds, span=stat(spans[keep]), start_after_walk=stat(gaps[keep]),
                walk_advance=stat(own[keep]))


def walk_turns(eng, host, wtab, hops: int, n: int, kern, restore, baseline: dict,
               reps: int = 20) -> dict:
    """Another tree's walk_advance (``baseline``: 2dd56fa's, one warp, the
    coordinate's words one round trip each) on the first round's runs, its
    walk state checked against this tree's result bit for bit, then the two
    timed in turns from the state restored (old, new, new, old): device ms
    (CUPTI) and ms a call (CUDA events), both a plain ctypes call of their
    C entries.  Then the walk loop in turns with each kernel in it (old,
    new, new, old; the old one launched on a full edge, this one on a
    programmatic edge): each loop's masks and rounds against the host
    walk's (``host``), its wall split into the warm-up round, the capture
    and the replays with their reads, and a round's device span and
    walk_advance's start after the round's last walk (walk_round_spans,
    medians)."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search.step import _stream

    def entry(fn, what):
        def go(wtab, hops, n, params, masks, wst, wrun):
            if fn(wtab.data_ptr(), wtab.numel(), hops, n, params.data_ptr(), masks.data_ptr(),
                  masks.numel(), wst.data_ptr(), wrun.data_ptr(), _stream(params.device)):
                fail(f"walk_advance of {what} failed to launch")
        return go

    who = {"old": entry(baseline["walk_advance"], baseline["src"]),
           "new": entry(getattr(_kernels.load("walk_advance"), "walk_advance"), "this tree")}
    restore()
    who["new"](wtab, hops, n, *kern)
    torch.cuda.synchronize()
    want = [t.clone() for t in kern]
    restore()
    who["old"](wtab, hops, n, *kern)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(kern, want)):
        fail("walk_advance of the baseline differs from this one")
    res = {"device_ms": {"old": [], "new": []}, "ms": {"old": [], "new": []}}
    for w in ("old", "new", "new", "old"):
        call = functools.partial(who[w], wtab, hops, n, *kern)
        res["device_ms"][w].append(device_ms(call, reps, restore))
        res["ms"][w].append(time_restored(call, restore, reps))
    loop = {k: {w: [] for w in who} for k in (
        "wall_ms", "warm_ms", "capture_ms", "replays_ms", "span_ms", "start_after_walk_ms")}
    cuda_fn = SH.walk_advance_cuda
    for w in ("old", "new", "new", "old"):
        SH.walk_advance_cuda = who[w]
        try:
            stats = {}
            t0 = time.perf_counter()
            masks, rounds, _ = eng._walk_loop(eng.shards, stats, form="rounds")
            wall = (time.perf_counter() - t0) * 1e3
            if (masks, rounds) != host:
                fail(f"the walk loop with walk_advance {w} differs from the host walk")
            spans = walk_round_spans(eng, eng.shards, rounds)
        finally:
            SH.walk_advance_cuda = cuda_fn
        warm, capture = stats["walk_warm_s"] * 1e3, stats["walk_capture_s"] * 1e3
        for k, v in (("wall_ms", wall), ("warm_ms", warm), ("capture_ms", capture),
                     ("replays_ms", wall - warm - capture),
                     ("span_ms", spans["span"]["median_ms"]),
                     ("start_after_walk_ms", spans["start_after_walk"]["median_ms"])):
            loop[k][w].append(v)
    res["loop"] = loop
    print(f"  walk_advance in turns with {baseline['src']} (old, new, new, old): " + "; ".join(
        f"{k} {res[k]['old'][0]:.4f} / {res[k]['new'][0]:.4f} / {res[k]['new'][1]:.4f} / "
        f"{res[k]['old'][1]:.4f} ms" for k in ("device_ms", "ms")))
    print("  the walk loop in turns (old, new, new, old): " + "; ".join(
        f"{k} {v['old'][0]:.4f} / {v['new'][0]:.4f} / {v['new'][1]:.4f} / {v['old'][1]:.4f}"
        for k, v in loop.items()))
    return res


def one_warp_floor(reps: int = 20) -> dict:
    """The device time (CUPTI) under a one-warp kernel of one launch:
    pointer_chase (csrc/path_walk.cu, one thread) with 0 hops (a launch
    and one store), 1 hop and 2 hops (one and two dependent loads before
    the store, over a 4 KiB cycle that stays in L2), in ms."""
    fn = pointer_chase()
    nxt = ((torch.arange(1024, dtype=torch.int32) * 97 + 1) % 1024).cuda()
    out = torch.zeros(1, dtype=torch.int32, device="cuda")

    def chase(hops):
        def go():
            if fn(nxt.data_ptr(), hops, out.data_ptr(), torch.cuda.current_stream().cuda_stream):
                fail("pointer_chase failed to launch")
        return go

    return {f"{h}_hops": device_ms(chase(h), reps) for h in (0, 1, 2)}


def walk_loop_check(eng, floor: dict, chase: dict, baseline=None) -> dict:
    """On the finished tables of a chunked run on one card: the walk's two
    forms, its one launch (path_walk_shards, one read) and its device loop
    of rounds (WALK_ROUNDS rounds a graph replay, walk_advance over a
    programmatic edge from the round's last walk), against the host walk,
    the same masks and rounds, each form's wall in turns (launch, rounds,
    rounds, launch), the one launch's device time (walk_shards_check) and
    each round's device span (walk_round_spans); walk_advance on the first
    round's runs against its plain version, timed from its inputs restored
    (wrapper, device, plain) beside its bound by bytes and the launch
    floor; with ``baseline``, another tree's walk_advance in turns with
    this one (walk_turns)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    shards, st = eng.shards, eng.st
    with walk_edges() as (edges, _):
        t0 = time.perf_counter()
        masks, rounds, reads = eng._walk_loop(shards, form="rounds")
        loop_s = time.perf_counter() - t0
    # walk_advance captured over a programmatic edge from the round's last walk
    if set(edges) != {"kernel:programmatic"}:
        fail(f"the walk's round form: walk_advance's edges in the captured round "
             f"{dict(edges)}, want one programmatic edge from a kernel")
    t0 = time.perf_counter()
    h_masks, h_rounds = eng._walk(shards)
    host_s = time.perf_counter() - t0
    if masks != h_masks or rounds != h_rounds:
        fail(f"the walk loop's {len(masks)} masks in {rounds} rounds differ from the host "
             f"walk's {len(h_masks)} in {h_rounds}")
    forms = {"launch": [], "rounds": []}
    for form in ("launch", "rounds", "rounds", "launch"):
        t0 = time.perf_counter()
        got = eng._walk_loop(shards, form=form)
        forms[form].append((time.perf_counter() - t0) * 1e3)
        if got[:2] != (h_masks, h_rounds) or got[2] != (1 if form == "launch" else reads):
            fail(f"the walk's {form} form: {len(got[0])} masks in {got[1]} rounds and {got[2]} "
                 f"reads, the host walk's {len(h_masks)} in {h_rounds}")
    print("  the walk's forms in turns (launch, rounds, rounds, launch), wall ms: "
          f"{forms['launch'][0]:.3f} / {forms['rounds'][0]:.3f} / {forms['rounds'][1]:.3f} / "
          f"{forms['launch'][1]:.3f}")
    spans = walk_round_spans(eng, shards, rounds)
    one = walk_shards_check(eng, chase, (h_masks, h_rounds))
    n, hops, dev = st.n, SH.WALK_HOPS, shards[0].dev
    final = [int(v) for v in eng.problem.final_coord]
    i32 = dict(dtype=torch.int32, device=dev)
    params0 = torch.tensor(final + list(st.bitw), dtype=torch.int32).to(dev)
    # each shard's run a tensor of its own, read by its address
    wout = [torch.zeros(hops + n + 1, **i32) for _ in shards]
    for sh in shards:
        sh.walk_hops(params0, hops, out=wout[sh.me])
    wtab = SH.run_table(wout, hops, n)
    state0 = [params0, torch.zeros(sum(final) + hops, **i32), torch.zeros(2, **i32),
              torch.ones(1, **i32)]
    kern = [t.clone() for t in state0]
    plain = [t.clone() for t in state0]
    SH.walk_advance_cuda(wtab, hops, n, *kern)
    SH.walk_advance_plain(wout, hops, n, *plain)
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(kern, plain))
    if err:
        fail(f"walk_advance differs from its plain version by {err}")

    def restore():
        for t, t0_ in zip(kern, state0):
            t.copy_(t0_)

    emitted = int(kern[2][0])
    out = {}
    # the runs read, the coordinate read and written, the masks emitted,
    # the counts and the flag
    timed_check(out, "walk_advance", err, lambda: SH.walk_advance_cuda(wtab, hops, n, *kern),
                lambda: SH.walk_advance_plain(wout, hops, n, *kern),
                eng.ndev * hops * 4 + 2 * n * 4 + emitted * 4 + 2 * 8 + 2 * 4, restore=restore)
    warp = one_warp_floor()
    out["walk_advance"].update(launch_floor_ms=floor["device_ms"], emitted=emitted,
                               round_span=spans, one_warp_floor_ms=warp)
    print("  a one-warp launch's floor (pointer_chase, device): " + ", ".join(
        f"{k.replace('_', ' ')} {v:.5f} ms" for k, v in warp.items()))
    if baseline is not None and "walk_advance" in baseline:
        out["walk_advance"]["turns"] = walk_turns(eng, (h_masks, h_rounds), wtab, hops, n,
                                                  kern, restore, baseline)
    out.update(masks=len(masks), rounds=rounds, loop_reads=reads, loop_s=loop_s, host_s=host_s,
               forms_wall_ms=forms, path_walk_shards=one, edges=dict(edges),
               rounds_device_ms=rounds * spans["span"]["median_ms"])
    print(f"  the walk loop's round form: {len(masks)} masks in {rounds} rounds, {reads} host "
          f"reads, {loop_s * 1e3:.2f} ms; the host walk the same masks in {host_s * 1e3:.2f} ms, "
          f"{h_rounds} reads; a round's device span {spans['span']['median_ms']:.4f} ms "
          f"(median of {rounds}; {spans['span']['min_ms']:.4f}-{spans['span']['max_ms']:.4f}; "
          f"{out['rounds_device_ms']:.4f} ms for the rounds), walk_advance "
          f"{spans['walk_advance']['median_ms']:.4f} ms starting "
          f"{spans['start_after_walk']['median_ms'] * 1e3:.2f} us after the round's last walk")
    return out


def shards_walk_bytes(st, tabs, final, layout: str, own) -> dict:
    """The bytes the one-launch walk must move on this run's tables: each
    path node's lookup in its owner's table reads the key words of its
    probe rows up to its first hit and the hit's parent word (walk_bytes's
    count, a lookup each), the coordinate read and the output written
    once.  Returns bytes and lookups."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch.search import engine as E

    c = np.asarray(final, dtype=np.int64)
    nbytes, lookups = st.n * 4 * 2 + (int(sum(final)) + st.n + 2) * 4, 0
    while c.any():
        o = int(own(c[None, :].astype(np.int32))[0])
        wb = walk_bytes(st, tabs[o], layout, c, 1, 0)
        nbytes, lookups = nbytes + wb["bytes"] - st.n * 4, lookups + 1
        par = E._LAYOUT_FNS[layout].lookup(st, tabs[o], torch.as_tensor(c))
        if par is None:
            break
        c = c - np.array([(par >> i) & 1 for i in range(st.n)])
    return dict(bytes=nbytes, lookups=lookups)


def walk_shards_host_split(st, tabs, final, layout: str, hash_params, reps: int = 20) -> dict:
    """walk_shards_cuda's call split on the host's clock (median ms of
    ``reps`` calls after one to warm up, each after a synchronize): its
    steps as it makes them, the shards' table checks and the host table of
    their addresses (step._walk_table), the params' copy to the card,
    out's allocation with the launch, and the one read (which waits for
    the kernel); every call's result equal to walk_shards_cuda's."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import step as S

    want = SH.walk_shards_cuda(st, tabs, final, layout, hash_params)
    n, tmax = st.n, int(st.final_np.sum())
    names = ("tables", "params", "launch", "read")
    split = {k: [] for k in names + ("call",)}
    for k in range(reps + 1):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        rows = [S._walk_table(st, tab, layout) for tab in tabs]
        dev, code, _, stride, _, _, probes = rows[0]
        table = torch.tensor([[r[2], r[4] or 0, r[5] or 0] for r in rows], dtype=torch.int64)
        t.append(time.perf_counter())
        params = torch.tensor(list(final) + list(st.bitw), dtype=torch.int32).to(dev)
        t.append(time.perf_counter())
        out = torch.empty(tmax + n + 2, dtype=torch.int32, device=dev)
        _kernels.launch("path_walk_shards", code, table.data_ptr(), len(tabs), stride, n, st.C,
                        st.bbits, probes, *hash_params, SH.WALK_HOPS, params.data_ptr(),
                        tmax, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        t.append(time.perf_counter())
        v = out.cpu().tolist()
        t.append(time.perf_counter())
        if (v[:v[tmax + n]], v[tmax:tmax + n], v[tmax + n + 1]) != want:
            fail(f"path_walk_shards ({layout}) in the host split differs from walk_shards_cuda")
        if k:
            for name, t0, t1 in zip(names, t, t[1:]):
                split[name].append((t1 - t0) * 1e3)
            split["call"].append((t[-1] - t[0]) * 1e3)
    return {name: statistics.median(v) for name, v in split.items()}


def walk_shards_check(eng, chase: dict, host=None, reps: int = 10) -> dict:
    """path_walk_shards on a finished run's tables (every shard's on one
    card): against walk_shards_plain and the host walk (``host``: its
    masks and rounds, or None to walk); its device time (CUPTI) and the
    wrapper's call with its one read (CUDA events), and the call split on
    the host's clock (walk_shards_host_split); the plain version's time;
    its bound by bytes (shards_walk_bytes) and its latency floor (its
    lookups x one dependent load from L2, pointer_chase, and beside it
    from device memory); its device time cold, after writing 256 MiB
    elsewhere."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    st, layout = eng.st, eng.layout
    tabs = [sh.tab for sh in sorted(eng.shards, key=lambda sh: sh.me)]
    final = [int(v) for v in eng.problem.final_coord]
    host = host or eng._walk(eng.shards)
    want = SH.walk_shards_plain(st, tabs, final, layout, eng.own)
    if (want[0], want[2]) != tuple(host) or any(want[1]):
        fail(f"walk_shards_plain ({layout}) differs from the host walk")
    call = functools.partial(SH.walk_shards_cuda, st, tabs, final, layout, eng.hash_params)
    if call() != want:
        fail(f"path_walk_shards ({layout}) differs from walk_shards_plain")
    dev_ms, ms = device_ms(call, reps), time_ms(call, reps)
    split = walk_shards_host_split(st, tabs, final, layout, eng.hash_params)
    evict = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MiB
    cold = device_ms(call, reps, evict.zero_)
    del evict
    wb = shards_walk_bytes(st, tabs, final, layout, eng.own)
    out = dict(layout=layout, max_abs_err=0, masks=len(want[0]), rounds=want[2],
               lookups=wb["lookups"], bytes=wb["bytes"],
               bound_ms=wb["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               latency_floor_ms=wb["lookups"] * chase["l2_ns"] / 1e6,
               latency_floor_dram_ms=wb["lookups"] * chase["dram_ns"] / 1e6,
               device_ms=dev_ms, cold_device_ms=cold, ms=ms, host_split_ms=split,
               plain_ms=time_ms(lambda: SH.walk_shards_plain(st, tabs, final, layout, eng.own),
                                reps=3, warmup=1),
               library_ms=None)
    print(f"  path_walk_shards ({layout}): {out['masks']} masks, {out['rounds']} rounds, equal "
          f"to the host walk and walk_shards_plain; device {dev_ms:.4f} ms, call {ms:.4f} ms; "
          f"cold (after writing 256 MiB) {cold:.4f} ms device; the call on the host's clock "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f" ms; plain {out['plain_ms']:.2f} ms; bound {out['bound_ms']:.7f} ms "
          f"({wb['bytes']} B), latency floor {out['latency_floor_ms']:.4f} ms ({wb['lookups']} "
          f"lookups from L2; {out['latency_floor_dram_ms']:.4f} from device memory)")
    return out


@contextlib.contextmanager
def fsort_spread():
    """Each route_count call inside on a card's live shard: per
    destination with remote rows, the spread (max - min) of their fsorts
    over the lanes and the ring's live rows, read on the host (the host
    driver's steps); yields the list of (spread, position bits: log2 of the
    shard's key segment)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    seen, count = [], SH._Shard.count

    def counted(sh, eng):
        if sh.cuda and int(sh.run[0]):
            n = int(sh.bufs.state[2]) * sh.st.M
            rows = torch.cat([sh.cand[:n], sh.ring[:int(sh.ring_len[sh.cur])]])[:, :2].long()
            for d in range(eng.ndev):
                f = rows[rows[:, 0] == d, 1]
                if f.numel():
                    seen.append((int(f.max() - f.min()), sh.seg.bit_length() - 1))
        return count(sh, eng)

    SH._Shard.count = counted
    try:
        yield seen
    finally:
        SH._Shard.count = count


def k11_phase(paths, gold, k11: dict, sweep: bool = False) -> dict:
    """K11 alone (``--k11-only``): kinase on 4 shards of one card under the
    host driver, packed (auto), pinned to unpacked and pinned to sig at
    2^23 slots a shard, each to the golden g and alignment with step 200
    captured; K11 on its rows there (k11_rows_checks, k11_sig_checks, with
    ``k11``'s builds: count, phases, baseline), the sweep with ``sweep``,
    and a traced dense chunked run (its device time a step, by kernel)."""
    card = torch.device("cuda", 0)
    k = gold["kinase.fasta"]
    out = {}
    for layout, kw in (("packed", {}), ("unpacked", {"layout": "unpacked"}),
                       ("sig", {"layout": "sig", "capacity": 1 << 23})):
        with fsort_spread() as spread:
            out[f"kinase_{layout}"], eng, cap = sharded_run(
                f"kinase sharded 4, {layout}, host driver", paths["kinase.fasta"], k,
                [card] * 4, layout != "unpacked", capture_step=200, driver="host", **kw)
        fits = sum(w < 1 << (32 - b) for w, b in spread)
        out[f"spread_{layout}"] = dict(segments=len(spread), fit_32_bits=fits,
                                       max=max(w for w, _ in spread),
                                       median=statistics.median(w for w, _ in spread))
        print(f"  fsort spread of a destination's rows a step ({layout}): "
              f"{out[f'spread_{layout}']}; position bits {spread[0][1]}")
        if "cand_route" not in cap:
            fail(f"kinase sharded {layout}: the search ended before the captured step")
        print(f"K11 on shard {cap['shard'].me}'s step 200 ({layout}):")
        out[f"checks_{layout}"] = (
            k11_sig_checks(cap, k11["count"], k11.get("baseline"), k11.get("phases"))
            if layout == "sig" else k11_rows_checks(cap, k11))
        del eng, cap
    if sweep:
        out["k11_sweep"] = k11_sweep(k11["count"], k11.get("baseline"))
    out["kinase_dense"], eng, _ = sharded_run("kinase sharded 4, dense", paths["kinase.fasta"],
                                              k, [card] * 4, True, profile=True,
                                              exchange="dense")
    print("  the dense step's device us by kernel: " + ", ".join(
        f"{name} {us:.2f}" for name, us in out["kinase_dense"]["step_kernels_us"].items()))
    return out


def sharded_phase(paths, gold, floor: dict, chase: dict, k11_count: dict, k11_baseline=None,
                  sweep=False, k6s_baseline=None, k10_phase_fns=None,
                  keyrow_baseline=None, k11_phases=None, k9s=None, k4s=None) -> dict:
    """The sharded engine on one card (parallel/sharded.py, a LocalMesh of
    [cuda:0] * 4): kinase --triples auto, whose automatic layout is packed
    at JAX's 2^21 slots a shard (sharded cubes), with the ragged exchange
    (auto) under the chunked driver (the main path: a chunk 256 replays
    of the two step graphs; the walk's device loop against the host walk,
    walk_advance against its plain version) and the dense one (traced: device time a step); kinase
    packed, pinned to unpacked, and pinned to sig at 2^23 slots a shard,
    each 256 steps under the chunked and the host driver in turns (every
    table word equal, driver_turns), then the host driver's full run; on
    step 200 of each of the three, each kernel of its step against its
    plain version (loop_kernel_checks: the consensus and the exchange;
    keyrow_kernel_checks, sharded_kernel_checks: ``k11_count`` the
    K11_BARRIERS build, ``k11_phases`` the K11_PHASES build's split,
    ``k11_baseline`` another tree's K11 too, timed in turns with K11 on
    key rows and on sig rows; ``k6s_baseline`` another tree's consensus,
    in turns with this one; ``k10_phase_fns`` the K10_PHASES build and
    ``keyrow_baseline`` another tree's K10, for K10 on received rows;
    ``k9s`` the K9S_PHASES build and another tree's K9s, k9s_checks); the
    sharded step's bounds at the sig
    run's B and cap; one shard against FrontierSearch's golden result,
    PF08184 with a one-row wire (exchange_cap=1), a random input whose
    one-row wire spills (sig, and pinned to unpacked), the degenerate
    input on 4 shards against the single-table unpacked search, test2
    under each owner hash; K11 at each size of K11_SWEEP (``sweep``); and
    several cards when there are."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch.core.problem import Problem
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
    from mpi_pastar_msa_tpu_torch.search.bruteforce import optimal_cost
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    card = torch.device("cuda", 0)
    out = {}
    k = gold["kinase.fasta"]
    # the main path: kinase's automatic layout, packed at JAX's capacity,
    # ragged, the chunked driver (auto on one card): a step one CUDA graph
    # for each ring parity, a chunk 256 replays of them and one host read,
    # the walk 32 replays of a one-round graph a read
    out["kinase_ragged"], eng, _ = sharded_run("kinase sharded 4, ragged", paths["kinase.fasta"],
                                               k, [card] * 4, True)
    r = out["kinase_ragged"]
    if (eng.layout != "packed" or r["capacity_start"] != 1 << 21 or eng.exchange != "ragged"
            or not eng.cubes_split or r["migrated"] <= 0 or r["driver"] != "chunked"
            or r["host_reads_a_step"] > 0.01 or r["graph_captures"] != 2):
        fail(f"kinase sharded: layout {eng.layout}, capacity {r['capacity_start']} (want packed "
             f"at 2^21), exchange {eng.exchange}, cubes split {eng.cubes_split}, migrated "
             f"{r['migrated']}, driver {r['driver']}, {r['host_reads_a_step']} host reads a "
             f"step, {r['graph_captures']} step graphs captured")
    # one card: the walk in one launch of path_walk_shards and one read
    if r["walk_form"] != "launch" or r["walk_reads"] != 1:
        fail(f"kinase sharded: the walk's form {r['walk_form']} in {r['walk_reads']} reads, "
             f"want one launch and one read on one card")
    out["walk_loop"] = walk_loop_check(eng, floor, chase, k6s_baseline)
    del eng
    # the several-card step on one card: the four shards grouped into two
    # cards (0, 1 | 2, 3), each with its stream, joined by events in one
    # graph a ring parity, the gathers as copies, a consensus and an
    # exchange a card; then the host driver's rank form on the same
    # cards; every table word equal, the golden alignment
    with split_cards([[0, 1], [2, 3]]):
        out["kinase_split"], ce, _ = sharded_run(
            "kinase sharded 4, two cards of one", paths["kinase.fasta"], k, [card] * 4, True)
        out["kinase_split_host"], he, _ = sharded_run(
            "kinase sharded 4, two cards of one, host driver", paths["kinase.fasta"], k,
            [card] * 4, True, driver="host")
    r = out["kinase_split"]
    if (r["cards"] != 2 or not r["card_form"] or r["driver"] != "chunked"
            or r["host_reads_a_step"] > 0.01 or out["kinase_split_host"]["card_form"]):
        fail(f"kinase on two cards of one: {r['cards']} cards, card form {r['card_form']}, "
             f"driver {r['driver']}, {r['host_reads_a_step']} host reads a step")
    r["words_equal"] = words_equal("kinase on two cards of one", ce, he)
    out["split_consensus"] = split_consensus_check(ce, floor)
    print(f"  kinase on two cards of one: chunked and host drivers equal on {r['words_equal']} "
          f"tensors; consensus over the snapshots {out['split_consensus']['device_ms']:.4f} ms "
          f"device")
    del ce, he
    # a ProcessMesh's step on this one card: the rank form, a card a shard,
    # the mesh's collectives as copies in each rank's step graph
    out["rank_form"] = rank_form_phase(paths["kinase.fasta"], k, floor)
    # a ProcessMesh's ragged exchange across processes: two processes on
    # this card, each reading the other's wire through CUDA IPC
    out["ipc"] = ipc_check(floor)
    # each layout in turns (chunked, then host, 256 steps), then the host
    # driver's full run on the same engine, whose step 200 is captured for
    # the kernel checks
    out["turns_packed"], eng = driver_turns("kinase sharded 4, ragged", paths["kinase.fasta"])
    out["kinase_host"], eng, cap = sharded_run("kinase sharded 4, ragged, host driver",
                                               paths["kinase.fasta"], k, [card] * 4, True,
                                               capture_step=200, eng=eng)
    if "cand" not in cap or "k10_rows" not in cap or "x_pend1" not in cap:
        fail("kinase sharded: the search ended before the captured step")
    k11 = dict(count=k11_count, baseline=k11_baseline, phases=k11_phases)
    out["checks_packed"] = keyrow_kernel_checks(cap, cap["shards"], k10_phase_fns,
                                                keyrow_baseline, k11, k9s)
    out["checks_loop"] = loop_kernel_checks(cap, floor, k6s_baseline)
    r = out["kinase_host"]
    if out["checks_packed"]["walk"]["rounds"] != r["walk_rounds"]:
        fail(f"kinase sharded: the walk took {r['walk_rounds']} rounds, its byte count "
             f"{out['checks_packed']['walk']['rounds']}")
    del eng, cap
    out["kinase_dense"], eng, _ = sharded_run("kinase sharded 4, dense", paths["kinase.fasta"],
                                              k, [card] * 4, True, profile=True,
                                              exchange="dense")
    del eng
    # an optimal path, not always the golden one: on unpacked rows a node
    # keeps the first parent of its least g (decrease-key on a smaller g,
    # as JAX's), and the shards' order of arrival is not the single table's
    out["turns_unpacked"], eng = driver_turns("kinase sharded 4, pinned unpacked",
                                              paths["kinase.fasta"], layout="unpacked")
    out["kinase_unpacked"], eng, cap = sharded_run(
        "kinase sharded 4, pinned unpacked", paths["kinase.fasta"], k, [card] * 4, False,
        capture_step=200, eng=eng)
    if eng.cubes_split or "k10_rows" not in cap:
        fail(f"kinase sharded unpacked: cubes split {eng.cubes_split}, or no captured step")
    out["checks_unpacked"] = keyrow_kernel_checks(cap, cap["shards"], k10_phase_fns,
                                                  keyrow_baseline, k11, k9s)
    out["walk_unpacked"] = walk_shards_check(eng, chase)
    del eng, cap
    # the sig layout (PR 15's path), pinned at the capacity its word takes
    out["turns_sig"], eng = driver_turns("kinase sharded 4, pinned sig", paths["kinase.fasta"],
                                         layout="sig", capacity=1 << 23)
    out["kinase_sig"], eng, cap = sharded_run(
        "kinase sharded 4, pinned sig", paths["kinase.fasta"], k, [card] * 4, True,
        capture_step=200, eng=eng)
    if "cand" not in cap:
        fail("kinase sharded sig: the search ended before the captured step")
    out["checks"] = sharded_kernel_checks(cap, cap["shards"], k11_count, k11_baseline,
                                          k11_phases)
    print(f"K4s on shard {cap['shard'].me}'s step 200 (kinase, pinned sig):")
    out["checks_k4s"] = k4s_checks(cap, k4s or {})
    out["walk_sig"] = walk_shards_check(eng, chase)
    if sweep:
        out["k11_sweep"] = k11_sweep(k11_count, k11_baseline)
    r = out["kinase_sig"]
    if out["checks"]["walk"]["rounds"] != r["walk_rounds"]:
        fail(f"kinase sharded sig: the walk took {r['walk_rounds']} rounds, its byte count "
             f"{out['checks']['walk']['rounds']}")
    out["bounds"] = sharded_step_bounds(r["batch"], 5, 4, out["checks"]["walk"], 4,
                                        r["exchange_cap"])
    del eng, cap
    # K4s at synth5 (auto: sig; chunked, then step 150 checked) and synth6
    # (N = 6: the warp-strided form), and the dense sig step traced with
    # each form
    out["k4s"] = k4s_runs(paths, gold, k4s or {}, kinase=False)
    out["k4s"].update(k4s_dense_forms(paths, gold))
    out["kinase_one_shard"], eng, _ = sharded_run("kinase sharded 1", paths["kinase.fasta"], k,
                                                  [card], True)
    del eng
    out["PF08184_cap1"], eng, _ = sharded_run("PF08184 sharded 4, exchange_cap 1",
                                              paths["PF08184.fasta"], gold["PF08184.fasta"],
                                              [card] * 4, True, exchange_cap=1,
                                              exchange="dense")
    # a random input whose frontier is wide (tests/test_torch_sharded.py's
    # spill case): a one-row wire spills into the carry ring, and the
    # brute-force optimum holds, on sig and on unpacked rows (whose ring
    # keeps its min f itself in the bound)
    rs = np.random.RandomState(31)
    seqs = tuple("".join(rs.choice(list("ACDEFGHIKLMNPQRSTVWY"), size=rs.randint(12, 17)))
                 for _ in range(4))
    want = optimal_cost(Problem(seqs), HPairHeuristic.build(Problem(seqs), "cpu"))
    with tempfile.NamedTemporaryFile("w", suffix=".fasta", delete=False) as f:
        f.write("".join(f">s{i}\n{q}\n" for i, q in enumerate(seqs)))
    for tag, kw in (("random_spill", {}), ("random_spill_unpacked", {"layout": "unpacked"})):
        out[tag], eng, _ = sharded_run(
            f"random 4 x 12-16 sharded 4, exchange_cap 1 {kw}", f.name,
            {"optimal_g": want, "seqs": list(seqs), "alignment": None}, [card] * 4, False,
            exchange_cap=1, exchange="dense", hash_type="FZORDER", hash_shift=0, batch=16,
            **kw)
        if out[tag]["peak_carry"] <= 0:
            fail(f"random sharded run with a one-row wire ({kw}): the carry ring never held "
                 "a row")
    os.unlink(f.name)
    # the degenerate input: unpacked by itself, against the single-table
    # unpacked search on the card
    dseqs = ("WYWY", "WYY", "YWW")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = FrontierSearch(Problem(dseqs), device="cuda", layout="unpacked").run()
        with tempfile.NamedTemporaryFile("w", suffix=".fasta", delete=False) as f:
            f.write("".join(f">s{i}\n{q}\n" for i, q in enumerate(dseqs)))
        out["degenerate"], eng, _ = sharded_run(
            "degenerate sharded 4 (against the single-table unpacked search)", f.name,
            {"optimal_g": ref.g, "seqs": list(dseqs),
             "alignment": build_alignment(Problem(dseqs), ref.closed)}, [card] * 4, False)
        os.unlink(f.name)
    if not any("optimality is undefined" in str(w.message) for w in caught):
        fail("degenerate sharded: no warning")
    if eng.layout != "unpacked":
        fail(f"degenerate sharded: layout {eng.layout}, want unpacked")
    for ht in ("FZORDER", "PZORDER", "FSUM", "PSUM"):
        out[f"test2_{ht}"], eng, _ = sharded_run(f"test2 sharded 4, {ht}", paths["test2.fasta"],
                                                 gold["test2.fasta"], [card] * 4, True,
                                                 hash_type=ht)
    del eng
    if torch.cuda.device_count() >= 2:
        out["multi_card"] = multi_card_phase(paths["kinase.fasta"], k)
        n = torch.cuda.device_count()
        out["multi_process"] = process_mesh_run(paths["kinase.fasta"], k, n)
    else:
        print("sharded multi-card: not run (1 card); ProcessMesh on NCCL not run either "
              "(NCCL takes one rank a card)")
        out["multi_card"] = "not run (1 card)"
    return out


def multi_card_phase(path: str, gold: dict) -> dict:
    """Kinase on every card of the machine, one shard a card (``-t N`` on
    N cards): the chunked driver (one graph a ring parity spanning the
    cards, peer reads; auto there) and the host driver (the rank form) in
    turns (chunked, host, host, chunked), each against the golden; the
    first two held equal table word for table word; then a chunked run
    traced (device time a step, every card's kernels summed)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.parallel.mesh import LocalMesh

    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    out, kept = {"cards": n, "runs": []}, {}
    for turn, driver in enumerate(("chunked", "host", "host", "chunked")):
        label = f"kinase sharded on {n} cards, {driver} driver, turn {turn}"
        info, eng, _ = sharded_run(label, path, gold, cards, True, driver=driver)
        if driver == "chunked" and (info["host_reads_a_step"] > 0.01 or not info["card_form"]
                                     or info["cards"] != n):
            fail(f"{label}: {info['host_reads_a_step']} host reads a step, card form "
                 f"{info['card_form']}, {info['cards']} cards")
        out["runs"].append(info)
        kept.setdefault(driver, eng)
        del eng
        if len(kept) == 2 and "words_equal" not in out:  # the first of each, then free them
            out["words_equal"] = words_equal(f"kinase on {n} cards", kept["chunked"],
                                             kept["host"])
            kept = {"chunked": None, "host": None}
    auto = SH.choose_driver(LocalMesh(cards), "auto")
    if auto != "chunked":
        fail(f"kinase on {n} cards: driver auto chose {auto}, want chunked")
    info, eng, _ = sharded_run(f"kinase sharded on {n} cards, chunked driver, traced", path,
                               gold, cards, True, profile=True, driver="chunked")
    out["traced"] = info
    del eng
    print(f"  kinase on {n} cards: chunked and host drivers equal on {out['words_equal']} "
          f"tensors; a step {[round(r['step_wall_ms'], 3) for r in out['runs']]} ms "
          f"(chunked, host, host, chunked), host reads a step "
          f"{[round(r['host_reads_a_step'], 4) for r in out['runs']]}; traced device "
          f"{info['step_device_ms']:.3f} ms a step (every card's kernels summed)")
    return out


def baseline_step(st, tab, ctr, ub, fill, probe):
    """One step of the sig search as run_chunk_sig_cuda(graph=False) runs
    it, with ``probe`` (another tree's K5 C entry, K5_GRID_ONLY_SIGNATURE) in
    place of K5; returns new counters."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.search import step as S

    bufs = S._step_buffers(st, torch.device("cuda"))
    c = bufs.counters
    c.copy_(ctr)
    c[1].fill_(0)
    bufs.run.copy_(((c[0] > 0) & (c[6] == 0)).view(1))
    stream = torch.cuda.current_stream().cuda_stream
    _kernels.launch(*S._select_args(st, tab.t_best, tab.t_closed, c[0], c[7], bufs.run, bufs,
                                    stream))
    _kernels.launch(*S._expand_args(st, tab, bufs, c, ub, stream))
    args = S._probe_args(st, tab, bufs, c, fill, 0, 0, stream)[1:]
    if probe(*(args[:10] + args[11:-2] + args[-1:])):  # that entry takes no cap nor recv
        fail("K5 sweep: the baseline's K5 failed to launch")
    return c.clone()


def k5_sweep(paths, baseline=None) -> dict:
    """K5's device time against its pending count n, on each of its paths,
    over whole searches: kinase under --triples auto and off and synth6,
    each run from a new table with K5's cap (the block path when n <=
    cap), with cap 0 (the grid path every step) and, given ``baseline``
    (build_step_baseline's entries), with the other tree's K5 in its place,
    one eager step a chunk under torch.profiler, the counters read after
    each step (n is lanes_unmatched's step).  Each step's K5 kernel (CUPTI
    duration) is paired with its n; the mean device time is printed by bin
    of n, beside the steps in each bin.  The runs make the same steps (the
    path does not change the result)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    bins = [0, 1024, 2048, 4096, 8192, 16384, 32768, 1 << 40]
    out = {}
    for label, path, triples in (("kinase_auto", paths["kinase.fasta"], "auto"),
                                 ("kinase_off", paths["kinase.fasta"], "off"),
                                 ("synth6", data_path("synth6"), "auto")):
        p = problem_from_fasta(path)
        eng = E.FrontierSearch(p, HPairHeuristic.build(p, "cuda"), device="cuda",
                               triples=triples)
        st, ub, fill = eng.st, eng.ub, eng.fill_target
        kinds = [S.K5_CAP, 0] + (["baseline"] if baseline else [])
        runs = {}
        for cap in kinds:
            tab = eng._init_table()
            ctr = torch.as_tensor(E.fresh_counters(), device="cuda")
            ns = []
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                profiler_preamble()
                while True:
                    before = int(ctr[12])
                    if cap == "baseline":
                        ctr = baseline_step(st, tab, ctr, ub, fill, baseline[2])
                    else:
                        ctr = S.run_chunk_sig_cuda(st, tab, ctr, 1, ub, fill, cap=cap,
                                                   graph=False)
                    c = ctr.tolist()
                    ns.append(c[12] - before)
                    if c[1] >= c[0] or c[6] > 0:
                        break
                torch.cuda.synchronize()
            k5 = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                        if e.device_type == DeviceType.CUDA and "sig_probe_kernel" in e.name)
            if len(k5) != len(ns):
                fail(f"K5 sweep {label} cap {cap}: {len(k5)} K5 kernels traced for "
                     f"{len(ns)} steps")
            runs[cap] = (ns, [us for _, us in k5], c)
            del tab
        if any(runs[k][2] != runs[0][2] or runs[k][0] != runs[0][0] for k in kinds):
            fail(f"K5 sweep {label}: the paths gave different searches")
        ns = runs[0][0]
        rows = []
        for lo, hi in zip(bins, bins[1:]):
            idx = [i for i, n in enumerate(ns) if lo < n <= hi or (lo == 0 and n == 0)]
            if idx:
                rows.append(dict(n_lo=lo, n_hi=hi, steps=len(idx), us={
                    str(k): statistics.mean(runs[k][1][i] for i in idx) for k in kinds}))
        totals = {str(k): sum(runs[k][1]) / 1e3 for k in kinds}
        out[label] = dict(steps=len(ns), bins=rows, total_ms=totals)
        names = {str(S.K5_CAP): f"at cap {S.K5_CAP}", "0": "on the grid path",
                 "baseline": "for the baseline's K5"}
        print(f"K5 sweep {label} ({len(ns)} steps; K5 device time summed over the search: "
              + ", ".join(f"{t:.3f} ms {names[k]}" for k, t in totals.items()) + "):")
        for r in rows:
            print(f"  n in ({r['n_lo']}, {r['n_hi']}]: {r['steps']} steps, K5 "
                  + ", ".join(f"{t:.2f} us {names[k]}" for k, t in r["us"].items()))
        del eng
    return out


def profile_search(name: str, path: str, triples: str, warm_steps: int,
                   steps: int, mode: str = "engine", layout: str = "auto") -> dict:
    """Where a mid-search step spends its time under ``triples`` in
    ``layout``: run the engine to ``warm_steps``, then trace ``steps`` more
    with torch.profiler, through the engine's own loop (``mode`` "engine":
    a chunk graph, captured before the timed windows by a chunk whose run
    flag is 0), through the eager chunk ("eager": run_chunk_sig_cuda or
    run_chunk_keyrow_cuda with graph=False, kernel by kernel) or through
    the plain step functions on the card tensors ("plain":
    _run_chunk_plain(plain_select=True), the step before its kernels).
    Prints the device time by kernel, the launches on the device (kernels,
    memcpy and memset) and the host's launch calls (kernel and graph
    launches, copies and fills) a step, the host reads (device-to-host
    copies) a step, and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    p = problem_from_fasta(path)
    eng = E.FrontierSearch(p, HPairHeuristic.build(p, "cuda"), device="cuda",
                           triples=triples, layout=layout)
    tab = eng._init_table()
    ctr = torch.as_tensor(E.fresh_counters(), device="cuda")
    ctr = E._run_chunk(eng.st, tab, ctr, warm_steps, eng.ub, eng.fill_target,
                       eng.layout)
    eager = S.run_chunk_sig_cuda if eng.layout == "sig" else S.run_chunk_keyrow_cuda

    def run(ctr):
        if mode == "plain":
            return E._run_chunk_plain(eng.st, tab, ctr, steps, eng.ub, eng.fill_target,
                                      eng.layout, plain_select=True)
        if mode == "eager":
            return eager(eng.st, tab, ctr, steps, eng.ub, eng.fill_target, graph=False)
        return E._run_chunk(eng.st, tab, ctr, steps, eng.ub, eng.fill_target, eng.layout)

    captures = S.capture_stats(eng.st)[0]
    if mode == "engine":
        idle = ctr.clone()
        idle[0] = 0  # goal 0: the run flag is 0, every kernel returns at once
        run(idle)
        torch.cuda.synchronize()
    captures = S.capture_stats(eng.st)[0] - captures
    s0 = ctr.tolist()[2]
    t0 = time.perf_counter()
    ctr = run(ctr)
    before = ctr.tolist()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / (before[2] - s0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_preamble()
        t0 = time.perf_counter()
        ctr = run(ctr)
        after = ctr.tolist()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = after[2] - before[2]
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    # aten:: ops report their kernels' device time again, and host runtime
    # calls (cudaLaunchKernel, ...) can carry a device time of their own:
    # busy time and launches count the kernels (and memcpy/memset) alone
    kern = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in events
                   if not e.key.startswith(("aten::", "cuda")) and "spin_kernel" not in e.key),
                  key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kern)
    # the host's launch calls: kernels (cudaLaunchKernel, cudaLaunchKernelExC,
    # ...), graphs, copies and fills
    host = {e.key: e.count for e in prof.key_averages()
            if e.key.startswith("cuda") and any(w in e.key for w in ("Launch", "Memcpy",
                                                                     "Memset"))}
    host["cudaLaunchKernel"] = host.get("cudaLaunchKernel", 0) - PREAMBLE_SPINS
    host = {k: c for k, c in host.items() if c}
    reads = sum(c for k, _, c in kern if k.startswith("Memcpy DtoH"))
    memsets = sum(c for k, _, c in kern if k.startswith("Memset"))
    selects = sum(c for k, _, c in kern if "select_kernel" in k)
    label = {"plain": "plain step", "eager": "eager chunk"}.get(mode, "engine")
    if mode == "engine":
        label += f", chunk graph; {captures} capture before the windows"
    print(f"profile {name} --triples {triples} (layout {eng.layout}, {label}): steps "
          f"{s0}..{before[2]} unprofiled {plain_wall_ms:.3f} "
          f"ms/step; steps {before[2]}..{after[2]} profiled: wall {wall * 1e3 / n:.3f} "
          f"ms/step, device busy {busy_ms / n:.3f} ms/step "
          f"({100 * busy_ms / (wall * 1e3):.1f}% of wall; idle "
          f"{100 - 100 * busy_ms / (wall * 1e3):.1f}%), "
          f"{sum(c for _, _, c in kern) / n:.1f} launches ({selects / n:.2f} K3 kernels, "
          f"{memsets / n:.2f} memsets) and {reads / n:.2f} host reads a step; host "
          f"launch calls a step: {sum(host.values()) / n:.3f} ("
          + ", ".join(f"{k} {c / n:.3f}" for k, c in sorted(host.items())) + ")")
    for key, ms, cnt in kern[:12]:
        print(f"  {ms / n:8.4f} ms/step  {cnt / n:7.1f} launches/step  {key[:90]}")
    ops = sorted(((e.key, e.device_time_total / 1e3) for e in events
                  if e.key.startswith("aten::")), key=lambda r: -r[1])
    return dict(layout=eng.layout, mode=mode, steps=n, captures=captures,
                host_calls_per_step={k: c / n for k, c in host.items()},
                host_launch_calls_per_step=sum(host.values()) / n,
                unprofiled_wall_ms_per_step=plain_wall_ms,
                wall_ms_per_step=wall * 1e3 / n,
                busy_ms_per_step=busy_ms / n,
                kernels=[dict(name=k, ms_per_step=ms / n, launches_per_step=c / n)
                         for k, ms, c in kern[:25]],
                aten_ops=[dict(name=k, ms_per_step=ms / n) for k, ms in ops[:25]],
                launches_per_step=sum(c for _, _, c in kern) / n,
                k3_kernels_per_step=selects / n, memsets_per_step=memsets / n,
                host_reads_per_step=reads / n)


def gotoh_pairs(seqs):
    """The dash-prefixed pairs of Phase 1's Gotoh fill, all C(N,2) of them,
    and their (n, m) lengths (weights.gotoh_distances builds the same)."""
    import numpy as np

    enc = [np.frombuffer(("-" + s).encode("latin-1"), dtype=np.uint8).astype(np.int32)
           for s in seqs]
    ij = [(i, j) for i in range(len(seqs) - 1) for j in range(i + 1, len(seqs))]
    return [(enc[i], enc[j]) for i, j in ij], [(len(seqs[i]), len(seqs[j])) for i, j in ij]


def k8_inputs(paths) -> dict:
    """The K8 checks' sequence sets: Phase 1's at kinase (P = 10), globin6
    (15), synth4_long (6, Lmax = 1107) and synth10 (45), and random
    sequences of very unequal lengths (1 against 40, 3 and 200)."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta

    sets = {label: problem_from_fasta(path).seqs for label, path in (
        ("kinase", paths["kinase.fasta"]), ("globin6", data_path("globin6")),
        ("synth4_long", data_path("synth4_long")), ("synth10", data_path("synth10")))}
    rs = np.random.RandomState(13)
    amino = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    sets["unequal"] = tuple(rs.choice(amino, size=L).tobytes().decode() for L in (1, 40, 3, 200))
    return sets


def start_k8_baseline(src: str, tmp: str):
    """Start nvcc on another tree's K8 (``src``: its gotoh_wavefront.cu, or a
    checkout's root or csrc/ directory; the C entry without the scratch,
    of the kernel that stored each cell straight into the output) in its
    own directory; returns (src, proc, lib)."""
    import shutil

    from mpi_pastar_msa_tpu_torch import _kernels

    cu = src if os.path.isfile(src) else next(
        p for p in (os.path.join(src, "gotoh_wavefront.cu"),
                    os.path.join(src, "mpi_pastar_msa_tpu_torch", "csrc", "gotoh_wavefront.cu"))
        if os.path.isfile(p))
    out = os.path.join(tmp, "k8_baseline")
    os.makedirs(out, exist_ok=True)
    shutil.copy(cu, out)
    lib = os.path.join(out, "libgotoh_wavefront.so")
    proc = subprocess.Popen(
        [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", lib, os.path.join(out, "gotoh_wavefront.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return src, proc, lib


def load_k8_baseline(job):
    """(src, run) of the other tree's K8 (start_k8_baseline): run(args) fills
    the (3, P, l1, l1) output from gotoh_inputs' args, with this tree's
    launch shape (k8_launch_shape: the same threads, rows and shared
    bytes)."""
    from mpi_pastar_msa_tpu_torch.core.cost import (
        PRIMER_EFFECTIVE_GAP_COST, PRIMER_GAP_COST)
    from mpi_pastar_msa_tpu_torch.heuristic.gotoh_wavefront import k8_launch_shape
    from mpi_pastar_msa_tpu_torch.heuristic.wavefront import _device_cost

    src, proc, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"K8 baseline: nvcc failed for gotoh_wavefront.cu of {src}:\n{log}")
    fn = ctypes.CDLL(lib).gotoh_wavefront
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(seq_a, seq_b, n1s, n2s, l1):
        threads, rows, shared = k8_launch_shape(l1)
        P = seq_a.shape[0]
        out = torch.empty((3, P, l1, l1), dtype=torch.int32, device="cuda")
        if fn(seq_a.data_ptr(), seq_b.data_ptr(), n1s.data_ptr(), n2s.data_ptr(),
              _device_cost(seq_a.device).data_ptr(), out.data_ptr(), P, l1,
              PRIMER_GAP_COST, PRIMER_EFFECTIVE_GAP_COST, threads, rows, shared,
              torch.cuda.current_stream().cuda_stream):
            fail(f"K8 build of {src} failed to launch")
        return out

    return src, run


def check_k8(paths, baseline=None, no_store=None) -> dict:
    """K8 (gotoh_wavefront) against its plain version on the card and
    against the host fill (weights._gotoh_pair_matrices) over every pair's
    box, exact, at the K8 inputs; the wrapper (CUDA events) and device
    (CUPTI) times, the device times of its two launches (the fill into the
    diagonal-major scratch, the tiled transpose) and the scratch's bytes,
    the plain version's, the host fill's and the host function's
    (gotoh_matrices_device: the kernel, the crop on the device and the one
    copy back into pinned memory) and the crop and copy alone, the bounds
    by bytes and by int32 operations and the dependent-diagonal floor (n +
    m + 1 barrier steps of the longest pair, at K8's block width:
    pair_wavefront.cu's barrier_chain).  The crop and copy back in turns
    with the former one (a boolean mask of the boxes on the device, then a
    copy into pageable memory), and ``no_store`` (the C entry of the K8_NO_STORE
    build) gives the fill's device time without its scratch stores.
    ``baseline`` is (source, run) of another tree's K8 (``--k8-baseline``):
    its output must equal this one's, and the two are timed in turns
    (baseline, K8, K8, baseline), wrapper and device, K8 through the launch
    that ``gotoh_matrices_device`` takes (no guard, no read of the device),
    as the baseline's run."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch._kernels import launches, load
    from mpi_pastar_msa_tpu_torch.core.cost import (
        PRIMER_EFFECTIVE_GAP_COST, PRIMER_GAP_COST)
    from mpi_pastar_msa_tpu_torch.heuristic.gotoh_wavefront import (
        _gotoh_cuda, crop_boxes, gotoh_inputs, gotoh_matrices, gotoh_matrices_device,
        gotoh_matrices_plain, k8_launch_shape, k8_scratch_shape)
    from mpi_pastar_msa_tpu_torch.heuristic.wavefront import _device_cost
    from mpi_pastar_msa_tpu_torch.heuristic.weights import _gotoh_pair_matrices

    chain_fn = load("pair_wavefront").barrier_chain
    chain_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    chain_fn.restype = ctypes.c_int
    rows = {}
    for label, seqs in k8_inputs(paths).items():
        pairs, lens = gotoh_pairs(seqs)
        args = gotoh_inputs(pairs, lens, "cuda")
        n0 = launches["gotoh_wavefront"]
        got = gotoh_matrices(**args)
        torch.cuda.synchronize()
        if launches["gotoh_wavefront"] != n0 + 1:
            fail("gotoh_wavefront wrapper did not launch its kernel")
        err = int((got.long() - gotoh_matrices_plain(**args).long()).abs().max())
        if err != 0:
            fail(f"K8 {label}: kernel differs from plain version (max |err| {err})")
        t0 = time.perf_counter()
        host = [_gotoh_pair_matrices(a, b) for a, b in pairs]
        host_ms = (time.perf_counter() - t0) * 1e3
        dev = gotoh_matrices_device(pairs, lens, "cuda")
        if not all(np.array_equal(x, y) for h, d in zip(host, dev) for x, y in zip(h, d)):
            fail(f"K8 {label}: the cropped matrices differ from the host fill")
        ms = time_ms(lambda: gotoh_matrices(**args), reps=20)
        dev_ms = device_ms(lambda: gotoh_matrices(**args), 20)
        fill_ms, transpose_ms = (
            device_ms(lambda: gotoh_matrices(**args), 20,
                      keep=lambda k, name=name: own_event(k) and name in k)
            for name in ("gotoh_wavefront_kernel", "gotoh_diag_to_rows_kernel"))
        plain_ms = time_ms(lambda: gotoh_matrices_plain(**args), reps=2, warmup=1)
        fetch_ms = time_ms(lambda: gotoh_matrices_device(pairs, lens, "cuda"), reps=5)
        P, l1 = len(pairs), args["l1"]
        idx = torch.arange(l1, device="cuda")
        box = ((idx[None, :, None] <= args["n1s"].long()[:, None, None])
               & (idx[None, None, :] <= args["n2s"].long()[:, None, None]))
        if not np.array_equal(got[:, box].cpu().numpy(), crop_boxes(got, lens)):
            fail(f"K8 {label}: the crop from host offsets differs from the boolean mask's")
        crop_turns = [time_ms(f, reps=5) for f in (
            lambda: got[:, box].cpu().numpy(), lambda: crop_boxes(got, lens),
            lambda: crop_boxes(got, lens), lambda: got[:, box].cpu().numpy())]
        crop_ms = crop_turns[1]
        threads, rows_per_thread, shared = k8_launch_shape(l1)
        scratch_bytes = 4 * int(np.prod(k8_scratch_shape(P, l1)))
        no_store_ms = None
        if no_store is not None:
            scratch = torch.empty(k8_scratch_shape(P, l1), dtype=torch.int32, device="cuda")
            junk = torch.empty_like(got)  # the build's transpose reads a scratch never written

            def fill_only():
                if no_store(args["seq_a"].data_ptr(), args["seq_b"].data_ptr(),
                            args["n1s"].data_ptr(), args["n2s"].data_ptr(),
                            _device_cost(got.device).data_ptr(), scratch.data_ptr(),
                            junk.data_ptr(), P, l1, PRIMER_GAP_COST,
                            PRIMER_EFFECTIVE_GAP_COST, threads, rows_per_thread, shared,
                            torch.cuda.current_stream().cuda_stream):
                    fail("the K8_NO_STORE build failed to launch")

            no_store_ms = device_ms(fill_only, 20, keep=lambda k: own_event(k)
                                    and "gotoh_wavefront_kernel" in k)
            del scratch, junk
        cells = sum((n + 1) * (m + 1) for n, m in lens)
        in_bytes = 2 * P * l1 * 4 + 2 * P * 4 + 128 * 128 * 4
        out_bytes = 3 * P * l1 * l1 * 4
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        box_ms = 3 * 4 * cells / HBM_BYTES_PER_S * 1e3
        ops_ms = cells * K8_OPS_PER_CELL / INT32_OPS_PER_S * 1e3
        steps = max(n + m + 1 for n, m in lens)
        probe = torch.empty(threads, dtype=torch.int32, device="cuda")

        def chain():
            if chain_fn(steps, threads, probe.data_ptr(),
                        torch.cuda.current_stream().cuda_stream):
                fail("barrier_chain probe failed to launch")

        chain_ms = time_ms(chain, reps=20)
        rows[label] = dict(P=P, l1=l1, threads=threads, rows_per_thread=rows_per_thread,
                           shared_bytes=shared, ms=ms, device_ms=dev_ms,
                           fill_device_ms=fill_ms, transpose_device_ms=transpose_ms,
                           scratch_bytes=scratch_bytes, plain_ms=plain_ms,
                           fill_no_store_device_ms=no_store_ms, host_fill_ms=host_ms,
                           fetch_ms=fetch_ms, crop_copy_ms=crop_ms,
                           crop_copy_turns=dict(order="mask, offsets, offsets, mask",
                                                ms=crop_turns),
                           bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                           bytes_bound_ms=bytes_ms, box_bytes_bound_ms=box_ms,
                           ops_bound_ms=ops_ms, chain_floor_ms=chain_ms, diagonals=steps,
                           out_bytes=out_bytes, box_bytes=3 * 4 * cells, max_abs_err=err)
        print(f"K8 {label}: P={P} l1={l1} threads={threads} rows/thread={rows_per_thread} "
              f"shared={shared} B, scratch {scratch_bytes} B; exact against plain and host "
              f"fill; kernel {ms:.4f} ms (device {dev_ms:.4f} ms: fill {fill_ms:.4f}, "
              f"transpose {transpose_ms:.4f}; the fill without its stores "
              f"{no_store_ms if no_store_ms is None else round(no_store_ms, 4)}), plain "
              f"{plain_ms:.2f} ms, host fill {host_ms:.2f} ms, kernel + crop + copy back "
              f"{fetch_ms:.3f} ms; the crop and copy alone in turns with a boolean "
              f"mask and a pageable copy: mask {crop_turns[0]:.3f}, offsets "
              f"{crop_turns[1]:.3f}, offsets {crop_turns[2]:.3f}, mask "
              f"{crop_turns[3]:.3f} ms; bound "
              f"{max(bytes_ms, ops_ms):.5f} ms ({rows[label]['bound_by']}: bytes "
              f"{bytes_ms:.5f}, boxes alone {box_ms:.5f}, int32 operations {ops_ms:.5f}), "
              f"dependent-diagonal floor {chain_ms:.4f} ms ({steps} barrier steps of "
              f"{threads} threads); no library yardstick (no single PyTorch call "
              f"computes this DP)")
        if baseline is not None:
            src, run = baseline
            old = lambda: run(args["seq_a"], args["seq_b"], args["n1s"], args["n2s"], l1)
            if not torch.equal(old(), got):
                fail(f"K8 {label}: the build of {src} differs from this one")
            cur = lambda: _gotoh_cuda(**args)
            order = (old, cur, cur, old)
            turns = [time_ms(f, reps=20) for f in order]
            dev_turns = [device_ms(f, 20) for f in order]
            rows[label]["turns"] = dict(source=src, ms=turns, device_ms=dev_turns)
            print(f"K8 {label} in turns with {src} (baseline, K8, K8, baseline): wrapper "
                  + ", ".join(f"{t:.4f}" for t in turns) + " ms; device "
                  + ", ".join(f"{t:.4f}" for t in dev_turns) + " ms")
    return rows


def phase1_walls(paths) -> dict:
    """Phase 1 on the card with K8 (HPairHeuristic.build: K1, K8, the host
    traceback and tree) and with the host fill (K1, then the host
    Altschul pipeline, as before K8), in turns (K8, host, host, K8) at
    kinase, globin6, synth4_long and synth10; the Gotoh distances and the
    weights of both must be equal.  An observation, not a claim."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.heuristic.wavefront import pair_tables
    from mpi_pastar_msa_tpu_torch.heuristic.weights import (
        altschul_rationale2, gotoh_distances)

    out = {}
    for label, path in (("kinase", paths["kinase.fasta"]), ("globin6", data_path("globin6")),
                        ("synth4_long", data_path("synth4_long")),
                        ("synth10", data_path("synth10"))):
        p = problem_from_fasta(path)
        if not np.array_equal(gotoh_distances(p.seqs, torch.device("cuda")),
                              gotoh_distances(p.seqs)):
            fail(f"{label}: Gotoh distances on the card differ from the host's")

        def with_k8():
            h = HPairHeuristic.build(p, "cuda")
            torch.cuda.synchronize()
            return h.weight_f, h.weight_i

        def with_host():
            pair_tables(p, "cuda").cpu().numpy()
            return altschul_rationale2(p.seqs)

        walls, weights = [], []
        for fn in (with_k8, with_host, with_host, with_k8):
            t0 = time.perf_counter()
            weights.append(fn())
            walls.append(time.perf_counter() - t0)
        if not all(np.array_equal(w[k], weights[0][k]) for w in weights for k in (0, 1)):
            fail(f"{label}: Phase 1 weights with K8 differ from the host fill's")
        out[label] = dict(k8_s=[walls[0], walls[3]], host_s=[walls[1], walls[2]])
        print(f"Phase 1 {label} (N={p.n_seq}, Lmax={p.max_length}) in turns: K8 "
              f"{walls[0]:.4f} s, host fill {walls[1]:.4f} s, host fill {walls[2]:.4f} s, "
              f"K8 {walls[3]:.4f} s; distances and weights identical")
    return out


def check_weights(label: str, heuristic, seqs, counts: dict) -> None:
    """K8 launched once in the run's Phase 1, next to K1, and the run's
    weights equal the host fill's (HOST_WEIGHTS caches them by input)."""
    import numpy as np

    from mpi_pastar_msa_tpu_torch.heuristic.weights import altschul_rationale2

    if counts["gotoh_wavefront"] != 1 or counts["pair_wavefront"] != 1:
        fail(f"{label}: Phase 1 launched K1 {counts['pair_wavefront']} and K8 "
             f"{counts['gotoh_wavefront']} times, want 1 each")
    key = tuple(seqs)
    if key not in HOST_WEIGHTS:
        HOST_WEIGHTS[key] = altschul_rationale2(key)
    base = getattr(heuristic, "base", heuristic)
    if not all(np.array_equal(a, b) for a, b in zip((base.weight_f, base.weight_i),
                                                   HOST_WEIGHTS[key])):
        fail(f"{label}: the weights of Phase 1 on the card differ from the host fill's")


def cli_engine(name: str, path: str, gold: dict, flags, want_line=None) -> dict:
    """One run of the CLI entry with ``flags`` (the serial or native
    engine), Phase 1 on the card: the golden g, a path whose recomputed
    cost is g, degapped rows equal to the inputs, the golden similarity,
    K1 and K8 once each and the host fill's weights; ``want_line`` must be
    printed.  Prints whether the alignment is byte-identical to the golden."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch import cli
    from mpi_pastar_msa_tpu_torch.search.backtrace import attach_path_g, similarity

    args = cli.make_parser().parse_args([path, "--device", "cuda"] + list(flags))
    label = f"{name} {' '.join(flags) or '(CLI defaults: --engine auto)'}"
    _kernels.reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rep = cli.execute(args)
    counts = dict(_kernels.launches)
    text = out.getvalue()
    if want_line and want_line not in text.splitlines():
        fail(f"{label}: no line {want_line!r}")
    res = rep.result
    if res.g != gold["optimal_g"]:
        fail(f"{label}: g={res.g}, want {gold['optimal_g']}")
    attach_path_g(rep.problem, rep.heuristic.weight_i, res.closed, goal_g=res.g)
    identical = check_alignment(label, rep.alignment, gold, False)
    sim = round(similarity(rep.alignment), 2)
    if sim != gold["similarity_pct"]:
        fail(f"{label}: similarity {sim}, want {gold['similarity_pct']}")
    check_weights(label, rep.heuristic, rep.problem.seqs, counts)
    print(f"{label} (CLI, Phase 1 on the card): engine {rep.engine_name}, g={res.g} ok, "
          f"path cost == g, similarity {sim:.2f}%, alignment byte-identical to golden: "
          f"{identical}; Phase 1/2/3 = {rep.walls['phase1']:.3f} / "
          f"{rep.walls['phase2']:.3f} / {rep.walls['phase3']:.3f} s; expanded "
          f"{res.nodes_expanded}; launches K1 {counts['pair_wavefront']}, K8 "
          f"{counts['gotoh_wavefront']}")
    return dict(engine=rep.engine_name, g=res.g, identical=identical, similarity=sim,
                walls=rep.walls, expanded=res.nodes_expanded, launches=counts)


def checkpoint_resume(name: str, path: str, gold: dict, layout: str, tmp: str,
                      interrupt_at: int = 128) -> dict:
    """A search of the engine entry (its defaults, as the CLI's) stopped by
    max_steps with a checkpoint, then resumed by a new engine: the golden
    g, more steps than the interrupted run, the main path's expansions,
    reopens and steps (MAIN_PATH_COUNTS: the resumed search is the
    uninterrupted one), the layout's step kernels under one chunk graph
    the resumed run captured itself, K7 once (checked against _walk), no
    plain step function; on a golden input the golden alignment.  Prints
    the save and load walls and the file's size."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    p = problem_from_fasta(path)
    h = HPairHeuristic.build(p, "cuda")
    ckpt = os.path.join(tmp, f"{name}.ckpt.npz")
    first = FrontierSearch(p, h, device="cuda", max_steps=interrupt_at, checkpoint_path=ckpt)
    try:
        first.run()
        fail(f"{name}: the search ended before max_steps={interrupt_at}")
    except RuntimeError as e:
        if "max_steps" not in str(e):
            raise
    size = os.path.getsize(ckpt)
    save_s = first.last_phase_walls["checkpoint_save"]
    _kernels.reset_counts()
    with plain_step_guard() as plain, walk_capture() as seen:
        eng = FrontierSearch(p, h, device="cuda", checkpoint_path=ckpt)
        res = eng.run()
    counts = dict(_kernels.launches)
    label = f"{name} resumed"
    if eng.layout != layout or eng.resumed_steps is None:
        fail(f"{label}: layout {eng.layout}, resumed from {eng.resumed_steps}")
    if res.g != gold["optimal_g"] or not res.steps > eng.resumed_steps >= interrupt_at:
        fail(f"{label}: g={res.g} after {res.steps} steps from {eng.resumed_steps}")
    want = MAIN_PATH_COUNTS[(name, "auto")]
    if (res.nodes_expanded, res.nodes_reopened, res.steps) != want:
        fail(f"{label}: expanded, reopened, steps "
             f"{(res.nodes_expanded, res.nodes_reopened, res.steps)}, want {want}")
    identical = check_alignment(label, build_alignment(p, res.closed), gold,
                                gold["alignment"] is not None)
    replays = -(-(res.steps - eng.resumed_steps) // eng.chunk_steps)
    per = 1 + eng.chunk_steps * replays
    if (eng.graph_captures != 1 or counts["path_walk"] != 1 or any(plain.values())
            or any(counts[k] != per for k in LAYOUT_KERNELS[layout])):
        fail(f"{label}: {eng.graph_captures} graph captures, launches {counts} "
             f"(want {per} a step kernel, K7 once), plain calls {plain}")
    load_s = eng.last_phase_walls["checkpoint_load"]
    print(f"{label} ({layout}): interrupted at {eng.resumed_steps} steps, checkpoint "
          f"{size / 2**20:.1f} MiB saved in {save_s:.3f} s, loaded in {load_s:.3f} s; "
          f"g={res.g} ok after {res.steps} steps, counts of the uninterrupted search, "
          f"alignment byte-identical to golden: {identical}; its own chunk graph "
          f"({eng.graph_captures} capture), K7 once")
    return dict(layout=layout, g=res.g, interrupted_steps=eng.resumed_steps,
                steps=res.steps, bytes=size, save_s=save_s, load_s=load_s,
                identical=identical, launches=counts,
                k7=check_k7(label, seen))


def write_report(path, report: dict) -> None:
    """The full report as JSON at ``path`` (nothing when None)."""
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=1, default=str)


def k10_latency_floor(floor: dict, chase: dict, rounds: int) -> float:
    """K10's latency floor (ms) on the whole-list block path, from its
    code: a launch (``floor``: launch_floor's device time), then the
    dependent loads from L2 (``chase``: dependent_load_ns) its block makes
    one after another: the run flag, the list's length, round 0's pending
    entries and their home rows, and each round's claim words and re-reads
    (two a round)."""
    return floor["device_ms"] + (4 + 2 * rounds) * chase["l2_ns"] / 1e6


def sharded_kernel_entries(sh: dict, floor: dict, chase: dict) -> list:
    """The kernels line's entries of the sharded step (``sh``: the sharded
    phase's report; ``floor``: launch_floor; ``chase``:
    dependent_load_ns)."""
    kernels = []
    # the sharded step's kernels: on sig rows (PR 15's path, kinase pinned
    # to sig at 2^23 slots a shard), launches from that run, checks and
    # times on its captured step (K11 under both allowances); on key rows
    # (the main path: kinase on 4 shards, auto, packed at 2^21, ragged),
    # launches from that run, checks and times on its step 200, the
    # unpacked run's beside them
    sl, sig_l, unp_l = (sh[r]["launches"] for r in ("kinase_ragged", "kinase_sig",
                                                     "kinase_unpacked"))
    main_run = "kinase sharded 4, ragged (packed, chunked driver)"
    sig_run = "kinase sharded 4, pinned sig (host driver)"
    cp, cu = sh["checks_packed"], sh["checks_unpacked"]

    def entry_of(name, t, src, replaces, launches, run):
        return {"name": name, "route": "cuda",
                "source": f"mpi_pastar_msa_tpu_torch/csrc/{src}.cu", "replaces": replaces,
                "launches": launches, "launches_run": run, "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None}

    def sub(t, launches, **extra):
        return dict({k: t[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_by")}, launches=launches, **extra)

    for name, key, src, replaces in (
            ("sig_coords", "sig_coords", "tri_partial",
             "mpi_pastar_msa_tpu/search/engine.py:1620"),
            ("tri_partial", "tri_partial", "tri_partial",
             "mpi_pastar_msa_tpu/parallel/sharded.py:250"),
            ("sig_expand_sharded", "sig_expand_sharded", "sig_expand",
             "mpi_pastar_msa_tpu/search/engine.py:497"),
            ("route_pack", "route_ragged", "route_pack",
             "mpi_pastar_msa_tpu/parallel/sharded.py:169")):
        t = sh["checks"][key]
        entry = entry_of(name, t, src, replaces, sig_l[name], sig_run)
        if name == "tri_partial":  # also on the main path, on the packed batch
            entry.update(launches=sl[name], launches_run=main_run, times_run=sig_run)
        if name == "route_pack":
            # K11 is one call of two passes, a launch each a step: the
            # entry's times are the call's, each pass's alone beside them
            entry.update(name="route", launches=sig_l["route_pack"], note=(
                "K11 on sig rows, one entry: route_count then route_pack; launches a pass, "
                "and each pass timed alone, in passes"), passes={
                p: dict(launches=sig_l[p], **t["passes"][p]) for p in ("route_count",
                                                                       "route_pack")},
                replaces_dense="mpi_pastar_msa_tpu/parallel/sharded.py:87")
            entry["dense"] = {k: sh["checks"]["route_dense"][k]
                              for k in ("ms", "device_ms", "plain_ms", "bound_ms", "passes")}
            # two launches, then the dependent chain: a row's read and its
            # atomic; the counts, the keys, the row gathered by position,
            # the store
            entry.update(
                latency_floor_ms=2 * floor["device_ms"] + 6 * chase["l2_ns"] / 1e6,
                latency_floor_dram_ms=2 * floor["device_ms"] + 6 * chase["dram_ns"] / 1e6,
                segments=t["segments"],
                **({"turns": {m: sh["checks"][f"route_{m}"]["turns"]
                              for m in ("ragged", "dense")}} if "turns" in t else {}),
                **({"sweep": sh["k11_sweep"]} if "k11_sweep" in sh else {}))
        if name == "sig_expand_sharded":
            # K4s's rows form: its sweep, split and turns on the timed step,
            # synth5's (auto: sig) and synth6's checks (N = 6: the
            # warp-strided form), and the launches of synth5's chunked run
            k4 = sh["k4s"]
            entry.update(k9s_latency_floor(floor, chase), host_driver_launches=sig_l[name],
                         launches=k4["synth5_chunked"]["launches"][name],
                         launches_run="synth5 sharded 4, auto (sig; chunked driver)",
                         times_run=sig_run, rows=sh["checks_k4s"],
                         synth5=k4["checks_synth5"], synth6=k4["checks_synth6"],
                         dense_step_kernels_us={
                             f: k4[f"sig_dense{x}"]["step_kernels_us"]
                             for f, x in (("strided_form", "_strided_form"), ("rows_form", ""))})
        if name in ("sig_coords", "tri_partial"):
            # a launch, then two dependent loads: the listed slot (or the
            # coordinates), then its sig word (or the cube's corners)
            entry.update(latency_floor_ms=floor["device_ms"] + 2 * chase["l2_ns"] / 1e6,
                         latency_floor_dram_ms=floor["device_ms"] + 2 * chase["dram_ns"] / 1e6)
        kernels.append(entry)
    # the key-row kernels of the main path, the unpacked run's beside them
    entry = entry_of("keyrow_coords", cp["keyrow_coords"], "tri_partial",
                     "mpi_pastar_msa_tpu/parallel/sharded.py:641", sl["keyrow_coords"], main_run)
    entry.update(latency_floor_ms=floor["device_ms"] + 2 * chase["l2_ns"] / 1e6,
                 latency_floor_dram_ms=floor["device_ms"] + 2 * chase["dram_ns"] / 1e6)
    kernels.append(entry)
    for name, src, replaces, replaces_unpacked in (
            ("keyrow_expand_sharded", "keyrow_expand",
             "mpi_pastar_msa_tpu/parallel/sharded.py:645",
             "mpi_pastar_msa_tpu/parallel/sharded.py:812"),
            ("keyrow_insert_recv", "keyrow_insert",
             "mpi_pastar_msa_tpu/parallel/sharded.py:675",
             "mpi_pastar_msa_tpu/parallel/sharded.py:841")):
        entry = entry_of(name, cp[name], src, replaces, sl[name], main_run)
        extra = {k: cp[name][k] for k in cp[name] if k not in entry and k != "bytes"}
        entry.update(extra, unpacked=sub(cu[name], unp_l[name], replaces=replaces_unpacked,
                                         **{k: cu[name][k] for k in extra}))
        if name == "keyrow_insert_recv":
            for e, t in ((entry, cp[name]), (entry["unpacked"], cu[name])):
                e["latency_floor_ms"] = k10_latency_floor(floor, chase, t["rounds"])
        else:
            entry.update(k9s_latency_floor(floor, chase))
            entry["unpacked"].update(k9s_latency_floor(floor, chase))
        kernels.append(entry)
    t = cp["route_rows_ragged"]
    entry = entry_of("route_rows", t, "route_pack", "mpi_pastar_msa_tpu/parallel/sharded.py:169",
                     sl["route_pack_rows"], main_run)
    entry.update(
        note=("K11 on key rows, one entry: route_count_rows then route_pack_rows; launches a "
              "pass, and each pass timed alone, in passes"),
        passes={p: dict(launches=sl[p], **t["passes"][p])
                for p in ("route_count_rows", "route_pack_rows")},
        replaces_dense="mpi_pastar_msa_tpu/parallel/sharded.py:87", segments=t["segments"],
        dense={k: cp["route_rows_dense"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                      "passes")},
        latency_floor_ms=2 * floor["device_ms"] + 6 * chase["l2_ns"] / 1e6,
        latency_floor_dram_ms=2 * floor["device_ms"] + 6 * chase["dram_ns"] / 1e6,
        unpacked=sub(cu["route_rows_ragged"], unp_l["route_pack_rows"],
                     segments=cu["route_rows_ragged"]["segments"],
                     passes=cu["route_rows_ragged"]["passes"]))
    kernels.append(entry)
    # the walk: on one card the whole walk in one launch (the main path's);
    # K7's hop mode and walk_advance in rounds where the shards lie on
    # several cards (on this card: kinase's shards split into two cards)
    split_run = "kinase sharded 4, two cards of one (chunked driver)"
    split_l = sh["kinase_split"]["launches"]
    wl = sh["walk_loop"]
    t = wl["path_walk_shards"]
    entry = entry_of("path_walk_shards", t, "path_walk",
                     "mpi_pastar_msa_tpu/parallel/sharded.py:482", sl["path_walk_shards"],
                     main_run)
    entry.update({k: t[k] for k in ("latency_floor_ms", "latency_floor_dram_ms", "lookups",
                                    "masks", "rounds", "host_split_ms", "cold_device_ms")},
                 also_replaces=["mpi_pastar_msa_tpu/parallel/sharded.py:545"],
                 forms_wall_ms=wl["forms_wall_ms"], rounds_device_ms=wl["rounds_device_ms"],
                 **{lay: sub(sh[f"walk_{lay}"], 1, **{k: sh[f"walk_{lay}"][k] for k in (
                     "latency_floor_ms", "lookups", "host_split_ms")})
                    for lay in ("sig", "unpacked")})
    kernels.append(entry)
    t = cp["path_walk_hops"]
    entry = entry_of("path_walk_hops", t, "path_walk",
                     "mpi_pastar_msa_tpu/parallel/sharded.py:482", split_l["path_walk_hops"],
                     split_run)
    entry.update(latency_floor_ms=t["lookups"] * chase["l2_ns"] / 1e6,
                 latency_floor_dram_ms=t["lookups"] * chase["dram_ns"] / 1e6,
                 lookups=t["lookups"])
    for lay, run, c in (("sig", sig_l, sh["checks"]), ("unpacked", unp_l, cu)):
        w = c["path_walk_hops"]
        entry[lay] = sub(w, run["path_walk_hops"], lookups=w["lookups"],
                         latency_floor_ms=w["lookups"] * chase["l2_ns"] / 1e6)
    kernels.append(entry)
    # the sharded loop's kernels (K6s): the consensus and the exchange at
    # step 200 of the host driver's packed run (the graph's own launches
    # are the main path's), walk_advance on the main path's finished tables
    loop = sh["checks_loop"]
    for name, t, replaces, also in (
            ("consensus", loop["consensus"], "mpi_pastar_msa_tpu/parallel/sharded.py:312",
             [f"mpi_pastar_msa_tpu/parallel/sharded.py:{n}" for n in (214, 87, 456, 709, 871)]),
            ("exchange", loop["exchange"], "mpi_pastar_msa_tpu/parallel/sharded.py:231",
             ["mpi_pastar_msa_tpu/parallel/sharded.py:148"]),
            ("walk_advance", sh["walk_loop"]["walk_advance"],
             "mpi_pastar_msa_tpu/parallel/sharded.py:545", [])):
        walk = name == "walk_advance"  # the round form's: not on one card's main path
        entry = entry_of(name, t, "shard_loop", replaces,
                         split_l[name] if walk else sl[name], split_run if walk else main_run)
        entry.update({k: v for k, v in t.items() if k not in entry and k != "bytes"},
                     also_replaces=also,
                     times_run="kinase sharded 4, ragged, host driver, step 200"
                     if not walk else main_run + ", its walk's round form")
        # the several-card step: its launches on two cards of one (and on
        # every card, where the machine has several), the consensus over
        # the snapshots checked and timed on the split run's last step
        split = dict(launches=sh["kinase_split"]["launches"][name],
                     run="kinase sharded 4, two cards of one (chunked driver)")
        if name == "consensus":
            split.update({k: v for k, v in sh["split_consensus"].items() if k != "bytes"})
        if isinstance(sh.get("multi_card"), dict):
            split["multi_card_launches"] = [r["launches"][name]
                                            for r in sh["multi_card"]["runs"]]
        entry["split_cards"] = split
        # a ProcessMesh's step graph on one card (the rank form): its
        # launches there under each exchange, and each rank's exchange at
        # step 200 checked and timed: from every rank's wire by address
        # (ragged), from its received blocks (dense); and from another
        # process's wire mapped through CUDA IPC (ipc_check)
        rf = sh["rank_form"]
        rank = dict(launches=rf["launches"][name], dense_launches=rf["dense"]["launches"][name],
                    run="kinase sharded 4, rank form on one card (chunked driver, ragged; "
                        "dense_launches: dense)")
        if name == "exchange":
            rank["mapped"] = {k: v for k, v in rf["exchange_check"].items() if k != "bytes"}
            rank["received"] = {k: v for k, v in rf["dense"]["exchange_check"].items()
                                if k != "bytes"}
            rank["ipc_two_processes"] = {k: v for k, v in sh["ipc"].items()
                                         if k not in ("ranks", "bytes")}
        if isinstance(sh.get("multi_process"), dict):
            # each rank's launches in each turn, where the machine has cards
            # for a ProcessMesh
            mp = sh["multi_process"]
            rank["process_mesh"] = dict(order=mp["order"], launches=[
                [r["launches"].get(name, 0) for r in runs] for runs in mp["turns"]])
        entry["rank_form"] = rank
        kernels.append(entry)
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", metavar="PATH", default=None,
                    help="also write the full report (every phase's numbers) "
                         "as JSON to PATH")
    ap.add_argument("--k1-baseline", metavar="SRC", default=None,
                    help="also build the first version of "
                         "csrc/pair_wavefront.cu (its C entry without launch "
                         "shape or scratch) and time it in turns with this one")
    ap.add_argument("--k8-baseline", metavar="SRC", default=None,
                    help="also build another tree's csrc/gotoh_wavefront.cu (SRC: "
                         "the file, or a checkout's root or csrc/; its C entry "
                         "without the scratch), check it against this K8 and time "
                         "the two in turns")
    ap.add_argument("--k11-baseline", metavar="SRC", default=None,
                    help="also build another tree's csrc/route_pack.cu (SRC: the "
                         "file, or a checkout's root or csrc/; the C entries "
                         "route_count and route_pack of this tree's signatures), "
                         "check it against route_plain on K11's inputs and time "
                         "the two K11s in turns (device, each pass alone)")
    ap.add_argument("--k6s-baseline", metavar="SRC", default=None,
                    help="also build another tree's csrc/shard_loop.cu (SRC: the "
                         "file, or a checkout's root or csrc/), check each of its "
                         "C entries that has the form its turns call (consensus "
                         "and exchange with their tables on the card, 40505e8's "
                         "and da6a26a's; walk_advance with its runs in a host "
                         "table, 2dd56fa's) on the sharded step 200's consensus "
                         "and exchange and on the walk's first round, and time "
                         "each in turns with this tree's (walk_advance also in "
                         "the walk loop: its wall and a round's device span)")
    ap.add_argument("--k11-sweep", action="store_true",
                    help="also check and time K11 on synthetic inputs at kinase's "
                         "shapes with 64, 636, 4096, 8192, 16384 and 31744 rows a "
                         "destination (in turns with --k11-baseline's), with each "
                         "sort's barriers (counted) and c408a21's bitonic stages")
    ap.add_argument("--k2-baseline", metavar="SRC", default=None,
                    help="also build the plane-per-launch version of "
                         "csrc/triple_wavefront.cu (its C entry with Dmax and "
                         "threads) and time it in turns with this one")
    ap.add_argument("--k2-variant", metavar=("BIxBJxBK", "SRC"), nargs=2,
                    action="append", default=[],
                    help="also build SRC, an edited copy of "
                         "csrc/triple_wavefront.cu compiled for the tile "
                         "BIxBJxBK, check it at kinase and time it in turns "
                         "with this one (repeatable)")
    ap.add_argument("--step-baseline", metavar="SRC", default=None,
                    help="also build the K3 and K4 sources (select_best.cu, "
                         "sig_expand.cu, step_state.cuh; the C entries of the "
                         "version with a memset and one block a group) of "
                         "the tree SRC (a checkout's root or its csrc/), check "
                         "them against these on the kinase step tables and "
                         "time them in turns with these")
    ap.add_argument("--keyrow-baseline", metavar="SRC", default=None,
                    help="also build the K10 and K7 sources (keyrow_insert.cu, "
                         "path_walk.cu and their headers, this tree's C entries) "
                         "of the tree SRC (a checkout's root or its csrc/), check "
                         "its K10 against this one on the globin6, kinase-unpacked "
                         "and synth10 step tables and on the sharded step 200's "
                         "received rows, and its K7 on the timed walks, and time "
                         "them in turns")
    ap.add_argument("--k10-sweep", action="store_true",
                    help="also time K10 against its list length (64 to 4096, packed "
                         "and unpacked, without and with received rows): the whole "
                         "list in one block (builds with 4 and 8 lanes a thread "
                         "above K10_CAP) against round 0 on the grid and against "
                         "every round on the grid (and --keyrow-baseline's K10); and "
                         "on each of its paths at every step of the globin6, "
                         "kinase-unpacked and synth10 searches, by the lanes left "
                         "after round 0")
    ap.add_argument("--k5-sweep", action="store_true",
                    help="also time K5 on its block path and on its grid path at "
                         "every step of kinase (auto, off) and synth6 searches, by "
                         "pending count")
    ap.add_argument("--step-only", action="store_true",
                    help="run the device, build and step-kernel phases only "
                         "(a quick check of K3-K5; prints no result line)")
    ap.add_argument("--sharded-only", action="store_true",
                    help="run the device, build and sharded-engine phases only "
                         "(a quick check of the multi-device step; prints no "
                         "result line)")
    ap.add_argument("--k11-only", action="store_true",
                    help="run the device, build and K11 checks only: kinase on 4 shards "
                         "(packed, unpacked, sig) to the golden, K11 on each run's step "
                         "200 with its K11_PHASES split (and --k11-baseline's in turns, "
                         "--k11-sweep), and a traced dense run (prints no result line)")
    ap.add_argument("--k9s-only", action="store_true",
                    help="run the device, build and K9s checks only: kinase on 4 shards "
                         "(packed, unpacked) to the golden with step 200 captured, and "
                         "the random 4 x 12-16 input on 4 shards (packed, unpacked) with "
                         "step 6 captured; K9s on each, every rows a block of --k9s-rows "
                         "checked against its plain version, timed and split by its "
                         "K9S_PHASES build (and --k9s-baseline's in turns); a traced dense "
                         "run (prints no result line)")
    ap.add_argument("--k9s-baseline", metavar="SRC", default=None,
                    help="also build another tree's csrc/keyrow_expand.cu (SRC: a "
                         "checkout's root or csrc/), check its K9s against the plain "
                         "version on K9s's inputs and time it in turns with this tree's; "
                         "with --k9s-only also its unsharded K9 at globin6 step 60 and "
                         "synth10 step 20 (bit for bit with this tree's, in turns)")
    ap.add_argument("--k9s-rows", metavar="R,R,...", default=None,
                    help="the rows a block of K9s's sweep (default 0,1,2,4,8; 0 the block "
                         "form, a block a row)")
    ap.add_argument("--k4s-only", action="store_true",
                    help="run the device, build and K4s checks only: synth5 on 4 shards "
                         "(auto: sig) chunked to its optimum, then kinase pinned to sig and "
                         "synth5 under the host driver with steps 200 and 150 captured and "
                         "synth6 (N = 6) with step 40; K4s on each, every rows a block of "
                         "--k4s-rows checked against its plain version, timed and split by "
                         "its K4S_PHASES build (and --k4s-baseline's in turns); traced "
                         "dense sig runs with each form (prints no result line)")
    ap.add_argument("--k4s-baseline", metavar="SRC", default=None,
                    help="also build another tree's csrc/sig_expand.cu (SRC: a checkout's "
                         "root or csrc/), check its K4s against the plain version on K4s's "
                         "inputs and time it in turns with this tree's")
    ap.add_argument("--k4s-rows", metavar="R,R,...", default=None,
                    help="the rows a block of K4s's sweep (default 0,1,2,4,8; 0 the "
                         "warp-strided form)")
    ap.add_argument("--multi-card-only", action="store_true",
                    help="run the device, build and the sharded engine's multi-card "
                         "phase only (kinase on every card, chunked and host in turns, "
                         "then on a ProcessMesh of one NCCL rank a card, chunked and "
                         "host in turns; two cards or more; prints no result line)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 32 mid-search steps with torch.profiler "
                         "(device time by kernel, launches and host reads a "
                         "step, idle share), each through the chunk graph, "
                         "the eager chunk and the plain step: kinase under "
                         "--triples auto and off (sig), globin6 (packed) "
                         "and kinase pinned to unpacked")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not os.path.isdir(os.path.join(ROOT, "mpi_pastar_msa_tpu_torch")):
        fail("the mpi_pastar_msa_tpu_torch package is not beside this script")
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    from mpi_pastar_msa_tpu_torch import _kernels

    # 2. build: the kernels and, beside them, the measurement builds (and
    # another tree's K10 and K7, and K10 with more lanes a thread)
    t0 = time.perf_counter()
    phases_tmp = tempfile.TemporaryDirectory()
    phases_jobs = [start_phases_build(name, phases_tmp.name)
                   for name in ("select_best", "sig_probe")]
    k10_phases_job = start_phases_build("keyrow_insert", phases_tmp.name)
    k10_wide_jobs = start_k10_wide_builds(phases_tmp.name) if args.k10_sweep else {}
    k8_no_store_job = start_phases_build("gotoh_wavefront", phases_tmp.name)
    k11_count_job = start_phases_build("route_pack", phases_tmp.name)
    k11_phases_job = start_phases_build("route_pack", phases_tmp.name, "K11_PHASES")
    # the key-row copy without its loads, and without its stores to device
    # memory
    k11_copy_jobs = {v: start_phases_build("route_pack", phases_tmp.name,
                                           f"K11_PHASES+K11_COPY_{m}")
                     for v, m in (("no_loads", "NO_LOAD"), ("no_stores", "NO_STORE"))
                     } if args.k11_only else {}
    keyrow_job = (start_keyrow_baseline(os.path.abspath(args.keyrow_baseline),
                                        phases_tmp.name) if args.keyrow_baseline else None)
    k8_job = (start_k8_baseline(os.path.abspath(args.k8_baseline), phases_tmp.name)
              if args.k8_baseline else None)
    k11_job = (start_k11_baseline(os.path.abspath(args.k11_baseline), phases_tmp.name)
               if args.k11_baseline else None)
    k6s_job = (start_k6s_baseline(os.path.abspath(args.k6s_baseline), phases_tmp.name)
               if args.k6s_baseline else None)
    k9s_phases_job = start_phases_build("keyrow_expand", phases_tmp.name, "K9S_PHASES")
    k9s_job = (start_k9s_baseline(os.path.abspath(args.k9s_baseline), phases_tmp.name)
               if args.k9s_baseline else None)
    k4s_phases_job = start_phases_build("sig_expand", phases_tmp.name, "K4S_PHASES")
    k4s_job = (start_k4s_baseline(os.path.abspath(args.k4s_baseline), phases_tmp.name)
               if args.k4s_baseline else None)
    try:
        logs = _kernels.build_all()
    finally:
        phases = tuple(load_phases(job) for job in phases_jobs) + (
            load_k10_phases(k10_phases_job),)
        k8_no_store = load_phases(k8_no_store_job)
        k10_wide = load_k10_wide(k10_wide_jobs)
        k11_count = load_k11_barriers(k11_count_job)
        k11_phases = load_k11_phases(k11_phases_job)
        k11_copy = {v: load_k11_phases(j, f"the K11_PHASES build, the key-row copy "
                                          f"{v.replace('_', ' ')}")
                    for v, j in k11_copy_jobs.items()}
        keyrow_baseline = load_keyrow_baseline(keyrow_job) if keyrow_job else None
        k8_baseline = load_k8_baseline(k8_job) if k8_job else None
        k11_baseline = load_k11_baseline(k11_job) if k11_job else None
        k6s_baseline = load_k6s_baseline(k6s_job) if k6s_job else None
        k9s = dict(phases=load_k9s_phases(k9s_phases_job),
                   baseline=load_k9s_baseline(k9s_job) if k9s_job else None,
                   rows=tuple(int(r) for r in args.k9s_rows.split(",")) if args.k9s_rows
                   else None)
        k4s = dict(phases=load_k4s_phases(k4s_phases_job),
                   baseline=load_k4s_baseline(k4s_job) if k4s_job else None,
                   rows=tuple(int(r) for r in args.k4s_rows.split(",")) if args.k4s_rows
                   else None)
    if keyrow_baseline:
        K7_VARIANTS["baseline"] = keyrow_baseline["path_walk"]
    print(f"build: {len(logs)} kernel source(s) and the K3_PHASES, K5_PHASES, K10_PHASES, "
          f"K8_NO_STORE, K11_BARRIERS, K11_PHASES, K9S_PHASES and K4S_PHASES builds "
          f"in {time.perf_counter() - t0:.1f} s")
    ptxas = [f"{name}: {line.strip()}" for name, log in logs.items()
             for line in log.splitlines()
             if "entry function" in line or "registers" in line or "spill" in line]
    for line in ptxas:
        print(f"  {line}")

    report = {"card": smi, "ptxas": ptxas}
    with tempfile.TemporaryDirectory() as tmp:
        gold, paths = rebuild_inputs(tmp)
        # 3. kernel check
        baseline = None
        if args.k1_baseline:
            baseline = (args.k1_baseline,
                        build_baseline_k1(os.path.abspath(args.k1_baseline), tmp))
        step_baseline = None
        if args.step_baseline:
            src = os.path.abspath(args.step_baseline)
            step_baseline = (args.step_baseline, build_step_baseline(src, tmp))
        report["launch_floor"] = floor = launch_floor()
        report["dependent_load"] = chase = dependent_load_ns()
        if args.multi_card_only:
            if torch.cuda.device_count() < 2:
                fail("--multi-card-only needs two cards or more")
            report["multi_card"] = multi_card_phase(paths["kinase.fasta"], gold["kinase.fasta"])
            report["multi_process"] = process_mesh_run(paths["kinase.fasta"],
                                                       gold["kinase.fasta"],
                                                       torch.cuda.device_count())
            write_report(args.report, report)
            return 0  # a partial run: no kernels line and no result line
        if args.k11_only:
            report["k11"] = k11_phase(paths, gold, dict(count=k11_count, phases=k11_phases,
                                                        baseline=k11_baseline,
                                                        copy_variants=k11_copy),
                                      args.k11_sweep)
            write_report(args.report, report)
            return 0  # a partial run: no kernels line and no result line
        if args.k9s_only:
            report["k9s"] = k9s_phase(paths, gold, k9s)
            write_report(args.report, report)
            return 0  # a partial run: no kernels line and no result line
        if args.k4s_only:
            report["k4s"] = k4s_phase(paths, gold, k4s)
            write_report(args.report, report)
            return 0  # a partial run: no kernels line and no result line
        if args.sharded_only:
            report["sharded"] = sharded_phase(paths, gold, floor, chase, k11_count, k11_baseline,
                                              args.k11_sweep, k6s_baseline, phases[2],
                                              keyrow_baseline, k11_phases, k9s, k4s)
            write_report(args.report, report)
            return 0  # a partial run: no kernels line and no result line
        report["capture"] = capture_check(paths)
        report["chunk_setup"] = chunk_setup_check()
        if args.k5_sweep:
            report["k5_sweep"] = k5_sweep(paths, step_baseline and step_baseline[1])
        if args.k10_sweep:
            report["k10_list_sweep"] = k10_list_sweep(paths["kinase.fasta"], k10_wide,
                                                      keyrow_baseline)
        if args.step_only:
            report["step"] = step_kernels(paths, step_baseline, floor, phases, keyrow_baseline,
                                          args.k10_sweep)
            write_report(args.report, report)
            return 0  # a partial run: no kernels line and no result line
        report["k1"] = check_k1(paths, baseline)
        report["k8"] = check_k8(paths, k8_baseline, k8_no_store)
        report["phase1"] = phase1_walls(paths)
        k2_baseline = None
        if args.k2_baseline:
            k2_baseline = (args.k2_baseline,
                           build_baseline_k2(os.path.abspath(args.k2_baseline), tmp))
        variants = []
        for tile, src in args.k2_variant:
            tile = tuple(int(v) for v in tile.split("x"))
            variants.append((tile, src, build_variant_k2(tile, os.path.abspath(src), tmp)))
        report["k2"] = check_k2(paths, k2_baseline, variants)
        report["step"] = step_kernels(paths, step_baseline, floor, phases, keyrow_baseline,
                                      args.k10_sweep)
        # 4. / 5. main path (CLI defaults: --triples auto), then pairwise
        report["kinase"] = main_path("kinase", paths["kinase.fasta"],
                                     gold["kinase.fasta"], False, "auto", k7_timing=True)
        if report["kinase"]["cubes"] != 4:
            fail(f"kinase: {report['kinase']['cubes']} cubes, want 4")
        report["kinase_off"] = main_path("kinase", paths["kinase.fasta"],
                                         gold["kinase.fasta"], False, "off")
        # N = 6 on the sig layout: 63 masks a row, two passes of a warp in K4
        report["synth6"] = main_path("synth6", data_path("synth6"),
                                     data_gold("synth6", SYNTH6_G), False, "auto")
        for name in ("test.fasta", "test2.fasta", "PF08184.fasta"):
            for triples in ("auto", "off"):
                report[f"{name}_{triples}"] = main_path(
                    name, paths[name], gold[name], True, triples)
        # the CLI's other engines, Phase 1 on the card
        report["engines"] = {
            "test2_auto": cli_engine("test2.fasta", paths["test2.fasta"], gold["test2.fasta"],
                                     [], want_line="engine auto -> native"),
            "PF08184_serial": cli_engine("PF08184.fasta", paths["PF08184.fasta"],
                                         gold["PF08184.fasta"], ["--engine", "serial"]),
            "PF08184_native_t4": cli_engine("PF08184.fasta", paths["PF08184.fasta"],
                                            gold["PF08184.fasta"],
                                            ["--engine", "native", "-t", "4"])}
        # 6. layouts beyond sig, through K3, K9 and K10; synth10's step
        # checked against the plain step on its main-path engine (its host
        # upper-bound beam alone takes ~100 s)
        engines = {}
        for name, g in LAYOUT_INPUTS.items():
            report[f"{name}_auto"] = main_path(name, data_path(name), data_gold(name, g),
                                               False, "auto", want_layout="packed",
                                               engines=engines, k7_timing=name == "globin6")
        eng, tab, ctr = warm_engine(None, "auto", 20, eng=engines.pop("synth10"))
        report["step"]["synth10_keyrow"] = keyrow_step("synth10", eng, tab, ctr,
                                                       baseline=keyrow_baseline)
        del tab, ctr
        report["step"]["synth10_tail"] = k10_tail_sweep("synth10", eng, args.k10_sweep)
        del eng, engines
        for layout in ("packed", "unpacked"):
            report[f"kinase_{layout}"] = pinned_layout(
                "kinase", paths["kinase.fasta"], gold["kinase.fasta"], layout, False,
                k7_timing=layout == "unpacked")
        for name in ("test.fasta", "test2.fasta", "PF08184.fasta"):
            for layout in ("packed", "unpacked"):
                report[f"{name}_{layout}"] = pinned_layout(
                    name, paths[name], gold[name], layout, True)
        # K7 on the engine's own walk, alone or in turns with another tree's
        # (baseline, K7, K7, baseline)
        order = [n for v in K7_VARIANTS for n in (v, "K7", "K7", v)] or ["K7"]
        report["k7_engine_walk"] = {
            f"{label}_{layout}": engine_walk(label, paths.get(name) or data_path(name),
                                             layout, order)
            for label, name, layout in ENGINE_WALKS}
        report["degenerate"] = degenerate_input()
        # checkpoint/resume: interrupted by max_steps, resumed by a new engine
        report["checkpoint"] = {
            "kinase": checkpoint_resume("kinase", paths["kinase.fasta"],
                                        gold["kinase.fasta"], "sig", tmp),
            "globin6": checkpoint_resume("globin6", data_path("globin6"),
                                         data_gold("globin6", LAYOUT_INPUTS["globin6"]),
                                         "packed", tmp)}
        # 7. the sharded engine (parallel/sharded.py) on [cuda:0] * 4
        report["sharded"] = sharded_phase(paths, gold, floor, chase, k11_count, k11_baseline,
                                          args.k11_sweep, k6s_baseline, phases[2],
                                          keyrow_baseline, k11_phases, k9s, k4s)
        if args.profile:
            # mid-search windows: auto takes about 300 steps, off about 970
            # and the plain step on the same windows, the step before K3-K5
            for triples, warm in (("auto", 150), ("off", 400)):
                for mode in ("engine", "eager", "plain"):
                    report[f"profile_{triples}_{mode}"] = profile_search(
                        "kinase", paths["kinase.fasta"], triples, warm, 32, mode)
            # the packed layout: globin6 takes about 150 steps; kinase pinned
            # to unpacked
            for mode in ("engine", "eager", "plain"):
                report[f"profile_globin6_{mode}"] = profile_search(
                    "globin6", data_path("globin6"), "auto", 60, 32, mode)
                report[f"profile_kinase_unpacked_{mode}"] = profile_search(
                    "kinase", paths["kinase.fasta"], "auto", 150, 32, mode, layout="unpacked")

    phases_tmp.cleanup()
    write_report(args.report, report)

    k1, k2, k8 = report["k1"]["kinase"], report["k2"]["kinase"], report["k8"]["kinase"]
    launches = report["kinase"]["launches"]  # the main path's run
    # launch floors: K1's call is two launches, K2's its tile diagonals'
    # dependent launches, K3-K5 one each
    k1_floor = launch_floor(2)["ms"]
    kernels = [{
        "name": "pair_wavefront", "route": "cuda",
        "source": "mpi_pastar_msa_tpu_torch/csrc/pair_wavefront.cu",
        "replaces": "mpi_pastar_msa_tpu/heuristic/wavefront_pallas.py:35",
        "launches": launches["pair_wavefront"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "device_ms": k1["device_ms"],
        "launch_floor_ms": k1_floor,
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
    }, {
        "name": "gotoh_wavefront", "route": "cuda",
        "source": "mpi_pastar_msa_tpu_torch/csrc/gotoh_wavefront.cu",
        "replaces": "mpi_pastar_msa_tpu/heuristic/gotoh_wavefront.py:38",
        "launches": launches["gotoh_wavefront"],
        "max_abs_err": max(r["max_abs_err"] for r in report["k8"].values()),
        "ms": k8["ms"], "device_ms": k8["device_ms"], "launch_floor_ms": floor["ms"],
        "fill_device_ms": k8["fill_device_ms"],
        "fill_no_store_device_ms": k8["fill_no_store_device_ms"],
        "transpose_device_ms": k8["transpose_device_ms"], "scratch_bytes": k8["scratch_bytes"],
        "plain_ms": k8["plain_ms"], "host_fill_ms": k8["host_fill_ms"],
        "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
        "chain_floor_ms": k8["chain_floor_ms"], "library_ms": None,
        **({"turns": k8["turns"]} if "turns" in k8 else {}),
        **{label: {k: r[k] for k in ("ms", "device_ms", "fill_device_ms",
                                     "fill_no_store_device_ms", "transpose_device_ms",
                                     "scratch_bytes", "plain_ms",
                                     "host_fill_ms", "bound_ms", "bound_by", "chain_floor_ms",
                                     "turns") if k in r}
           for label, r in report["k8"].items() if label != "kinase"},
    }, {
        "name": "triple_wavefront", "route": "cuda",
        "source": "mpi_pastar_msa_tpu_torch/csrc/triple_wavefront.cu",
        "replaces": "mpi_pastar_msa_tpu/heuristic/triples.py:194",
        "launches": launches["triple_wavefront"],
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "device_ms": k2["device_ms"],
        "launch_floor_ms": k2["chain_floor_ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None,
    }]
    # the step kernels, timed at kinase --triples auto (step 150); their
    # max |err| is the largest of the step checks (1 and 32 steps, auto and
    # off, and K3 on globin6's packed table)
    step = report["step"]
    step_err = max([c["max_abs_err"] for t in ("auto", "off") for c in step[t]["checks"]]
                   + [step["globin6_k3"]["max_abs_err"]])
    for name, key, replaces in (
            ("select_best", "k3", "mpi_pastar_msa_tpu/search/engine.py:1620"),
            ("sig_expand", "k4", "mpi_pastar_msa_tpu/search/engine.py:497"),
            ("sig_probe", "k5", "mpi_pastar_msa_tpu/search/engine.py:1551")):
        t = step["auto"][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpi_pastar_msa_tpu_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": launches[name], "max_abs_err": step_err, "ms": t["ms"],
            "device_ms": t["device_ms"], "launch_floor_ms": floor["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t.get("library_ms")})
    # the packed and unpacked step kernels, timed at globin6 step 60
    # (packed) and kinase pinned to unpacked (step 150); launches from the
    # packed main path (globin6 through the CLI) and the unpacked one
    # (kinase pinned); max |err| the largest of their step checks
    kr = [step[k] for k in ("globin6_keyrow", "kinase_unpacked_keyrow", "synth10_keyrow")]
    kr_err = max(c["max_abs_err"] for r in kr for c in r["checks"])
    g6, ku = step["globin6_keyrow"], step["kinase_unpacked_keyrow"]
    for name, t, run, replaces, extra in (
            ("select_best_unpacked", ku["k3"], "kinase_unpacked",
             "mpi_pastar_msa_tpu/search/engine.py:858", {}),
            ("keyrow_expand", g6["k9"], "globin6_auto",
             "mpi_pastar_msa_tpu/search/engine.py:1720", {"unpacked": ku["k9"]}),
            ("keyrow_insert", g6["k10"], "globin6_auto",
             "mpi_pastar_msa_tpu/search/engine.py:1262", {"unpacked": ku["k10"]})):
        src = "select_best" if name == "select_best_unpacked" else name
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpi_pastar_msa_tpu_torch/csrc/{src}.cu", "replaces": replaces,
            "launches": report[run]["launches"][name], "launches_run": run,
            "max_abs_err": kr_err, "ms": t["ms"], "device_ms": t["device_ms"],
            "launch_floor_ms": floor["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t.get("bound_by", "bytes"),
            "library_ms": t.get("library_ms"), **{k: dict(ms=v["ms"], device_ms=v["device_ms"],
                                                          plain_ms=v["plain_ms"],
                                                          bound_ms=v["bound_ms"],
                                                          bound_by=v.get("bound_by", "bytes"))
                                                   for k, v in extra.items()}})
    # K9 at each window: its launch shape, lanes and bounds
    kernels[-2].update({f"{w}_k9": {k: t[k] for k in (
        "device_ms", "blocks", "threads", "passes", "rows", "lanes", "pending",
        "settled_in_k9", "masks", "bytes_bound_ms", "ops_bound_ms", "int32_bound_ms",
        "shared_bound_ms", "bound_by")}
        for w, t in (("globin6", g6["k9"]), ("kinase_unpacked", ku["k9"]),
                     ("synth10", step["synth10_keyrow"]["k9"]))})
    # K10's latency floor, and at each window its paths, phases and the
    # other tree's K10 in turns
    kernels[-1]["latency_floor_ms"] = k10_latency_floor(floor, chase, g6["rounds"])
    kernels[-1]["unpacked"]["latency_floor_ms"] = k10_latency_floor(floor, chase, ku["rounds"])
    kernels[-1].update({f"{w}_k10_paths": dict(
        path=t["path"], tail=t["tail"], grid_syncs=t["grid_syncs"], device_ms=t["device_ms"],
        grid_path_device_ms=t["grid_device_ms"], grid_path_syncs=t["grid_path_syncs"],
        **{k: t[k] for k in ("list", "phases", "grid_phases", "baseline") if k in t})
        for w, t in (("globin6", g6["k10"]), ("kinase_unpacked", ku["k10"]),
                     ("synth10", step["synth10_keyrow"]["k10"]))})
    # a chunk's set-up (K6): checked alone against its plain version,
    # launched once a chunk
    cs = report["chunk_setup"]
    kernels.append({
        "name": "chunk_setup", "route": "cuda",
        "source": "mpi_pastar_msa_tpu_torch/csrc/chunk_setup.cu",
        "replaces": "mpi_pastar_msa_tpu/search/engine.py:1882",
        "launches": launches["chunk_setup"], "max_abs_err": cs["max_abs_err"], "ms": cs["ms"],
        "device_ms": cs["device_ms"], "launch_floor_ms": floor["ms"],
        "plain_ms": cs["plain_ms"], "bound_ms": cs["bound_ms"], "bound_by": "bytes",
        "library_ms": None})
    # K7, the walk: timed on the main path's kinase table (sig), checked on
    # every run's; the latency floor is path nodes x one dependent load
    # from L2 (and, beside it, from device memory)
    runs = [v for v in report.values() if isinstance(v, dict) and "k7" in v]
    k7 = report["kinase"]["k7"]
    kernels.append({
        "name": "path_walk", "route": "cuda",
        "source": "mpi_pastar_msa_tpu_torch/csrc/path_walk.cu",
        "replaces": "mpi_pastar_msa_tpu/search/engine.py:1936",
        "launches": launches["path_walk"], "checked_runs": len(runs),
        "max_abs_err": max(r["k7"]["max_abs_err"] for r in runs),
        "ms": k7["ms"], "device_ms": k7["device_ms"], "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound_ms"], "bound_by": "bytes",
        "latency_floor_ms": k7["path_nodes"] * chase["l2_ns"] / 1e6,
        "latency_floor_dram_ms": k7["path_nodes"] * chase["dram_ns"] / 1e6,
        "path_nodes": k7["path_nodes"], "library_ms": None,
        "cold_device_ms": k7["cold_device_ms"],
        "engine_walk": report["k7_engine_walk"],
        **{f"{v}_k7": k7[f"{v}_k7"] for v in K7_VARIANTS},
        **{run: dict(ms=report[run]["k7"]["ms"], device_ms=report[run]["k7"]["device_ms"],
                     cold_device_ms=report[run]["k7"]["cold_device_ms"],
                     **{f"{v}_k7": report[run]["k7"][f"{v}_k7"] for v in K7_VARIANTS},
                     plain_ms=report[run]["k7"]["plain_ms"],
                     bound_ms=report[run]["k7"]["bound_ms"],
                     path_nodes=report[run]["k7"]["path_nodes"],
                     latency_floor_ms=report[run]["k7"]["path_nodes"] * chase["l2_ns"] / 1e6,
                     latency_floor_dram_ms=report[run]["k7"]["path_nodes"]
                     * chase["dram_ns"] / 1e6)
           for run in ("globin6_auto", "kinase_unpacked")}})
    kernels += sharded_kernel_entries(report["sharded"], floor, chase)
    walls = {k: v["engine_walls"]["walk"] for k, v in report.items()
             if isinstance(v, dict) and "engine_walls" in v}
    print("walk walls (s): " + ", ".join(f"{k} {w:.4f}" for k, w in walls.items()))
    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
