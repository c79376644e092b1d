"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit):

1. device: a CUDA device must exist; prints the card's name and power limit.
2. build: compiles every kernel from csrc/ (one nvcc per source, in parallel).
3. kernel check: each kernel against its plain PyTorch version on the card,
   exact int32 equality.  K1 (pair wavefront) at the main path's shapes
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
   auto from step 150, off from step 400) and the plain step functions run
   the same steps on copies: t_sig, t_best, t_closed and the 14 counters
   must be identical (also with K5 on 1 and on 132 blocks); K3 alone
   against the plain select on globin6's packed table.  Kernel, plain and
   bound times of K3, K4, K5 and the whole step, each kernel's device time
   (CUPTI, torch.profiler) beside its event-timed wrapper call, the
   empty-kernel launch floor, K3's library yardstick (torch.min) with its
   own bound (``--step-baseline SRC`` builds the K3 and K4 sources of
   another tree, checks them against these and times them in turns on the
   same tables; ``--step-only`` stops after this phase).
4. main path, kinase: the port's CLI entry with its defaults (--triples
   auto, --device cuda) must build 4 cubes and reach g = 421546 with a path
   whose recomputed cost equals g, degapped rows equal to the inputs, and
   K1, K2 and the step kernels K3-K5 launched; then the same with
   --triples off (K1 and K3-K5 launched); then synth6 (tests/data, N = 6,
   63 masks a row) with the CLI's defaults on the sig layout: g = 272848.
5. main path, test / test2 / PF08184, under auto and under off: golden g and
   byte-identical alignment.
6. layouts: globin6, synth7 and synth10 (tests/data) through the CLI with
   its defaults must take the packed table layout (their keys do not fit a
   sig word at C = 2^23), build cubes, launch K1, K2 and K3 and reach their
   certified optima; kinase with the layout pinned to packed and to unpacked
   (engine entry, as --profile drives it) must reach g = 421546; test, test2
   and PF08184 with each pinned must stay byte-identical to the goldens;
   the degenerate input ("WYWY", "WYY", "YWW") must warn, take the
   unpacked layout and complete.
7. the kernels JSON line, then the result line.

Inputs are rebuilt from tests/goldens.json (the degapped golden rows) and
read from tests/data/*.fasta.  Weights are not random: the system runs no
model, and its data are these real sequences.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (data sheet)
PEAK_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
K1_OPS_PER_CELL = 12          # int32 adds/compares/selects per DP cell
K2_OPS_PER_CELL = 7 * 12      # 7 moves x ~12 int32 ops per in-box cube cell
# certified optima of the tests/data inputs beyond the sig layout
# (tests/test_globin6.py, tests/test_beyond_reference.py)
LAYOUT_INPUTS = {"globin6": 988171, "synth7": 402469, "synth10": 575615}
SYNTH6_G = 272848  # tests/test_synth6.py
STEP_KERNELS = ["select_best", "sig_expand", "sig_probe"]


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


def profiler_preamble() -> None:
    """What a torch.profiler session runs before the work it measures: 32
    short spin kernels (torch.cuda._sleep), then 50 ms of host time.  A
    session can miss the device events of its first moments (seen on the
    card: the first 4 of 32 steps of a window); these take their place.
    Their events are named spin_kernel and every count leaves them out."""
    for _ in range(32):
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
        ops_ms = cells * K1_OPS_PER_CELL / PEAK_OPS_PER_S * 1e3
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
        ops_ms = cells * K2_OPS_PER_CELL / PEAK_OPS_PER_S * 1e3
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


def warm_engine(path: str, triples: str, warm_steps: int):
    """An engine on the card run ``warm_steps`` steps into its search;
    returns (engine, table, counters)."""
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search import engine as E

    p = problem_from_fasta(path)
    eng = E.FrontierSearch(p, HPairHeuristic.build(p, "cuda"), device="cuda",
                           triples=triples)
    tab = eng._init_table()
    ctr = torch.as_tensor(E.fresh_counters(), device="cuda")
    ctr = E._run_chunk(eng.st, tab, ctr, warm_steps, eng.ub, eng.fill_target, eng.layout)
    return eng, tab, ctr


def build_step_baseline(src: str, tmp: str):
    """Build the K3 and K4 sources of another tree (``src``: a checkout's
    root or its csrc/ directory; select_best.cu, sig_expand.cu and
    step_state.cuh of the version with a memset and one block a group)
    into their own directory, both nvcc at once.  Returns their C entries,
    that version's: select_best(best, closed, C, B, n, f0, goal,
    thr, run, slots, vmin, active, state, stream), a memset of the state
    and two launches; sig_expand(t_sig, t_best, slots, vmin, active,
    tables4, cubes, params, N, P, T, S, n, f0, ub, E, GG, O - E, bbits, B,
    threads, run, counters, state, pend, stream), one block a group."""
    import shutil

    from mpi_pastar_msa_tpu_torch import _kernels

    csrc = src if os.path.isfile(os.path.join(src, "select_best.cu")) else os.path.join(
        src, "mpi_pastar_msa_tpu_torch", "csrc")
    out = os.path.join(tmp, "step_baseline")
    os.makedirs(out, exist_ok=True)
    for f in ("select_best.cu", "sig_expand.cu", "step_state.cuh"):
        shutil.copy(os.path.join(csrc, f), out)
    jobs = {}
    for name in ("select_best", "sig_expand"):
        lib = os.path.join(out, f"lib{name}.so")
        jobs[name] = (lib, subprocess.Popen(
            [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
             os.path.join(out, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    argtypes = {"select_best": [P, P, I, I, I, L, P, P, P, P, P, P, P, P],
                "sig_expand": [P] * 8 + [I] * 5 + [L, L] + [I] * 6 + [P] * 5}
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"step baseline: nvcc failed for {name}.cu of {src}:\n{log}")
        fn = getattr(ctypes.CDLL(lib), name)
        fn.argtypes = argtypes[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns["select_best"], fns["sig_expand"]


def start_k3_phases_build(tmp: str):
    """Start nvcc on csrc/select_best.cu with -DK3_PHASES (its measurement
    build: three %globaltimer readings in the partials when a launch
    ends) into ``tmp``; returns (proc, lib)."""
    from mpi_pastar_msa_tpu_torch import _kernels

    lib = os.path.join(tmp, "libselect_best_phases.so")
    proc = subprocess.Popen(
        [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-DK3_PHASES", "-o", lib,
         os.path.join(_kernels.CSRC, "select_best.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, lib


def load_k3_phases(job):
    """The K3_PHASES build's C entry (the same signature as select_best)."""
    from mpi_pastar_msa_tpu_torch import _kernels

    proc, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc failed for the K3_PHASES build of select_best.cu:\n{log}")
    fn = ctypes.CDLL(lib).select_best
    fn.argtypes = _kernels.SIGNATURES["select_best"]
    fn.restype = ctypes.c_int
    return fn


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


def step_baseline_turns(src, fns, st, ub, work, ctr, bufs, restore_tab, restore3, k3,
                        k4) -> dict:
    """Another tree's K3 and K4 (``fns``, build_step_baseline) on the
    tables of this step: checked against this tree's kernels (K3's outputs,
    t_closed and its state slots; K4's t_best, goal, surviving and pending
    counts and its pending set), then timed in turns, old, new, new, old
    (CUDA events around each wrapper call, median of 20), and by device
    time (CUPTI)."""
    from mpi_pastar_msa_tpu_torch.core.cost import GAP_EXTENSION, GAP_GAP
    from mpi_pastar_msa_tpu_torch.search import step as S

    old_select, old_expand = fns
    stream = torch.cuda.current_stream().cuda_stream
    o_slots, o_vmin, o_active, o_state = (torch.empty_like(t) for t in (
        bufs.slots, bufs.vmin, bufs.active, bufs.state))
    o_pend = torch.empty_like(bufs.pend)
    goal, thr = ctr[0], ctr[7]
    threads = min(256, 32 * ((st.M + 31) // 32))

    def old3():
        if old_select(work.t_best.data_ptr(), work.t_closed.data_ptr(), st.C, st.B, st.nb,
                      st.f0, goal.data_ptr(), thr.data_ptr(), bufs.run.data_ptr(),
                      o_slots.data_ptr(), o_vmin.data_ptr(), o_active.data_ptr(),
                      o_state.data_ptr(), stream):
            fail(f"step baseline: K3 of {src} failed to launch")

    def old4():
        if old_expand(work.t_sig.data_ptr(), work.t_best.data_ptr(), o_slots.data_ptr(),
                      o_vmin.data_ptr(), o_active.data_ptr(), st.d_tables4.data_ptr(),
                      st.d_cubes.data_ptr() if st.T3 else None, bufs.params.data_ptr(),
                      st.n, st.P, st.T3, st.S, st.nb, st.f0, int(ub), GAP_EXTENSION,
                      GAP_GAP, st.gap_oe, st.bbits, st.B, threads, bufs.run.data_ptr(),
                      ctr.data_ptr(), o_state.data_ptr(), o_pend.data_ptr(), stream):
            fail(f"step baseline: K4 of {src} failed to launch")

    restore_tab()
    k3()
    torch.cuda.synchronize()
    new3 = [t.clone() for t in (bufs.slots, bufs.vmin, bufs.active, work.t_closed,
                                bufs.state[:S.STATE_NVALID])]
    restore_tab()
    old3()
    torch.cuda.synchronize()
    old3_out = (o_slots, o_vmin, o_active, work.t_closed, o_state[:S.STATE_NVALID])
    if not all(torch.equal(a, b) for a, b in zip(new3, old3_out)):
        fail(f"step baseline: K3 of {src} differs from this one")
    after_old3 = o_state.clone()

    def restore_old3():
        restore_tab()
        o_state.copy_(after_old3)

    def k4_result(state, pend):
        n = int(state[S.STATE_NPEND])
        return (work.t_best.clone(), ctr.clone(),
                state[S.STATE_NVALID:S.STATE_NPEND + 1].clone(),
                sorted(map(tuple, pend[:n].tolist())))

    restore3()
    k4()
    torch.cuda.synchronize()
    new4 = k4_result(bufs.state, bufs.pend)
    restore_old3()
    old4()
    torch.cuda.synchronize()
    got4 = k4_result(o_state, o_pend)
    if not (all(torch.equal(a, b) for a, b in zip(new4[:3], got4[:3]))
            and new4[3] == got4[3]):
        fail(f"step baseline: K4 of {src} differs from this one")
    k3_turns = [time_restored(f, restore_tab, 20) for f in (old3, k3, k3, old3)]
    k4_turns = [time_restored(f, r, 20) for f, r in (
        (old4, restore_old3), (k4, restore3), (k4, restore3), (old4, restore_old3))]
    out = dict(source=src, k3_turns_ms=k3_turns, k4_turns_ms=k4_turns,
               k3_old_device_ms=device_ms(old3, 20, restore_tab),
               k3_new_device_ms=device_ms(k3, 20, restore_tab),
               k4_old_device_ms=device_ms(old4, 20, restore_old3),
               k4_new_device_ms=device_ms(k4, 20, restore3))
    print(f"  baseline {src}: its K3 and K4 give the same outputs; in turns (old, new, "
          f"new, old) K3 {' / '.join(f'{t:.4f}' for t in k3_turns)} ms, K4 "
          f"{' / '.join(f'{t:.4f}' for t in k4_turns)} ms; device: K3 old "
          f"{out['k3_old_device_ms']:.4f} new {out['k3_new_device_ms']:.4f} ms, K4 old "
          f"{out['k4_old_device_ms']:.4f} new {out['k4_new_device_ms']:.4f} ms")
    return out


def step_kernels(paths, baseline=None, floor=None, phases=None) -> dict:
    """The step kernels K3 -> K4 -> K5 against the plain step on the card:
    kinase under --triples auto (from step 150) and off (from step 400),
    1 and 32 steps from one table, through run_chunk_sig_cuda and through
    _run_chunk_plain(plain_select=True); t_sig, t_best, t_closed (the first
    C slots) and the 14 counters must be identical.  The 1-step case also
    runs K5 on one block and on 132, which must not change anything.  Then
    K3 alone against _select_best_plain on globin6's packed table (step
    60).  Times at kinase: K3, K4, K5 and the whole step, kernel (CUDA
    events around the wrapper call, and the device time from CUPTI) and
    plain, with their bounds by bytes, and K3's library yardstick with its
    own bound.  ``baseline`` is (source, (select, expand)) of another
    tree's K3 and K4 (build_step_baseline): checked against these on the
    same tables and timed in turns with them; ``floor`` the empty-kernel
    launch floor, printed beside the kernels; ``phases`` the C entry of
    K3's measurement build (load_k3_phases), which splits K3's time into
    its read pass and its last block's finish."""
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
        for n, blocks in ((1, 0), (1, 1), (1, 132), (32, 0)):
            ktab = clone_table(tab0)
            kctr = S.run_chunk_sig_cuda(st, ktab, ctr0, n, ub, fill, blocks=blocks)
            ptab = clone_table(tab0)
            pctr = E._run_chunk_plain(st, ptab, ctr0, n, ub, fill, "sig", plain_select=True)
            torch.cuda.synchronize()
            err = same(f"kinase {triples} {n} step(s), K5 blocks {blocks}", ktab, kctr,
                       ptab, pctr, C)
            row["checks"].append(dict(steps=n, k5_blocks=blocks, max_abs_err=err,
                                      counters=kctr.tolist()))
            del ktab, ptab
        print(f"step kernels kinase --triples {triples} (sig, B={st.B}, from step "
              f"{int(ctr0[2])}): t_sig, t_best, t_closed and the 14 counters identical "
              f"to the plain step after 1 step (K5 grid auto, 1 and 132 blocks) and "
              f"after 32 steps")

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

        k5 = _kernels.bind(*S._probe_args(st, work, bufs, ctr, fill, 0, stream))
        k5_ms = time_restored(k5, restore4, 20)
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
            row["k3_phases"] = k3_phases(phases, S._select_args(
                st, work.t_best, work.t_closed, goal, thr, bufs.run, bufs, stream)[1:],
                bufs.partial, restore_tab)
        k3_dev = device_ms(k3, 20, restore_tab)
        k4_dev = device_ms(k4, 20, restore3)
        k5_dev = device_ms(k5, 20, restore4)
        step_dev = device_ms(lambda: (k3(), k4(), k5()), 20, restore_tab)
        if baseline is not None:
            row["baseline"] = step_baseline_turns(*baseline, st, ub, work, ctr, bufs,
                                                  restore_tab, restore3, k3, k4)

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
            k5=dict(ms=k5_ms, device_ms=k5_dev, plain_ms=k5_plain_ms, bound_ms=ms(bytes5),
                    bytes=bytes5),
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
              f"{k5_dev:.4f} ms (plain _insert_sig {k5_plain_ms:.4f}, bound "
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
        out[triples] = row
        del tab0, work, snap, eng

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
    return out


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
              triples: str, want_layout: str = "sig") -> dict:
    """One run of the CLI entry; ``triples`` "auto" runs it with its
    defaults (no --triples), "off" pins the pairwise heuristic."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch import cli

    argv = [path, "--device", "cuda"]
    if triples != "auto":
        argv += ["--triples", triples]
    args = cli.make_parser().parse_args(argv)
    if args.triples != triples:
        fail(f"{name}: the CLI default is --triples {args.triples}, not {triples}")
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    with contextlib.redirect_stdout(out):
        rep = cli.execute(args)
    counts = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated()
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
    # the kernels of this path: K1 always, K2 whenever cubes were built, the
    # step kernels K3-K5 on the sig layout and K3 on the packed one
    path_kernels = (["pair_wavefront"] + (["triple_wavefront"] if cubes else [])
                    + {"sig": STEP_KERNELS, "packed": ["select_best"]}.get(eng.layout, []))
    for k in path_kernels:
        if counts[k] <= 0:
            fail(f"{name}: kernel {k} was not launched on the main path")
    info = dict(triples=triples, layout=eng.layout, cubes=cubes, g=res.g,
                path_nodes=len(res.closed), pairs=eng.st.P, key_words=eng.st.KW,
                identical=identical, expanded=res.nodes_expanded,
                reopened=res.nodes_reopened, steps=res.steps,
                capacity=eng.st.C, batch=eng.st.B, fill_target=eng.fill_target,
                regrown=eng.regrown,
                walls=rep.walls, nodes_per_s=res.nodes_expanded / rep.walls["phase2"],
                launches=counts, upper_bound_s=eng.ub_wall, cubes_s=eng.cubes_wall,
                engine_walls=eng.last_phase_walls, peak_device_bytes=peak,
                acct=eng.last_acct)
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
          f"launches {counts}")
    return info


def pinned_layout(name: str, path: str, gold: dict, layout: str,
                  want_identical: bool) -> dict:
    """One run of the engine entry (as --profile drives it) with the table
    layout pinned, under --triples auto, then build_alignment."""
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    p = problem_from_fasta(path)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = FrontierSearch(p, HPairHeuristic.build(p, "cuda"), device="cuda",
                         layout=layout)
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if eng.layout != layout:
        fail(f"{name}: pinned {layout}, ran {eng.layout}")
    if res.g != gold["optimal_g"]:
        fail(f"{name} layout {layout}: g={res.g}, want {gold['optimal_g']}")
    # attach_path_g(goal_g=g) in _finish: the path cost equals g
    identical = check_alignment(f"{name} layout {layout}",
                                build_alignment(p, res.closed), gold, want_identical)
    info = dict(layout=layout, g=res.g, identical=identical,
                expanded=res.nodes_expanded, reopened=res.nodes_reopened,
                steps=res.steps, capacity=eng.st.C, batch=eng.st.B,
                regrown=eng.regrown, wall_s=wall, upper_bound_s=eng.ub_wall,
                engine_walls=eng.last_phase_walls, peak_device_bytes=peak,
                acct=eng.last_acct)
    print(f"{name} layout {layout} (pinned, --triples auto): g={res.g} ok, path "
          f"cost == g, alignment byte-identical to golden: {identical}; wall "
          f"{wall:.3f} s (upper-bound beam {eng.ub_wall:.3f} s, walk "
          f"{eng.last_phase_walls['walk']:.3f} s); expanded {res.nodes_expanded}, "
          f"reopened {res.nodes_reopened}, steps {res.steps}, capacity {eng.st.C} "
          f"(regrown: {eng.regrown}), batch {eng.st.B}; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    return info


def degenerate_input() -> dict:
    """Non-positive Altschul weights: no finite upper bound, so the engine
    must warn, take the unpacked layout and complete."""
    from mpi_pastar_msa_tpu_torch.core.problem import Problem
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    p = Problem(("WYWY", "WYY", "YWW"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = FrontierSearch(p, HPairHeuristic.build(p, "cuda"), device="cuda",
                             batch=16, capacity=1 << 12)
        res = eng.run()
    if not any("optimality is undefined" in str(w.message) for w in caught):
        fail("degenerate input: no warning")
    if eng.layout != "unpacked" or not res.closed:
        fail(f"degenerate input: layout {eng.layout}, {len(res.closed)} path nodes")
    print(f"degenerate input (WYWY, WYY, YWW): warned, layout {eng.layout}, "
          f"completed with g={res.g} after {res.nodes_expanded} expansions")
    return dict(layout=eng.layout, g=res.g, expanded=res.nodes_expanded)


def off_path_bounds(report: dict, kinase_path: str) -> dict:
    """Bounds by bytes (each input read once, each output written once,
    over HBM_BYTES_PER_S) of the device work not yet ported, from this
    run's shapes and counts:
    - K7, the walk (``_walk`` / ``_lookup_sig``) of kinase --triples auto:
      per path node the 64 bucket rows of its probe walk, t_sig and t_best
      (8 ways x 4 B each);
    - the packed step at globin6, per step of its run: the select's two
      tables and its outputs (C x 8 B + B x 17 B), per selected row its
      key row, P T8 rows and T x 8 cube corners, per surviving lane its
      home key row and one t_best word;
    - K8, the Gotoh fill at kinase: for each pair, three (n+1)(m+1) int32
      matrices written (the sequences read are negligible)."""
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta

    ms = lambda b: b / HBM_BYTES_PER_S * 1e3
    k = report["kinase"]
    walk = k["path_nodes"] * 64 * 8 * (4 + 4)
    g6 = report["globin6_auto"]
    steps, P, T, KW = g6["steps"], g6["pairs"], g6["cubes"], g6["key_words"]
    lanes = int(g6["acct"]["lanes_true"])
    packed = (steps * (g6["capacity"] * 8 + g6["batch"] * 17)
              + g6["expanded"] * (KW * 4 + 32 * P + 32 * T) + lanes * (KW * 4 + 4)) / steps
    lens = [len(q) for q in problem_from_fasta(kinase_path).seqs]
    gotoh = sum(3 * 4 * (lens[x] + 1) * (lens[y] + 1)
                for x in range(len(lens)) for y in range(x + 1, len(lens)))
    out = dict(k7_walk=dict(path_nodes=k["path_nodes"], bytes=walk, bound_ms=ms(walk)),
               packed_step=dict(steps=steps, lanes=lanes, bytes_per_step=packed,
                                bound_ms=ms(packed)),
               k8_gotoh=dict(lengths=lens, bytes=gotoh, bound_ms=ms(gotoh)))
    print(f"bounds by bytes of the work not yet ported: K7 walk at kinase "
          f"{k['path_nodes']} path nodes, {walk / 1e6:.2f} MB, {ms(walk):.5f} ms; "
          f"packed step at globin6 {packed / 1e6:.2f} MB a step ({steps} steps, "
          f"{lanes} lanes), {ms(packed):.5f} ms; K8 Gotoh fill at kinase "
          f"{gotoh / 1e6:.2f} MB, {ms(gotoh):.5f} ms")
    return out


def profile_search(name: str, path: str, triples: str, warm_steps: int,
                   steps: int, plain: bool = False) -> dict:
    """Where a mid-search step spends its time under ``triples`` (in the
    layout ``auto`` picks): run the engine to ``warm_steps``, then trace
    ``steps`` more with torch.profiler, through the engine's own loop or,
    with ``plain``, through the plain step functions on the card tensors
    (_run_chunk_plain(plain_select=True): the step before its kernels).
    Prints the device time by kernel, the launches (kernels, memcpy and
    memset) and host reads (device-to-host copies) a step, and the
    device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search import engine as E

    p = problem_from_fasta(path)
    eng = E.FrontierSearch(p, HPairHeuristic.build(p, "cuda"), device="cuda",
                           triples=triples)
    tab = eng._init_table()
    ctr = torch.as_tensor(E.fresh_counters(), device="cuda")
    ctr = E._run_chunk(eng.st, tab, ctr, warm_steps, eng.ub, eng.fill_target,
                       eng.layout)

    def run(ctr):
        if plain:
            return E._run_chunk_plain(eng.st, tab, ctr, steps, eng.ub, eng.fill_target,
                                      eng.layout, plain_select=True)
        return E._run_chunk(eng.st, tab, ctr, steps, eng.ub, eng.fill_target, eng.layout)

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
    reads = sum(c for k, _, c in kern if k.startswith("Memcpy DtoH"))
    memsets = sum(c for k, _, c in kern if k.startswith("Memset"))
    selects = sum(c for k, _, c in kern if "select_kernel" in k)
    label = "plain step" if plain else "engine"
    print(f"profile {name} --triples {triples} (layout {eng.layout}, {label}): steps "
          f"{s0}..{before[2]} unprofiled {plain_wall_ms:.3f} "
          f"ms/step; steps {before[2]}..{after[2]} profiled: wall {wall * 1e3 / n:.3f} "
          f"ms/step, device busy {busy_ms / n:.3f} ms/step "
          f"({100 * busy_ms / (wall * 1e3):.1f}% of wall; idle "
          f"{100 - 100 * busy_ms / (wall * 1e3):.1f}%), "
          f"{sum(c for _, _, c in kern) / n:.1f} launches ({selects / n:.2f} K3 kernels, "
          f"{memsets / n:.2f} memsets) and {reads / n:.2f} host reads a step")
    for key, ms, cnt in kern[:12]:
        print(f"  {ms / n:8.4f} ms/step  {cnt / n:7.1f} launches/step  {key[:90]}")
    ops = sorted(((e.key, e.device_time_total / 1e3) for e in events
                  if e.key.startswith("aten::")), key=lambda r: -r[1])
    return dict(layout=eng.layout, plain=plain, steps=n,
                unprofiled_wall_ms_per_step=plain_wall_ms,
                wall_ms_per_step=wall * 1e3 / n,
                busy_ms_per_step=busy_ms / n,
                kernels=[dict(name=k, ms_per_step=ms / n, launches_per_step=c / n)
                         for k, ms, c in kern[:25]],
                aten_ops=[dict(name=k, ms_per_step=ms / n) for k, ms in ops[:25]],
                launches_per_step=sum(c for _, _, c in kern) / n,
                k3_kernels_per_step=selects / n, memsets_per_step=memsets / n,
                host_reads_per_step=reads / n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", metavar="PATH", default=None,
                    help="also write the full report (every phase's numbers) "
                         "as JSON to PATH")
    ap.add_argument("--k1-baseline", metavar="SRC", default=None,
                    help="also build the first version of "
                         "csrc/pair_wavefront.cu (its C entry without launch "
                         "shape or scratch) and time it in turns with this one")
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
    ap.add_argument("--step-only", action="store_true",
                    help="run the device, build and step-kernel phases only "
                         "(a quick check of K3-K5; prints no result line)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 32 mid-search kinase steps, under "
                         "--triples auto and off, each through the engine "
                         "and through the plain step, and 32 globin6 steps "
                         "(the packed layout) with torch.profiler (device "
                         "time by kernel, launches and host reads a step, "
                         "idle share)")
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

    # 2. build: the kernels and, beside them, K3's measurement build
    t0 = time.perf_counter()
    phases_tmp = tempfile.TemporaryDirectory()
    phases_job = start_k3_phases_build(phases_tmp.name)
    try:
        logs = _kernels.build_all()
    finally:
        phases = load_k3_phases(phases_job)
    print(f"build: {len(logs)} kernel source(s) and K3's K3_PHASES build in "
          f"{time.perf_counter() - t0:.1f} s")
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
        if args.step_only:
            report["step"] = step_kernels(paths, step_baseline, floor, phases)
            print(json.dumps({"step": report["step"]}, default=str))
            return 0  # a partial run: no kernels line and no result line
        report["k1"] = check_k1(paths, baseline)
        k2_baseline = None
        if args.k2_baseline:
            k2_baseline = (args.k2_baseline,
                           build_baseline_k2(os.path.abspath(args.k2_baseline), tmp))
        variants = []
        for tile, src in args.k2_variant:
            tile = tuple(int(v) for v in tile.split("x"))
            variants.append((tile, src, build_variant_k2(tile, os.path.abspath(src), tmp)))
        report["k2"] = check_k2(paths, k2_baseline, variants)
        report["step"] = step_kernels(paths, step_baseline, floor, phases)
        # 4. / 5. main path (CLI defaults: --triples auto), then pairwise
        report["kinase"] = main_path("kinase", paths["kinase.fasta"],
                                     gold["kinase.fasta"], False, "auto")
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
        # 6. layouts beyond sig
        for name, g in LAYOUT_INPUTS.items():
            report[f"{name}_auto"] = main_path(name, data_path(name), data_gold(name, g),
                                               False, "auto", want_layout="packed")
        for layout in ("packed", "unpacked"):
            report[f"kinase_{layout}"] = pinned_layout(
                "kinase", paths["kinase.fasta"], gold["kinase.fasta"], layout, False)
        for name in ("test.fasta", "test2.fasta", "PF08184.fasta"):
            for layout in ("packed", "unpacked"):
                report[f"{name}_{layout}"] = pinned_layout(
                    name, paths[name], gold[name], layout, True)
        report["degenerate"] = degenerate_input()
        report["off_path_bounds"] = off_path_bounds(report, paths["kinase.fasta"])
        if args.profile:
            # mid-search windows: auto takes about 300 steps, off about 970
            # and the plain step on the same windows, the step before K3-K5
            report["profile"] = profile_search("kinase", paths["kinase.fasta"],
                                               "auto", 150, 32)
            report["profile_plain"] = profile_search("kinase", paths["kinase.fasta"],
                                                     "auto", 150, 32, plain=True)
            report["profile_off"] = profile_search("kinase", paths["kinase.fasta"],
                                                   "off", 400, 32)
            report["profile_off_plain"] = profile_search(
                "kinase", paths["kinase.fasta"], "off", 400, 32, plain=True)
            # the packed layout: globin6 takes about 150 steps
            report["profile_globin6"] = profile_search(
                "globin6", data_path("globin6"), "auto", 60, 32)

    phases_tmp.cleanup()
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)

    k1, k2 = report["k1"]["kinase"], report["k2"]["kinase"]
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
    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
