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
   bound times of K3, K4, K5 and the whole step, K3's library yardstick
   (``--step-only`` stops after this phase).
4. main path, kinase: the port's CLI entry with its defaults (--triples
   auto, --device cuda) must build 4 cubes and reach g = 421546 with a path
   whose recomputed cost equals g, degapped rows equal to the inputs, and
   K1, K2 and the step kernels K3-K5 launched; then the same with
   --triples off (K1 and K3-K5 launched).
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
                           ms=ms, plain_ms=plain_ms,
                           bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                           chain_floor_ms=chain_ms, diagonals=steps,
                           ns_per_diagonal=ms * 1e6 / steps,
                           floor_ns_per_diagonal=chain_ms * 1e6 / steps,
                           out_bytes=out_bytes, max_abs_err=err)
        per = lambda t: f"{t * 1e6 / steps:.1f} ns/diag"
        print(f"K1 {label}: P={P} Lmax={L1 - 1} threads={threads} rows/thread="
              f"{rows_per_thread} shared={shared} B exact; kernel {ms:.4f} ms "
              f"({per(ms)}), plain {plain_ms:.2f} ms ({per(plain_ms)}), bound "
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
        rows[label] = dict(T=T, S=S, lengths=lens.tolist(), ms=ms, plain_ms=plain_ms,
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
              f"({ms * 1e3 / shape.diagonals:.2f} us/tile diagonal), plain "
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


def step_kernels(paths) -> dict:
    """The step kernels K3 -> K4 -> K5 against the plain step on the card:
    kinase under --triples auto (from step 150) and off (from step 400),
    1 and 32 steps from one table, through run_chunk_sig_cuda and through
    _run_chunk_plain(plain_select=True); t_sig, t_best, t_closed (the first
    C slots) and the 14 counters must be identical.  The 1-step case also
    runs K5 on one block and on 132, which must not change anything.  Then
    K3 alone against _select_best_plain on globin6's packed table (step
    60).  Times at kinase: K3, K4, K5 and the whole step, kernel and plain,
    with their bounds by bytes, and K3's library yardstick."""
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

        k3 = lambda: S._launch_select(st, work.t_best, work.t_closed, goal, thr,
                                      bufs.run, bufs, stream)
        k3_ms = time_restored(k3, restore_tab, 20)
        best0, closed0 = snap.t_best[:C], snap.t_closed[:C]
        k3_plain_ms = time_restored(
            lambda: E._select_best_plain(st, work.t_best, work.t_closed, goal, thr),
            restore_tab, 5)
        is_open = (best0 < closed0) & ((best0 >> st.nb) < goal - st.f0)
        v_open = torch.where(is_open, best0, E.INFP).view(st.B, C // st.B)
        k3_lib_ms = time_ms(lambda: torch.min(v_open, dim=1), reps=20)
        # after K3: its state, then K4
        restore_tab()
        k3()
        after3 = bufs.state.clone()

        def restore3():
            restore_tab()
            bufs.state.copy_(after3)

        k4 = lambda: S._launch_expand(st, work, bufs, ctr, ub, stream)
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

        k5 = lambda: S._launch_probe(st, work, bufs, ctr, fill, 0, stream)
        k5_ms = time_restored(k5, restore4, 20)
        restore4()
        k5()
        torch.cuda.synchronize()
        s5 = bufs.state.tolist()
        n_sel, n_valid, n_pend, calls = (s5[S.STATE_NSEL], s5[S.STATE_NVALID],
                                         s5[S.STATE_NPEND], s5[S.STATE_CALLS])
        new_ways = int(((work.t_sig[:C] != -1).sum() - (snap.t_sig[:C] != -1).sum()))
        step_ms = time_restored(lambda: (k3(), k4(), k5()), restore_tab, 20)

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
        bytes3 = C * 8 + st.B * 17 + n_sel * 4
        bytes4 = (st.B + n_sel * (4 + 16 + 32 * P + 32 * T) + n_valid * 32
                  + (n_valid - n_pend) * 4 + n_pend * 12)
        # rows read: the lanes unsettled at the start of each call; writes:
        # one word a new key, one t_best word a lane settled by the probe
        live = n_pend + sum(s5[S.STATE_CNT + k] for k in range(max(calls - 1, 0)))
        settled = n_pend - (s5[S.STATE_CNT + calls - 1] if calls else 0)
        bytes5 = n_pend * 12 + live * 32 + new_ways * 4 + settled * 4
        ms = lambda b: b / HBM_BYTES_PER_S * 1e3
        row.update(
            selected=n_sel, lanes=n_valid, pending=n_pend, probe_calls=calls,
            new_ways=new_ways,
            k3=dict(ms=k3_ms, plain_ms=k3_plain_ms, library_ms=k3_lib_ms,
                    bound_ms=ms(bytes3), bytes=bytes3),
            k4=dict(ms=k4_ms, plain_ms=k4_plain_ms, bound_ms=ms(bytes4), bytes=bytes4),
            k5=dict(ms=k5_ms, plain_ms=k5_plain_ms, bound_ms=ms(bytes5), bytes=bytes5),
            step=dict(ms=step_ms, plain_ms=step_plain_ms,
                      bound_ms=ms(bytes3 + bytes4 + bytes5)))
        print(f"  step {int(ctr0[2])}: {n_sel} rows, {n_valid} lanes, {n_pend} pending, "
              f"{calls} probe calls, {new_ways} new keys; K3 {k3_ms:.4f} ms (plain "
              f"{k3_plain_ms:.4f}, torch.min over (B, G) alone {k3_lib_ms:.4f}, bound "
              f"{ms(bytes3):.5f}); K4 {k4_ms:.4f} ms (plain _expand -> prune -> "
              f"_candidates_sig {k4_plain_ms:.4f}, bound {ms(bytes4):.5f}); K5 "
              f"{k5_ms:.4f} ms (plain _insert_sig {k5_plain_ms:.4f}, bound "
              f"{ms(bytes5):.5f}); step {step_ms:.4f} ms (plain {step_plain_ms:.4f}, "
              f"bound {ms(bytes3 + bytes4 + bytes5):.5f}); all bounds by bytes")
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
                   if not e.key.startswith(("aten::", "cuda"))), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kern)
    reads = sum(c for k, _, c in kern if k.startswith("Memcpy DtoH"))
    label = "plain step" if plain else "engine"
    print(f"profile {name} --triples {triples} (layout {eng.layout}, {label}): steps "
          f"{s0}..{before[2]} unprofiled {plain_wall_ms:.3f} "
          f"ms/step; steps {before[2]}..{after[2]} profiled: wall {wall * 1e3 / n:.3f} "
          f"ms/step, device busy {busy_ms / n:.3f} ms/step "
          f"({100 * busy_ms / (wall * 1e3):.1f}% of wall; idle "
          f"{100 - 100 * busy_ms / (wall * 1e3):.1f}%), "
          f"{sum(c for _, _, c in kern) / n:.1f} launches and {reads / n:.2f} host "
          f"reads a step")
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

    # 2. build
    t0 = time.perf_counter()
    logs = _kernels.build_all()
    print(f"build: {len(logs)} kernel source(s) in {time.perf_counter() - t0:.1f} s")
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
        if args.step_only:
            report["step"] = step_kernels(paths)
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
        report["step"] = step_kernels(paths)
        # 4. / 5. main path (CLI defaults: --triples auto), then pairwise
        report["kinase"] = main_path("kinase", paths["kinase.fasta"],
                                     gold["kinase.fasta"], False, "auto")
        if report["kinase"]["cubes"] != 4:
            fail(f"kinase: {report['kinase']['cubes']} cubes, want 4")
        report["kinase_off"] = main_path("kinase", paths["kinase.fasta"],
                                         gold["kinase.fasta"], False, "off")
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

    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)

    k1, k2 = report["k1"]["kinase"], report["k2"]["kinase"]
    launches = report["kinase"]["launches"]  # the main path's run
    kernels = [{
        "name": "pair_wavefront", "route": "cuda",
        "source": "mpi_pastar_msa_tpu_torch/csrc/pair_wavefront.cu",
        "replaces": "mpi_pastar_msa_tpu/heuristic/wavefront_pallas.py:35",
        "launches": launches["pair_wavefront"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
    }, {
        "name": "triple_wavefront", "route": "cuda",
        "source": "mpi_pastar_msa_tpu_torch/csrc/triple_wavefront.cu",
        "replaces": "mpi_pastar_msa_tpu/heuristic/triples.py:194",
        "launches": launches["triple_wavefront"],
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
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
