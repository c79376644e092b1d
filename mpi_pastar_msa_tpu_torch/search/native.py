"""ctypes binding of the native C A* engines (JAX ``search/native.py``).

``native/fast_astar.c`` is the serial engine (the reference's serial driver,
pastar/AStar.cpp:53-104, at native speed) and ``native/fast_astar_mt.c`` the
shared-memory HDA* engine (per-thread open/closed shards and an owner hash,
ref: pastar/PAStar.cpp:91-101, 643-654).  Both are sources of the repository
beside the JAX package, read and never written: each is compiled with ``gcc``
at first use into ``_build/`` of this package, as ``_kernels.py`` builds the
CUDA kernels, named by a hash of the sources and the flags, so an edited
source is never served from a stale library.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from .. import _kernels
from ..core.cost import COST_TABLE, GAP_EXTENSION, GAP_GAP, GAP_OPEN
from ..core.problem import Problem
from ..heuristic.hpair import HPairHeuristic

NATIVE_DIR = os.path.join(os.path.dirname(_kernels._HERE), "native")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
# library -> (the source gcc compiles, the sources it includes, extra flags)
_LIBS = {
    "fastastar": ("fast_astar.c", ("fast_astar.c",), []),
    "fastastar_mt": ("fast_astar_mt.c", ("fast_astar.c", "fast_astar_mt.c"), ["-pthread"]),
}
_i32p = ctypes.POINTER(ctypes.c_int32)
# the arguments both entries share, before and after the MT entry's
# threads and hash shift
_HEAD = [ctypes.c_int, ctypes.c_int, ctypes.c_int,            # n, n_pairs, W
         ctypes.POINTER(ctypes.c_uint16),                     # final
         ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,        # seqs, stride
         _i32p,                                               # cost_table
         _i32p, _i32p, _i32p,                                 # pair x/y/w
         _i32p, ctypes.c_int,                                 # tables, S
         ctypes.c_int, ctypes.c_int, ctypes.c_int,            # gaps
         ctypes.c_int,                                        # root parenti
         ctypes.c_uint32]                                     # init_cap
_TAIL = [_i32p, _i32p,                                        # out g/h
         _i32p, _i32p,                                        # out masks/len
         ctypes.POINTER(ctypes.c_int64)]                      # out stats
_ARGTYPES = {"astar_search": _HEAD + _TAIL,
             "astar_search_mt": _HEAD + [ctypes.c_int, ctypes.c_int] + _TAIL
             + [ctypes.POINTER(ctypes.c_int64)]}              # per-thread stats
_handles: Dict[str, ctypes.CDLL] = {}


def lib_path(name: str, build_dir: str = _kernels.BUILD_DIR) -> str:
    """Where library ``name`` is built: named by the hash of its sources
    and flags."""
    src, deps, extra = _LIBS[name]
    h = hashlib.sha256(" ".join(_FLAGS + extra).encode())
    for fname in deps:
        with open(os.path.join(NATIVE_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"lib{name}_{h.hexdigest()[:12]}.so")


def build(name: str, build_dir: str = _kernels.BUILD_DIR) -> str:
    """Compile library ``name`` into ``build_dir`` unless it is there;
    returns its path.  Raises RuntimeError when gcc fails."""
    lib = lib_path(name, build_dir)
    if os.path.exists(lib):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    src, _, extra = _LIBS[name]
    tmp = f"{lib}.{os.getpid()}.tmp"
    out = subprocess.run(["gcc", *_FLAGS, *extra, os.path.join(NATIVE_DIR, src), "-o", tmp],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"gcc failed for native/{src}:\n{out.stderr}")
    os.replace(tmp, lib)
    return lib


def _entry(name: str, fn: str):
    lib = _handles.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = _ARGTYPES[fn]
        _handles[name] = lib
    return getattr(lib, fn)


@dataclass
class NativeResult:
    g: int
    h: int
    f: int
    closed: Dict[Tuple[int, ...], Tuple[int, int]]
    nodes_expanded: int
    nodes_reopened: int
    open_size: int
    closed_size: int
    # per-thread (expanded, reopened, closed, open) rows — the reference's
    # per-tid node table (ref: pastar/PAStar.cpp:591-619); one row when serial
    thread_stats: Optional[list] = None


class NativeAStar:
    """threads=1 → serial engine; threads>1 → shared-memory HDA* with
    per-worker open/closed shards and a sum-hash owner function, matching
    the reference's thread architecture (ref: pastar/PAStar.cpp:91-101,
    643-654; pastar/CoordHash.cpp:38-44).  ``heuristic`` defaults to
    ``HPairHeuristic.build(problem)``, on the card."""

    def __init__(self, problem: Problem, heuristic: Optional[HPairHeuristic] = None,
                 init_capacity: int = 1 << 16, threads: int = 1,
                 hash_shift: int = 0):
        self.problem = problem
        self.heuristic = heuristic if heuristic is not None else HPairHeuristic.build(problem)
        self.init_capacity = init_capacity
        self.threads = max(1, int(threads))
        self.hash_shift = hash_shift

    def run(self) -> NativeResult:
        p = self.problem
        h = self.heuristic
        n = p.n_seq
        W = (n + 1) // 2
        pairs = p.pairs()
        P = len(pairs)
        lmax = p.max_length
        S = lmax + 2

        final = p.final_coord.astype(np.uint16)
        enc = np.ascontiguousarray(p.encoded(lmax + 1))  # (N, Lmax+1) uint8
        cost_tab = np.ascontiguousarray(COST_TABLE, dtype=np.int32)
        px = np.array([x for x, _ in pairs], dtype=np.int32)
        py = np.array([y for _, y in pairs], dtype=np.int32)
        pw = h.pair_weights_i()
        stacked = np.zeros((P, S, S), dtype=np.int32)
        raw = h.stacked_tables()
        stacked[:, : raw.shape[1], : raw.shape[2]] = np.where(raw >= 2**29, 0, raw)

        out_g = np.zeros(1, dtype=np.int32)
        out_h = np.zeros(1, dtype=np.int32)
        out_masks = np.zeros(max(1, int(final.sum())), dtype=np.int32)
        out_len = np.zeros(1, dtype=np.int32)
        out_stats = np.zeros(4, dtype=np.int64)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        head = (n, P, W, ptr(final, ctypes.c_uint16), ptr(enc, ctypes.c_uint8), lmax + 1,
                ptr(cost_tab, ctypes.c_int32), ptr(px, ctypes.c_int32),
                ptr(py, ctypes.c_int32), ptr(pw, ctypes.c_int32),
                ptr(stacked, ctypes.c_int32), S, GAP_OPEN, GAP_EXTENSION, GAP_GAP,
                p.root_parent_mask, self.init_capacity)
        tail = (ptr(out_g, ctypes.c_int32), ptr(out_h, ctypes.c_int32),
                ptr(out_masks, ctypes.c_int32), ptr(out_len, ctypes.c_int32),
                ptr(out_stats, ctypes.c_int64))
        tstats = None
        if self.threads > 1:
            tstats = np.zeros(4 * self.threads, dtype=np.int64)
            rc = _entry("fastastar_mt", "astar_search_mt")(
                *head, self.threads, self.hash_shift, *tail, ptr(tstats, ctypes.c_int64))
        else:
            rc = _entry("fastastar", "astar_search")(*head, *tail)
        if rc == -2:
            raise RuntimeError("open list exhausted without reaching the goal")
        if rc != 0:
            raise RuntimeError(f"native astar failed (rc={rc})")

        # path-only closed dict for the backtrace renderer
        closed: Dict[Tuple[int, ...], Tuple[int, int]] = {}
        coord = tuple(int(v) for v in final)
        for mv in out_masks[: int(out_len[0])]:
            mv = int(mv)
            closed[coord] = (0, mv)
            coord = tuple(coord[i] - ((mv >> i) & 1) for i in range(n))

        if tstats is not None:
            # C rows are (expanded, reopened, open, closed); reorder to the
            # CLI's (expanded, reopened, closed, open) row convention
            rows = [(int(tstats[4 * t]), int(tstats[4 * t + 1]),
                     int(tstats[4 * t + 3]), int(tstats[4 * t + 2]))
                    for t in range(self.threads)]
        else:
            rows = [(int(out_stats[0]), int(out_stats[1]),
                     int(out_stats[3]), int(out_stats[2]))]
        return NativeResult(
            g=int(out_g[0]), h=int(out_h[0]), f=int(out_g[0]) + int(out_h[0]),
            closed=closed,
            nodes_expanded=int(out_stats[0]), nodes_reopened=int(out_stats[1]),
            open_size=int(out_stats[2]), closed_size=int(out_stats[3]),
            thread_stats=rows,
        )
