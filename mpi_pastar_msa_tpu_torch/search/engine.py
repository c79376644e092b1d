"""Batched-frontier A* engine with the JAX engine's three table layouts,
pairwise heuristic plus the triple cubes.

Port of the JAX package's ``search/engine.py``.  With ``triples="auto"``
(the default) it builds the triangle suffix cubes of
``heuristic/triples.py`` whenever they apply and adds them to h.  Every
super-step

  1. selects a batch of lowest-f open states from a device-resident
     open/closed hash table (grouped argmin under an adaptive f threshold),
  2. expands all 2^N-1 successor move-masks of every selected state (edge
     costs and the HPair heuristic as int32 broadcasts and gathers summed
     over the pairs, plus one 8-corner gather per triangle cube, exact),
  3. inserts all successors into the table with decrease-key / reopen
     semantics.

The table has one of three layouts (``FrontierSearch(layout=...)``, the
JAX semantics; ``auto`` takes the first that is eligible):

  sig       C/8 buckets x 8 ways of one exact signature word per key, plus
            ``t_best``/``t_closed``; needs a finite upper bound whose f
            spread fits the packed word and sig_bits <= log2(C) + 22
            (``_Static.sig_ok``).  One scatter-min on the packed word
            ``((f - f0) << n) | parent_mask`` places a candidate.
  packed    key rows ``[W key words, h]`` (two 16-bit coordinates a word)
            probed triangularly from a hash, plus ``t_best``/``t_closed``
            as sig; needs the same upper bound.
  unpacked  key rows ``[W key words]`` plus g, (f, parent) and a state per
            slot: decrease-key on g, pathmax on f.  Always eligible; the
            only layout for an infinite upper bound (degenerate weights).

Optimality does not require strict best-first order: reopening (keep-min)
plus the termination bound ``min_f(open) >= g(goal)`` guarantee the returned
goal cost is optimal for an admissible heuristic (ref: pastar/PAStar.cpp:
494-519).  Edge-cost algebra (ref: pastar/Node.cpp:129-152): for mask m and
pair p = (x, y) with advance bits bx, by and parent-mask bit p_s,

  pairCost = GG + (E-GG)(bx+by) + (mm + GG - 2E) bx by
             + (O-E)(bx(1-by) p_y + (1-bx) by p_x)

so ``cost[b, m] = c0 + c1[m] + sum_p both[m, p] w_p (mm[b, p] + GG - 2E)
+ (O-E) sum_s cmat[m, s] pbit[b, s]``.

Hash, key and sig quantities are carried in int64 masked to 32 bits (torch
has thin uint32 support and ``>>`` on int32 is arithmetic).  The tables
store u32 words as int32 bit patterns with -1 (the bit pattern of the JAX
layouts' 0xFFFFFFFF) as the empty mark.  The table tensors carry a trailing
trash region of ``TRASH`` slots: masked-out lanes of a scatter are sent
there (spread by lane, so they do not all contend for one address) instead
of being dropped, which keeps every scatter free of host synchronisation;
nothing ever reads the trash.  The tables are updated in place (they are
the engine's largest tensors).
"""
from __future__ import annotations

import functools
import hashlib
import os
import time
import warnings
from dataclasses import dataclass, fields, replace
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.cost import COST_TABLE, GAP_EXTENSION, GAP_GAP, GAP_OPEN
from ..core.problem import Problem
from ..heuristic.hpair import HPairHeuristic
from ..heuristic.triples import HTriples
from ..utils.device import resolve_device
from .backtrace import attach_path_g
from .bounds import greedy_upper_bound

INF = 2**30
INFP = 0x7FFFFFFF  # empty/infinite packed (f, par) word
_EMPTY_WORD = -1   # empty way / key row: the int32 bit pattern of 0xFFFFFFFF
_M32 = 0xFFFFFFFF
_I64_MAX = 2**63 - 1
TRASH = 4096  # trash slots after each table tensor (see the module doc)
LAYOUTS = ("auto", "sig", "packed", "unpacked")

#: Counters vector (int64, one host read per chunk), slot for slot the JAX
#: engine's legend:
#: [0] goal_g  [1] fmin  [2] steps  [3] expanded  [4] reopened  [5] n_open
#: [6] overflow  [7] thr (selection threshold, carried across chunks)
#: [8] sel_proc  (sum of expand widths — processed SELECTED rows)
#: [9] lanes_true (sum of valid candidate lanes — the search's true work)
#: [10] lanes_r0  (sum of insert round-0 widths — processed candidate lanes)
#: [11] lanes_probe (sum of probe-loop lane-rounds after round 0)
#: [12] lanes_unmatched (candidates NOT settled by the round-0 row lookup)
#: [13] lanes_tail (still unsettled after the first two probe calls)
#: The port compacts each step to its active rows and valid candidates, so
#: [8] counts expanded rows and [10] equals [9].  On the packed and unpacked
#: layouts round 0 is the first claim round of ``_probe_claim``.
N_COUNTERS = 14


def fresh_counters() -> np.ndarray:
    c = np.zeros(N_COUNTERS, dtype=np.int64)
    c[0] = INF
    return c


def _next_pow2(x: int) -> int:
    return 1 << max(1, (x - 1).bit_length())


@dataclass
class FrontierResult:
    g: int
    h: int
    f: int
    closed: Dict[Tuple[int, ...], Tuple[int, int]]  # path-only closed dict
    nodes_expanded: int
    nodes_reopened: int
    open_size: int  # open slots of the table when the search ended
    steps: int
    shard_stats: List[Tuple[int, int, int, int]]


@dataclass
class SigTable:
    """The bucketed sig table; each tensor ends in TRASH trash slots.

    t_sig    (C + TRASH,) int32  sig word per way (-1 = empty), bucket-major
    t_best   (C + TRASH,) int32  min packed word ((f-f0) << n) | parent mask
    t_closed (C + TRASH,) int32  t_best as it was when the slot was selected;
                                a slot is open while t_best < t_closed
    """
    t_sig: torch.Tensor
    t_best: torch.Tensor
    t_closed: torch.Tensor


@dataclass
class PackedTable:
    """The packed table (JAX ``_init_table_packed``); TRASH trash rows.

    t_key    (C + TRASH, W+1) int32  [key words..., h] (-1 = empty), written
                                     once, by the probe round that claims it
    t_best, t_closed                 as in SigTable
    claim    (C + TRASH,) int32      claim tags of the probe rounds (see
                                     ``_probe_claim``)
    """
    t_key: torch.Tensor
    t_best: torch.Tensor
    t_closed: torch.Tensor
    claim: torch.Tensor


@dataclass
class UnpackedTable:
    """The unpacked table (JAX ``_init_table_unpacked``); TRASH trash rows.

    t_key    (C + TRASH, W) int32  key words (-1 = empty)
    t_g      (C + TRASH,) int32    best g (INF = none yet)
    t_fpar   (C + TRASH,) int64    f * 2^n + parent mask of the best-g
                                   writer (the JAX t_f and t_par in one word)
    t_state  (C + TRASH,) int32    0 empty, 1 open, 2 closed
    claim    (C + TRASH,) int32    claim tags of the probe rounds
    """
    t_key: torch.Tensor
    t_g: torch.Tensor
    t_fpar: torch.Tensor
    t_state: torch.Tensor
    claim: torch.Tensor


class _Static:
    """Per-problem constants, on the engine's device (the JAX ``_Static``)."""

    def __init__(self, problem: Problem, heuristic: HPairHeuristic,
                 batch: int, capacity: int, device, f0: Optional[int] = None):
        dev = torch.device(device)
        self.device = dev
        n = problem.n_seq
        self.n = n
        self.M = (1 << n) - 1
        self.W = (n + 1) // 2  # key words: two 16-bit coordinates a word
        self.KW = self.W + 1   # packed key row: the key words and h
        self.pairs = problem.pairs()
        P = len(self.pairs)
        self.P = P
        self.B = batch
        self.C = capacity
        self.lmax = problem.max_length
        self.S = self.lmax + 2  # table stride with +1 margin for cx+1 gathers

        w_int = heuristic.pair_weights_i().astype(np.int64)  # (P,)
        # row m-1 = the bits of move mask m
        bits = (np.arange(1, self.M + 1)[:, None] >> np.arange(n)) & 1
        xs =np.array([x for x, _ in self.pairs])
        ys = np.array([y for _, y in self.pairs])
        bx = bits[:, xs]  # (M, P)
        by = bits[:, ys]
        E, O, GG = GAP_EXTENSION, GAP_OPEN, GAP_GAP
        self.c0 = int((GG * w_int).sum())
        c1 = (E - GG) * (w_int[None, :] * (bx + by)).sum(axis=1)  # (M,)
        # parent-mask cross matrix: cmat[m, s] = sum_p w_p (bx !by [y_p==s]
        # + !bx by [x_p==s])
        cmat = np.zeros((self.M, n), dtype=np.int64)
        a_y, a_x = bx * (1 - by), (1 - bx) * by
        for p, (x, y) in enumerate(self.pairs):
            cmat[:, y] += w_int[p] * a_y[:, p]
            cmat[:, x] += w_int[p] * a_x[:, p]
        self.gap_oe = O - E  # 0 with reference defaults

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                                   device=dev)

        self.d_bits = t(bits)                # (M, N)
        self.d_both = t(bx & by)             # (M, P)
        self.d_cmat = t(cmat)                # (M, N)
        self.d_c1 = t(c1)                    # (M,)
        self.d_k = t(2 * bx + by)            # (M, P) T4 cell of each child
        self.d_w = t(w_int)                  # (P,)
        self.d_xs = t(xs)
        self.d_ys = t(ys)
        self.d_pbase = t(np.arange(P) * self.S * self.S)
        self.d_final = t(problem.final_coord)
        self.final_np = problem.final_coord.astype(np.int64)

        # T8 rows: the 4 heuristic cells (i,j),(i,j+1),(i+1,j),(i+1,j+1) plus
        # the PAM cost of the pair's residues at (i,j) as one 8-word row, so
        # each (node, pair) costs one row gather (ref: pastar/Node.cpp:221-231)
        enc = problem.encoded(self.lmax + 1).astype(np.int64)
        tabs = heuristic.stacked_tables()
        stacked = np.zeros((P, self.S, self.S), dtype=np.int32)
        # zero padding: padded cells are only reachable from masked-out
        # successors
        stacked[:, : tabs.shape[1], : tabs.shape[2]] = np.where(
            tabs >= 2**29, 0, tabs)
        t8 = np.zeros((P, self.S, self.S, 8), dtype=np.int32)
        t8[:, :-1, :-1, 0] = stacked[:, :-1, :-1]
        t8[:, :-1, :-1, 1] = stacked[:, :-1, 1:]
        t8[:, :-1, :-1, 2] = stacked[:, 1:, :-1]
        t8[:, :-1, :-1, 3] = stacked[:, 1:, 1:]
        for p, (x, y) in enumerate(self.pairs):
            t8[p, : self.lmax + 1, : self.lmax + 1, 4] = COST_TABLE[
                np.ix_(enc[x], enc[y])]
        self.d_tables4 = torch.as_tensor(t8.reshape(-1, 8), device=dev)

        # triple heuristic (heuristic/triples.py): pairs covered by a
        # triangle leave the pairwise h (d_w_h zeroes them; edge costs keep
        # full weights) and are served jointly by the triangle's suffix cube:
        # the 8 cells H[cx+bx, cy+by, cz+bz] around a node, gathered straight
        # from a copy of the stack with INF3 zeroed (padded cells are only
        # reached through masked-out moves); corner c = 4 bx + 2 by + bz
        tri = getattr(heuristic, "triangles", None)
        self.T3 = len(tri) if tri else 0
        self.d_w_h = self.d_w
        if self.T3:
            S = self.S
            cubes = heuristic.tri_tabs
            if tuple(cubes.shape) != (self.T3, S, S, S):
                raise ValueError("triangle cube stride mismatch with engine")
            corner = np.zeros((self.T3, self.M), dtype=np.int64)
            for ti, (x, y, z) in enumerate(tri):
                corner[ti] = 4 * bits[:, x] + 2 * bits[:, y] + bits[:, z]
            self.tri_corner = corner
            self.d_tri_corner = t(corner)                 # (T, M)
            self.d_tri_t = t(np.arange(self.T3)[:, None])  # (T, 1)
            self.d_tri_xyz = t(np.array(tri))             # (T, 3)
            self.d_tri_off = t(np.arange(self.T3) * S * S * S)
            self.d_corner_off = t([bx * S * S + by * S + bz for bx in (0, 1)
                                   for by in (0, 1) for bz in (0, 1)])
            cubes = cubes.to(dev)
            self.d_cubes = torch.where(cubes >= 2**29, 0, cubes).reshape(-1)
            self.d_w_h = t(heuristic.pair_weights_h_i().astype(np.int64))

        self.root_parent_mask = problem.root_parent_mask
        self.max_probes = 128  # probe rounds (packed/unpacked) or calls (sig)
        # sig layout: the bucket index carries the low key bits and ONE word
        # (khi << 6 | bucket probe round) identifies the key exactly
        self.cbits = self.C.bit_length() - 1
        self.ways = 8
        self.nbuck = self.C // self.ways
        self.bbits = self.cbits - 3
        self.max_bprobes = 64  # 6-bit r field -> 64 bucket probes
        # way spreading: a writer takes the (mix32(word) mod n_empty)-th
        # empty way of its bucket row; for an 8-bit empty mask e these
        # tables give popcount(e) and the position of its k-th set bit
        # (0 where there is none, as an argmax over no hits)
        kth = np.zeros((256, self.ways), dtype=np.int64)
        for e in range(256):
            for k, w in enumerate(w for w in range(self.ways) if e >> w & 1):
                kth[e, k] = w
        self.d_popcount8 = t([bin(e).count("1") for e in range(256)])
        self.d_kth_way = t(kth.reshape(-1))
        self.bitw = [max(1, int(v).bit_length()) for v in problem.final_coord]
        self.sig_bits = sum(self.bitw)
        # khi <= 25 bits keeps the stored word below 2^31
        self.sig_ok = (self.sig_bits <= self.bbits + 25
                       and self.bbits >= 1 and self.cbits <= 31)
        self.nb = n
        # f-rebase origin: tables store f - f0 (see _rebase_origin)
        self.f0 = int(f0) if f0 is not None else _rebase_origin(heuristic, n)


def _rebase_origin(heuristic, n: int) -> int:
    """f-rebase origin: the pairwise-only h at the root, a lower bound on
    every reachable node's f (h_pair(root) <= h(root) <= f along any path,
    by consistency), scaled by cost_scale so it stays a lower bound in the
    fractional cover's (n-2)-scaled cost units."""
    base = getattr(heuristic, "base", heuristic)
    scale = getattr(heuristic, "cost_scale", 1)
    return int(base.calculate_h(np.zeros(n, dtype=np.int32))) * scale


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding u32 -> the int32 bit patterns the tables store."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _pack_keys(coords: torch.Tensor, W: int) -> torch.Tensor:
    """(..., N) coords -> (..., W) int64 u32 key words, 2 coords a word."""
    n = coords.shape[-1]
    c = coords.long()
    if 2 * W > n:
        c = torch.cat([c, c.new_zeros(c.shape[:-1] + (2 * W - n,))], dim=-1)
    return (c[..., 0::2] | (c[..., 1::2] << 16)) & _M32


def _unpack_keys(st: "_Static", words: torch.Tensor) -> torch.Tensor:
    """Invert _pack_keys: (X, >= W) int32 key rows -> (X, N) int64 coords."""
    w = words.long() & _M32
    return torch.stack([(w[:, i // 2] >> (16 * (i % 2))) & 0xFFFF
                        for i in range(st.n)], dim=-1)


def _hash_keys(keys: torch.Tensor) -> torch.Tensor:
    """FNV-1a over the W words + murmur3 finalizer -> int64 u32 hash."""
    h = torch.full(keys.shape[:-1], 2166136261, dtype=torch.int64,
                   device=keys.device)
    for w in range(keys.shape[-1]):
        h = _mul32(h ^ keys[..., w], 16777619)
    return _mix32(h)


def _probe_slot(h0: torch.Tensor, r, Cmask: int) -> torch.Tensor:
    """Triangular probing: h0 + r(r+1)/2 visits every slot of a 2^k table."""
    return (h0 + ((r * (r + 1)) >> 1)) & Cmask


# invertible odd multiplier (golden ratio) + its inverse mod 2^32; masking to
# the bucket bits preserves the inverse property
_SIG_ODD = 0x9E3779B1
_SIG_ODD_INV = 0x0E8B2F51


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), exact: split c in 16-bit
    halves so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer (bijective on u32) on int64 lanes holding u32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _sig_encode(st: _Static, coords: torch.Tensor):
    """(X, N) coords -> (home bucket, sig base word), both int64 in u32 range.

    The coordinate packs into sig_bits <= bbits + 25 bits, split as klo (low
    bbits) | khi (the rest).  home = (klo * ODD) ^ (mix32(khi) & Bmask); the
    stored word is (khi << 6) | r for bucket probe round r.  Given (slot,
    word) the key is recovered exactly (see _sig_decode): no hash collisions.
    """
    Bmask = st.nbuck - 1
    coords = coords.long()
    X = coords.shape[0]
    lo = torch.zeros((X,), dtype=torch.int64, device=coords.device)
    hi = torch.zeros_like(lo)
    sh = 0
    for i in range(st.n):
        c = coords[:, i]
        if sh < 32:
            lo = lo | ((c << sh) & _M32)
            if sh + st.bitw[i] > 32:
                hi = hi | (c >> (32 - sh))
        else:
            hi = hi | ((c << (sh - 32)) & _M32)
        sh += st.bitw[i]
    klo = lo & Bmask
    khi = lo >> st.bbits
    if st.sig_bits > 32:
        khi = (khi | (hi << (32 - st.bbits))) & _M32
    home = ((klo * _SIG_ODD) & Bmask) ^ (_mix32(khi) & Bmask)
    return home, (khi << 6) & _M32


def _sig_decode(st: _Static, slots: torch.Tensor, sig: torch.Tensor):
    """Invert _sig_encode: (slot, stored sig word) -> (X, N) int64 coords."""
    Bmask = st.nbuck - 1
    sig = sig.long() & _M32
    r = sig & 63
    khi = sig >> 6
    bucket = slots.long() >> 3
    home = (bucket - r) & Bmask
    klo = ((home ^ (_mix32(khi) & Bmask)) * _SIG_ODD_INV) & Bmask
    lo = (klo | (khi << st.bbits)) & _M32
    hi = khi >> (32 - st.bbits) if st.sig_bits > 32 else torch.zeros_like(khi)
    out = []
    sh = 0
    for i in range(st.n):
        bw = st.bitw[i]
        m = (1 << bw) - 1
        if sh + bw <= 32:
            v = (lo >> sh) & m
        elif sh >= 32:
            v = (hi >> (sh - 32)) & m
        else:
            v = ((lo >> sh) | (hi << (32 - sh))) & m
        out.append(v)
        sh += bw
    return torch.stack(out, dim=-1)


def _select_best(st: _Static, t_best, t_closed, goal_g, thr):
    """Grouped-argmin selection over the packed words of the sig and packed
    layouts; closes the selected slots in place.  A CUDA table runs kernel
    K3 (``search/step.py::select_best_cuda``), a CPU table the plain
    version, ``_select_best_plain``."""
    if t_best.device.type == "cuda":
        from .step import select_best_cuda
        return select_best_cuda(st, t_best, t_closed, goal_g, thr)
    return _select_best_plain(st, t_best, t_closed, goal_g, thr)


def _select_best_plain(st: _Static, t_best, t_closed, goal_g, thr):
    """The plain version of ``_select_best`` (JAX ``_select_sig`` and
    ``_select_packed``'s argmin).

    The table is viewed as B groups of C/B slots; each group offers its
    argmin open packed word (first index on ties), the global f-min is the
    min of the group mins, and a group's pick is taken when its f is within
    ``fmin + thr``.  Returns (slots, vmin, active, fmin, n_open, n_selected,
    reopen_ct): a selected slot that was closed before is a reopen."""
    C, B, nb = st.C, st.B, st.nb
    G = C // B
    best, closed = t_best[:C], t_closed[:C]
    is_open = (best < closed) & ((best >> nb) < goal_g - st.f0)
    v_open = torch.where(is_open, best, INFP)
    n_open = is_open.sum()
    v = v_open.view(B, G)
    j = torch.argmin(v, dim=1)
    vmin = v.gather(1, j[:, None])[:, 0]
    fmin_r = vmin.min() >> nb
    cut = (torch.clamp(fmin_r.long() + thr + 1, max=INFP >> nb) << nb) - 1
    slots = torch.arange(B, device=st.device) * G + j
    active = vmin <= cut  # empty groups hold INFP > cut
    vmin = torch.where(active, vmin, INFP)
    n_selected = active.sum()
    fmin = fmin_r.long() + st.f0
    reopen_ct = (active & (closed[slots] < INFP)).sum()
    t_closed[torch.where(active, slots, C)] = vmin  # C: the first trash slot
    return slots, vmin.long(), active, fmin, n_open, n_selected, reopen_ct


def _select_sig(st: _Static, tab: SigTable, goal_g, thr, best=None):
    """Batch selection, sig layout: coordinates come from inverting the sig
    encoding.  ``best`` is the grouped argmin (default ``_select_best``;
    ``_select_best_plain`` forces the plain one on the card).

    Returns (coords, f, par, f_par, active, fmin, n_open, n_selected,
    reopen_ct): f (not g) in the g position — the layout stores no h, so
    _expand recovers g as f - h(parent) (``g_is_f``); f_par is None (no
    pathmax)."""
    slots, vmin, active, fmin, n_open, n_sel, reopen_ct = (best or _select_best)(
        st, tab.t_best, tab.t_closed, goal_g, thr)
    coords = _sig_decode(st, slots, tab.t_sig[slots])
    f_sel = (vmin >> st.nb) + st.f0
    par = vmin & ((1 << st.nb) - 1)
    return coords, f_sel, par, None, active, fmin, n_open, n_sel, reopen_ct


def _select_packed(st: _Static, tab: PackedTable, goal_g, thr, best=None):
    """Batch selection, packed layout: coordinates from the key row, and
    g = f - h with h read from the key row's last column.  Returns the
    tuple of _select_sig with g in the g position."""
    slots, vmin, active, fmin, n_open, n_sel, reopen_ct = (best or _select_best)(
        st, tab.t_best, tab.t_closed, goal_g, thr)
    rows = tab.t_key[slots]
    coords = _unpack_keys(st, rows)
    g = (vmin >> st.nb) + st.f0 - rows[:, st.W].long()
    par = vmin & ((1 << st.nb) - 1)
    return coords, g, par, None, active, fmin, n_open, n_sel, reopen_ct


def _select_open(st: _Static, t_state, t_fpar, goal_g, thr):
    """Grouped-argmin selection over the open f values of the unpacked
    layout; closes the selected slots in place.  A CUDA table runs kernel
    K3's unpacked instantiation (``search/step.py::select_open_cuda``), a
    CPU table the plain version, ``_select_open_plain``."""
    if t_state.device.type == "cuda":
        from .step import select_open_cuda
        return select_open_cuda(st, t_state, t_fpar, goal_g, thr)
    return _select_open_plain(st, t_state, t_fpar, goal_g, thr)


def _select_open_plain(st: _Static, t_state, t_fpar, goal_g, thr):
    """The plain version of ``_select_open`` (JAX ``_select``'s argmin): a
    slot is open when its state is 1 and its f (t_fpar >> n) is below
    goal_g; each of the B groups offers its argmin f within ``f <= fmin +
    thr`` (first index on ties; index 0 of a group with none); selected
    slots get state 2.  Returns (slots, vmin, active, fmin, n_open,
    n_selected, reopen_ct) as ``_select_best_plain``, vmin the picked f
    (INF where inactive) and reopen_ct 0 (this layout counts reopens in the
    insert)."""
    C, B, nb = st.C, st.B, st.nb
    G = C // B
    t_f = t_fpar[:C] >> nb
    is_open = (t_state[:C] == 1) & (t_f < goal_g)
    f_open = torch.where(is_open, t_f, INF)
    fmin = f_open.min()
    n_open = is_open.sum()
    v = torch.where(f_open <= fmin + thr, f_open, INF).view(B, G)
    j = torch.argmin(v, dim=1)
    vmin = v.gather(1, j[:, None])[:, 0]
    slots = torch.arange(B, device=st.device) * G + j
    active = vmin < INF
    t_state[torch.where(active, slots, C)] = 2
    return slots, vmin, active, fmin, n_open, active.sum(), torch.zeros_like(n_open)


def _select(st: _Static, tab: UnpackedTable, goal_g, thr, best=None):
    """Batch selection, unpacked layout (JAX ``_select``): ``best`` is the
    grouped argmin (default ``_select_open``; ``_select_open_plain`` forces
    the plain one on the card).  Returns the tuple of _select_sig with g
    from t_g, the parent mask and f_par (the parent's f, for pathmax) from
    t_fpar, and a zero reopen count (this layout counts reopens in the
    insert)."""
    slots, _, active, fmin, n_open, n_sel, reopen_ct = (best or _select_open)(
        st, tab.t_state, tab.t_fpar, goal_g, thr)
    coords = _unpack_keys(st, tab.t_key[slots])
    g = tab.t_g[slots].long()
    fp = tab.t_fpar[slots]
    return (coords, g, fp & ((1 << st.nb) - 1), fp >> st.nb, active, fmin, n_open,
            n_sel, reopen_ct)


def _adapt_thr(thr, n_selected, B: int):
    """Selection threshold controller: widen when batches under-fill, shrink
    when full; clamped so repeated widening cannot overflow f + thr."""
    widen = n_selected < (B // 2)
    shrink = n_selected >= (B - B // 8)
    return torch.clamp(torch.where(widen, thr * 2 + 32,
                                   torch.where(shrink, thr // 2, thr)),
                       max=1 << 20)


def _expand(st: _Static, coords, g, parenti, active, f_parent=None,
            g_is_f=False, h3=None):
    """Expand a batch: (B, N) coords -> all-mask successor candidates.

    With ``g_is_f`` the g argument is the parents' f (the sig table stores
    no g): g = f - h(parent), where h(parent) is the k=0 cell of the T4
    heuristic gather plus each cube's own-coordinate corner.  With
    ``f_parent`` (the unpacked layout) each child's f is raised to at least
    its parent's (pathmax).  ``h3`` (B, M + 1), the sharded engine's cube
    h from every shard's cubes (parallel/sharded.py), stands in for the
    cube reads: column m - 1 is child m's, column M the row's own (JAX
    ``_expand(..., h3=h3)``).

    Returns flat (B*M,) int64 g, f, move mask, valid, is_goal and the
    (B*M, N) child coordinates; on valid lanes without pathmax, f - g is
    the child's h."""
    B, n = coords.shape
    M, S = st.M, st.S
    coords = coords.long()
    cx = coords[:, st.d_xs].clamp(0, S - 2)  # (B, P)
    cy = coords[:, st.d_ys].clamp(0, S - 2)
    t8 = st.d_tables4[st.d_pbase[None, :] + cx * S + cy].long()  # (B, P, 8)
    # d_w_h zeroes the triangle-covered pairs (their h comes from the cubes
    # below); edge costs keep the full weights d_w
    t4w = t8[:, :, :4] * st.d_w_h[None, :, None]  # (B, P, 4)
    mm = t8[:, :, 4]  # PAM cost of the pair's residues at (cx, cy)

    E, GG = GAP_EXTENSION, GAP_GAP
    wmm = st.d_w[None, :] * (mm + (GG - 2 * E))  # (B, P)
    cost = st.c0 + st.d_c1[None, :] + (wmm[:, None, :] * st.d_both[None]).sum(-1)
    if st.gap_oe != 0:
        pbit = (parenti.long()[:, None] >> torch.arange(n, device=st.device)) & 1
        cost = cost + st.gap_oe * (pbit[:, None, :] * st.d_cmat[None]).sum(-1)

    child = coords[:, None, :] + st.d_bits[None]  # (B, M, N)
    valid = (child <= st.d_final).all(-1) & active[:, None]
    # h for every child: sum_p t4w[b, p, k(m, p)] with k = 2 bx + by
    pidx = torch.arange(st.P, device=st.device)[None, :]
    h = t4w[:, pidx, st.d_k].sum(-1)  # (B, M)
    h_par = t4w[:, :, 0].sum(1)
    if h3 is not None:
        h = h + h3[:, :M].long()
        h_par = h_par + h3[:, M].long()
    elif st.T3:
        # the 8 corners of every (node, cube); child m reads corner
        # tri_corner[t, m], the parent corner 0
        c3 = coords[:, st.d_tri_xyz].clamp(0, S - 2)  # (B, T, 3)
        at = st.d_tri_off + (c3[..., 0] * S + c3[..., 1]) * S + c3[..., 2]
        rows3 = st.d_cubes[at[:, :, None] + st.d_corner_off].long()  # (B, T, 8)
        h = h + rows3[:, st.d_tri_t, st.d_tri_corner].sum(1)
        h_par = h_par + rows3[:, :, 0].sum(1)
    g = g.long()
    if g_is_f:
        g = g - h_par
    g_child = g[:, None] + cost
    f_child = g_child + h
    if f_parent is not None:
        f_child = torch.maximum(f_child, f_parent.long()[:, None])
    mask_id = torch.arange(1, M + 1, device=st.device).expand(B, M)
    is_goal = (child == st.d_final).all(-1) & valid
    return (g_child.reshape(-1), f_child.reshape(-1), mask_id.reshape(-1),
            valid.reshape(-1), is_goal.reshape(-1), child.reshape(B * M, n))


def _candidates_sig(st: _Static, child, g, f, mask, tag=None):
    """Insert arguments of the sig layout: (home, sig base, packed word);
    the sig probe is claimless, so it takes no tag."""
    home, sigb = _sig_encode(st, child)
    return home, sigb, ((f - st.f0) << st.nb) | mask


def _candidates_packed(st: _Static, child, g, f, mask, tag=None):
    """Insert arguments of the packed layout: (key words, h, packed word,
    claim tag); h = f - g, as this layout runs no pathmax."""
    return (_pack_keys(child, st.W), f - g, ((f - st.f0) << st.nb) | mask, tag)


def _candidates_unpacked(st: _Static, child, g, f, mask, tag=None):
    """Insert arguments of the unpacked layout: (key words, g, f, mask,
    claim tag)."""
    return _pack_keys(child, st.W), g, f, mask, tag


def _insert_sig(st: _Static, tab: SigTable, home, sigb, packed):
    """Insert candidates (all valid) into the bucketed sig table, in place.

    Round 0 matches each candidate's word against its home bucket row.  The
    rest probe linearly over buckets, CLAIMLESS: a call reads the current
    bucket row, settles a match, or writes the word into the
    (mix32(word) mod n_empty)-th empty way and re-reads next call; it moves
    to the next bucket only when the row was seen full, for at most
    ``max_bprobes`` buckets.  Writers racing for one way: the smallest word
    wins (scatter amin), so the result is the same on every device.  Every
    settled candidate then scatter-mins its packed word into t_best.

    Returns (overflow, reopen_ct, acct) with reopen_ct 0 (the sig layout
    counts reopens at selection) and acct = [true lanes, round-0 width,
    probe lane-rounds, round-0 unmatched, unsettled after two calls]
    (counter slots 9-13; the first two are equal: only valid lanes
    arrive)."""
    dev = st.device
    C, NB, ways = st.C, st.nbuck, st.ways
    Bmask = NB - 1
    L = home.shape[0]
    t_sig = tab.t_sig
    wrange = torch.arange(ways, device=dev)
    trash = C + torch.arange(L, device=dev) % TRASH

    row = t_sig[(home * ways)[:, None] + wrange]  # (L, 8) home bucket rows
    match_w = row == sigb[:, None]  # the r=0 word IS the sig base
    done = match_w.any(1)
    slot = home * ways + torch.argmax(match_w.to(torch.uint8), dim=1)
    un_ct = (~done).sum()
    cur = home.clone()  # an unsettled lane's current bucket
    calls = 0
    tail_ct = torch.zeros((), dtype=torch.int64, device=dev)
    while calls < st.max_probes and not bool(done.all()):
        r = (cur - home) & Bmask
        word = sigb | torch.clamp(r, max=st.max_bprobes - 1)
        live = ~done & (r < st.max_bprobes)
        row = t_sig[(cur * ways)[:, None] + wrange]
        match_w = (row == word[:, None]) & live[:, None]
        is_match = match_w.any(1)
        mway = torch.argmax(match_w.to(torch.uint8), dim=1)
        # 8-bit mask of the empty ways -> their count and the rank-th one
        emask = ((row == _EMPTY_WORD).long() << wrange).sum(1)
        n_empty = st.d_popcount8[emask]
        rank = _mix32(word) % torch.clamp(n_empty, min=1)
        fway = st.d_kth_way[emask * ways + rank]
        has_empty = n_empty > 0
        try_write = live & ~is_match & has_empty
        dest = torch.where(try_write, cur * ways + fway, trash)
        t_sig.scatter_reduce_(0, dest, word.to(torch.int32), "amin",
                              include_self=False)
        slot = torch.where(~done & is_match, cur * ways + mway, slot)
        cur = torch.where(live & ~has_empty, (cur + 1) & Bmask, cur)
        done = done | is_match
        calls += 1
        if calls == 2:
            tail_ct = (~done).sum()

    overflow = (~done).sum()
    tab.t_best.scatter_reduce_(0, torch.where(done, slot, trash),
                               packed.to(torch.int32), "amin")
    acct = torch.stack([torch.tensor(L, device=dev), torch.tensor(L, device=dev),
                        torch.tensor(calls * L, device=dev), un_ct, tail_ct])
    return overflow, torch.zeros_like(overflow), acct


def _probe_claim(st: _Static, t_key, claim, keys, krow, tag=None):
    """Settle each candidate key at a slot of a key-row table, in place
    (JAX ``_probe_body_factory`` / ``_probe_body_packed_factory``, run to
    completion).

    Round r probes slot ``_probe_slot(hash, r)`` of every unsettled lane:
    a row holding the key settles it (match); at an empty row the lane
    claims the slot (scatter-min of its tag) and the smallest tag wins and
    writes ``krow`` there; a loser re-reads the row and settles if the
    winner wrote the same key (match2); the rest go on to round r + 1, for
    at most ``max_probes`` rounds.  Lanes of one key follow one probe
    sequence in lock step, so a key is stored once.  ``tag`` is each lane's
    claim tag (default: its index); the step passes the content tag
    ``row_rank * M + mask - 1`` (``_expand_insert``), which orders the
    lanes as their indices do and which a kernel computes whatever order
    its lanes arrive in.  Tags need only be unique within a round, because
    a claimed slot is written in the same round and never claimed again —
    a claim word is read only at a slot claimed this round, so no old tag
    can win (which is why the JAX step_tag arithmetic and per-chunk claim
    reset are not needed, and why a kernel's atomicMin over the old word
    gives the same word).  The smallest tag winning makes the layout of
    the table, and so a run, the same on every device.

    Returns (slot, done, acct): a settled lane's slot, an unsettled lane's
    trash slot, and the counter slots 9-13 (see N_COUNTERS)."""
    dev = st.device
    C, W = st.C, st.W
    L = keys.shape[0]
    trash = C + torch.arange(L, device=dev) % TRASH
    kw = _as_i32(keys)
    h0 = _hash_keys(keys)
    tag = (torch.arange(L, dtype=torch.int32, device=dev) if tag is None
           else tag.to(torch.int32))
    slot_out = trash.clone()
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    un_ct = tail_ct = zero
    r = 0
    while r < st.max_probes and not bool(done.all()):
        slot = _probe_slot(h0, r, C - 1)
        k_at = t_key[slot]
        occ = k_at[:, 0] != _EMPTY_WORD
        match = (k_at[:, :W] == kw).all(1) & occ & ~done
        empty = ~occ & ~done
        claim.scatter_reduce_(0, torch.where(empty, slot, trash), tag, "amin",
                              include_self=False)
        won = empty & (claim[slot] == tag)
        t_key[torch.where(won, slot, trash)] = krow
        match2 = (t_key[slot][:, :W] == kw).all(1) & ~done & ~won & ~match
        settled = match | won | match2
        slot_out = torch.where(settled, slot, slot_out)
        done = done | settled
        r += 1
        if r == 1:
            un_ct = (~done).sum()
        elif r == 2:
            tail_ct = (~done).sum()
    acct = torch.stack([torch.tensor(L, device=dev), torch.tensor(L, device=dev),
                        torch.tensor(max(r - 1, 0) * L, device=dev), un_ct,
                        tail_ct])
    return slot_out, done, acct


def _insert_core_packed(st: _Static, tab: PackedTable, keys, h, packed, tag=None):
    """Insert candidates (all valid) into the packed table, in place: probe
    (``_probe_claim``; a claim winner writes ``[key words, h]``), then one
    scatter-min of the packed word into t_best.  Returns (overflow,
    reopen_ct, acct) with reopen_ct 0 (this layout counts reopens at
    selection); ``tag`` as in ``_probe_claim``."""
    krow = torch.cat([_as_i32(keys), h.to(torch.int32)[:, None]], dim=1)
    slot, done, acct = _probe_claim(st, tab.t_key, tab.claim, keys, krow, tag)
    tab.t_best.scatter_reduce_(0, slot, packed.to(torch.int32), "amin")
    overflow = (~done).sum()
    return overflow, torch.zeros_like(overflow), acct


def _insert_core(st: _Static, tab: UnpackedTable, keys, g, f, mask, tag=None):
    """Insert candidates (all valid) into the unpacked table, in place, with
    decrease-key (JAX ``_insert_core``): probe (``_probe_claim``), then a
    lane improves its slot when its g is below the slot's g before this
    call (INF for a slot claimed now); g is scatter-min'd, and among the
    writers that brought the new minimum the smallest f * 2^n + mask sets
    (f, parent) (one int64 scatter-min; JAX keeps an unspecified one of
    them).  Improved slots become open; one that was closed is a reopen.
    ``tag`` as in ``_probe_claim``.

    Returns (overflow, reopen_ct, acct)."""
    slot, done, acct = _probe_claim(st, tab.t_key, tab.claim, keys,
                                    _as_i32(keys), tag)
    trash = st.C + torch.arange(slot.shape[0], device=st.device) % TRASH
    g = g.to(torch.int32)
    # a slot settled by a claim in this call holds g = INF and state 0, as
    # it has since the table was made (slots are never freed), so no lane
    # needs to know whether its own claim won
    g_before = tab.t_g[slot]
    state_before = tab.t_state[slot]
    improve = done & (g < g_before)
    si = torch.where(improve, slot, trash)
    tab.t_g.scatter_reduce_(0, si, g, "amin")
    win = improve & (g == tab.t_g[slot])
    tab.t_fpar[si] = _I64_MAX  # an improved slot drops its old (f, parent)
    tab.t_fpar.scatter_reduce_(0, torch.where(win, slot, trash),
                               f.long() * (1 << st.nb) + mask, "amin")
    tab.t_state[si] = 1
    reopen_ct = (improve & (state_before == 2)).sum()
    return (~done).sum(), reopen_ct, acct


class _LayoutFns(NamedTuple):
    """A layout's step functions (JAX ``_make_fns``): select (st, tab,
    goal_g, thr) -> (coords, g, par, f_par, active, fmin, n_open,
    n_selected, reopen_ct); candidates (st, child, g, f, mask, tag) -> the
    insert's arguments; insert (st, tab, *args) -> (overflow, reopen_ct,
    acct); lookup (st, tab, coord) -> parent mask or None, for the walk;
    g_is_f: select returns f in the g position."""
    select: Callable
    candidates: Callable
    insert: Callable
    lookup: Callable
    g_is_f: bool


def _expand_insert(st: _Static, fns: _LayoutFns, tab, coords, g, par, f_par,
                   active, goal_g, ub: int):
    """Expand a selected batch and insert all successors.  Returns
    (goal_g, overflow, reopen_ct, acct) with acct = counter slots 8-13 of
    this step.

    Only the active rows are expanded and only the valid candidates are
    inserted (one torch.nonzero each): the selection fills a fraction of
    the batch and the upper bound prunes many children.  Results do not
    depend on it: the insert treats its lanes as one unordered set, and a
    key-row insert's claim tag is the lane's content tag, its index
    ``row_rank * M + mask - 1`` in the (rows, masks) expansion (row_rank:
    its place among the active rows, in group order), whatever lanes the
    prune kept."""
    dev = st.device
    sel = torch.nonzero(active)[:, 0]
    if sel.numel() == 0:  # no open state: the stop test ends the search
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return goal_g, zero, zero, torch.zeros(6, dtype=torch.int64, device=dev)
    g_c, f_c, mask_c, valid, is_goal, child = _expand(
        st, coords[sel], g[sel], par[sel], torch.ones_like(sel, dtype=torch.bool),
        f_parent=None if f_par is None else f_par[sel], g_is_f=fns.g_is_f)
    valid = valid & (f_c <= ub)  # admissible UB pruning
    goal_g = torch.minimum(goal_g, torch.where(is_goal, g_c, INF).min())
    keep = torch.nonzero(valid)[:, 0]
    overflow, reopen_ct, iacct = fns.insert(st, tab, *fns.candidates(
        st, child[keep], g_c[keep], f_c[keep], mask_c[keep], keep))
    acct = torch.cat([torch.tensor([sel.numel()], device=dev), iacct])
    return goal_g, overflow, reopen_ct, acct


def _run_chunk(st: _Static, tab, counters: torch.Tensor, chunk_steps: int,
               ub: int, fill: int, layout: str, graph: bool = True) -> torch.Tensor:
    """Up to ``chunk_steps`` super-steps (select -> expand -> insert) of the
    table ``layout``, as the JAX chunked run loops (a while_loop): stop when
    fmin >= goal_g, after chunk_steps, or on overflow.  A CUDA table runs
    three kernels a step with the stop test on the device: K3 -> K4 -> K5
    on the sig layout (``search/step.py::run_chunk_sig_cuda``), K3 -> K9 ->
    K10 on the packed and unpacked ones (``run_chunk_keyrow_cuda``); a CPU
    table the plain loop, ``_run_chunk_plain``.  The caller reads the whole
    counters vector once per chunk; on a CUDA table a chunk is its set-up
    and ``chunk_steps`` replays of a CUDA graph of one step, captured at
    the first chunk of a table (so again after a regrow, whose new table
    and statics have new buffers, or a table loaded from a checkpoint);
    ``graph=False`` enqueues the chunk kernel by kernel instead."""
    if counters.device.type == "cuda":
        from .step import run_chunk_keyrow_cuda, run_chunk_sig_cuda
        run = run_chunk_sig_cuda if layout == "sig" else run_chunk_keyrow_cuda
        return run(st, tab, counters, chunk_steps, ub, fill, graph=graph)
    return _run_chunk_plain(st, tab, counters, chunk_steps, ub, fill, layout)


def _run_chunk_plain(st: _Static, tab, counters: torch.Tensor, chunk_steps: int,
                     ub: int, fill: int, layout: str,
                     plain_select: bool = False) -> torch.Tensor:
    """The plain step loop of ``_run_chunk``: the stop test reads three
    scalars per step (the insert's probe loop synchronises each round
    anyway).  On a CUDA table the selects still run K3 unless
    ``plain_select`` (then every step function is the plain one, the
    reference the kernels are held to on the card)."""
    fns = _LAYOUT_FNS[layout]
    select = fns.select
    if plain_select:
        select = functools.partial(select, best=_PLAIN_ARGMIN[layout])
    goal_g, steps, expanded, reopen, n_open, overflow, thr = (
        counters[0], counters[2], counters[3], counters[4], counters[5],
        counters[6], counters[7])
    acct = counters[8:14].clone()
    fmin = torch.zeros((), dtype=torch.int64, device=st.device)
    local = 0
    while local < chunk_steps:
        fm, gg, ov = torch.stack([fmin, goal_g, overflow]).tolist()
        if not (fm < gg and ov == 0):
            break
        (coords, g, par, f_par, active, fmin, n_open, n_sel,
         sel_reopen) = select(st, tab, goal_g, thr)
        goal_g, ovf, ins_reopen, sacct = _expand_insert(
            st, fns, tab, coords, g, par, f_par, active, goal_g, ub)
        thr = _adapt_thr(thr, n_sel, fill)
        steps = steps + 1
        expanded = expanded + active.sum()
        reopen = reopen + sel_reopen + ins_reopen
        overflow = overflow + ovf
        acct = acct + sacct
        local += 1
    return torch.cat([torch.stack([goal_g, fmin, steps, expanded, reopen,
                                   n_open, overflow, thr]), acct])


def _lookup_sig(st: _Static, tab: SigTable, coord):
    """Parent mask of a stored coordinate, or None (JAX
    ``_make_backtrace_sig``): the 64 bucket rows of its probe walk and
    their t_best words in one gather."""
    home, sigb = _sig_encode(st, coord[None, :])
    rs = torch.arange(st.max_bprobes)
    idx = ((((home[0] + rs) & (st.nbuck - 1)) * st.ways)[:, None]
           + torch.arange(st.ways)).reshape(-1).to(st.device)
    rows = torch.stack([tab.t_sig[idx], tab.t_best[idx]]).cpu()
    hits = rows[0] == (sigb[0] | rs).repeat_interleave(st.ways)
    return _parent_of(st, hits, rows[1])


def _lookup_keyrow(st: _Static, t_key, t_word, coord):
    """Parent mask of a stored coordinate in a key-row table, or None:
    the key rows at all max_probes probe positions and their t_word
    (t_best or t_fpar) in one gather."""
    key = _pack_keys(coord[None, :], st.W)
    idx = _probe_slot(_hash_keys(key)[0], torch.arange(st.max_probes),
                      st.C - 1).to(st.device)
    rows = torch.cat([t_key[idx, : st.W].long(), t_word[idx, None].long()],
                     dim=1).cpu()
    hits = ((rows[:, : st.W] == _as_i32(key).long()).all(1)
            & (rows[:, 0] != _EMPTY_WORD))
    return _parent_of(st, hits, rows[:, st.W])


def _parent_of(st: _Static, hits, words):
    """The parent mask in the word of the first hit, or None."""
    if not bool(hits.any()):
        return None
    return int(words[int(torch.argmax(hits.to(torch.uint8)))]) & ((1 << st.nb) - 1)


def _lookup_packed(st: _Static, tab: PackedTable, coord):
    """(JAX ``_make_backtrace_packed``): the parent mask from t_best."""
    return _lookup_keyrow(st, tab.t_key, tab.t_best, coord)


def _lookup_unpacked(st: _Static, tab: UnpackedTable, coord):
    """(JAX ``_make_backtrace``): the parent mask from t_fpar."""
    return _lookup_keyrow(st, tab.t_key, tab.t_fpar, coord)


# the table type of each layout
_TABLES = {"sig": SigTable, "packed": PackedTable, "unpacked": UnpackedTable}

# the plain grouped argmin of each layout's select (``plain_select``)
_PLAIN_ARGMIN = {"sig": _select_best_plain, "packed": _select_best_plain,
                 "unpacked": _select_open_plain}

_LAYOUT_FNS = {
    "sig": _LayoutFns(_select_sig, _candidates_sig, _insert_sig, _lookup_sig,
                      True),
    "packed": _LayoutFns(_select_packed, _candidates_packed,
                         _insert_core_packed, _lookup_packed, False),
    "unpacked": _LayoutFns(_select, _candidates_unpacked, _insert_core,
                           _lookup_unpacked, False),
}


def walk(st: _Static, tab, layout: str) -> Tuple[np.ndarray, np.ndarray]:
    """Path walk goal -> origin on a finished table (JAX
    ``_make_backtrace_sig``, ``_make_backtrace_packed``,
    ``_make_backtrace``).  A CUDA table runs kernel K7
    (``search/step.py::walk_cuda``: one launch, one host read), a CPU table
    the plain version, ``_walk``.  Returns (parent masks, last
    coordinate)."""
    dev = (tab.t_sig if isinstance(tab, SigTable) else tab.t_key).device
    if dev.type == "cuda":
        from .step import walk_cuda
        return walk_cuda(st, tab, layout)
    if dev.type != "cpu":
        raise ValueError(f"the walk runs on a CUDA or a CPU table, not on {dev}")
    return _walk(st, tab, layout)


def _walk(st: _Static, tab, layout: str) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of ``walk``: a node's parent mask moves it to its
    parent, until the origin or a node that is not stored.  The host
    computes each node's probe positions and reads back only the rows at
    them, gathered on the table's device (never the whole table).  Returns
    (parent masks, last coordinate)."""
    lookup = _LAYOUT_FNS[layout].lookup
    coord = torch.as_tensor(st.final_np)
    masks = []
    for _ in range(int(st.final_np.sum())):
        if not bool(coord.any()):
            break
        par = lookup(st, tab, coord)
        if par is None:
            break
        masks.append(par)
        coord = coord - torch.tensor([(par >> i) & 1 for i in range(st.n)])
    return np.array(masks, dtype=np.int64), coord.numpy()


class FrontierSearch:
    """Single-device frontier A* (JAX: ``TpuFrontierSearch``).

    ``layout``: "auto" takes sig where it is eligible (a finite upper bound
    whose f spread fits the packed word, and ``sig_ok``), else packed where
    the spread fits, else unpacked; "sig", "packed" and "unpacked" pin the
    layout and raise ValueError where it is not eligible.  A regrow of the
    table re-resolves "auto" (sig_ok depends on the capacity); a pinned
    layout stays pinned.

    ``triples``: "auto" adds the triangle suffix cubes to h whenever they
    apply (N >= 3, gap open == extension, positive pair weights, cubes in
    budget); "on" and "fractional" (the all-triples cover with (n-2)-scaled
    costs) raise ValueError when they do not; "off" keeps the pairwise h.

    ``max_steps``: a search still short of the goal after that many steps
    (counted at the end of a chunk) raises RuntimeError("max_steps
    exceeded"), as JAX's does.

    ``checkpoint_path``: the search state (the table's tensors and the
    counters) is saved there between chunks, every ``checkpoint_every``
    chunks, and once more when ``max_steps`` is exceeded; a run whose
    checkpoint matches its problem and configuration (``_ckpt_meta``)
    resumes from it.  The port's checkpoints are not the JAX engine's: each
    package ignores the other's file.

    ``driver``: "chunked" runs ``chunk_steps`` steps a dispatch (on the
    card a step graph replayed), "host" one step a dispatch through the
    same kernels, enqueued one by one, with one host read a step (JAX
    ``_run_host_driver``)."""

    def __init__(self, problem: Problem,
                 heuristic: Optional[HPairHeuristic] = None,
                 device="cuda", batch: Optional[int] = None,
                 capacity: Optional[int] = None,
                 chunk_steps: int = 64, triples: str = "auto",
                 fill_target: Optional[int] = None, layout: str = "auto",
                 max_steps: int = 1_000_000, checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 8, driver: str = "chunked"):
        if triples not in ("auto", "on", "off", "fractional"):
            raise ValueError(f"triples={triples!r}: choose auto, on, off or "
                             "fractional")
        if layout not in LAYOUTS:
            raise ValueError(f"layout={layout!r}: choose one of {LAYOUTS}")
        if driver not in ("chunked", "host"):
            raise ValueError(f"driver={driver!r}: choose chunked or host")
        self.layout_pref = layout
        self.driver = driver
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.device = resolve_device(device)
        self.problem = problem
        self.heuristic = (heuristic if heuristic is not None
                          else HPairHeuristic.build(problem, self.device))
        n = problem.n_seq
        M = (1 << n) - 1
        if capacity is None:
            lattice = 1
            for L in problem.final_coord:
                lattice *= int(L) + 1
                if lattice > (1 << 27):
                    break
            # 2^23 keeps the sig layout eligible at kinase-length keys;
            # searches whose key set outgrows it regrow (see run)
            capacity = min(1 << 23, max(1 << 16, _next_pow2(min(lattice * 2, 1 << 23))))
        self._batch_auto = batch is None
        if batch is None:
            cap_b = 16384 if capacity >= (1 << 22) else 8192
            batch = max(64, min(cap_b, (1 << 19) // M))
        batch = max(16, min(batch, capacity))
        batch = 1 << (batch.bit_length() - 1)  # grouped selection needs B | C
        self.max_steps = max_steps  # a search that needs more steps raises
        self.chunk_steps = chunk_steps

        wi = self.heuristic.weight_i
        self.degenerate = bool((wi[~np.eye(n, dtype=bool)] <= 0).any())
        # triple cubes (heuristic/triples.py), built in Phase 2 as in JAX;
        # the fractional cover needs C(n,3) cubes, hence its larger budget
        self.triples = triples
        self.cubes_wall = 0.0  # cube build (K2 fill + host copy), seconds
        if (triples != "off" and not self.degenerate
                and GAP_OPEN == GAP_EXTENSION
                and getattr(self.heuristic, "triangles", None) is None):
            t0 = time.perf_counter()
            ht = (HTriples.build(self.heuristic, fractional=True,
                                 budget_bytes=10 << 30, device=self.device)
                  if triples == "fractional"
                  else HTriples.build(self.heuristic, device=self.device))
            self.cubes_wall = time.perf_counter() - t0
            if ht is not None:
                self.heuristic = ht
            elif triples in ("on", "fractional"):
                raise ValueError(
                    f"triples='{triples}' but the triple heuristic is not "
                    "applicable (needs N >= 3, GapOpen == GapExtension, "
                    "positive pair weights, and an in-budget cube size)")
        # a tight cube bound keeps each f-band thin: cube-assisted searches
        # take at most 8192 rows and a B/2 fill target; pairwise-only
        # searches are plateau-heavy, and a B/16 target keeps their f-windows
        # shallow (the JAX engine's autos)
        has_cubes = getattr(self.heuristic, "triangles", None) is not None
        if self._batch_auto and has_cubes and batch > 8192:
            batch = 8192
        self.fill_target = (int(fill_target) if fill_target
                            else max(64, batch // (2 if has_cubes else 16)))
        t0 = time.perf_counter()
        if GAP_OPEN == GAP_EXTENSION and not self.degenerate:
            # wider beams tighten the bound on big searches
            beam = 1024 if capacity >= (1 << 22) else 32
            self.ub = greedy_upper_bound(problem, self.heuristic, beam=beam)
        else:
            self.ub = INF
        self.ub_wall = time.perf_counter() - t0  # host beam, seconds
        # the sig and packed tables store f - f0 above n parent-mask bits of
        # an int32, so the f spread ub - f0 must fit; when the pairwise f0
        # leaves too wide a spread, the cube h(root) is the tighter origin
        budget = 1 << (31 - n)
        f0 = _rebase_origin(self.heuristic, n)
        if self.ub < INF and not (self.ub - f0 + 64) < budget and has_cubes:
            f0 = int(self.heuristic.calculate_h(np.zeros(n, dtype=np.int32)))
        self.packed = self.ub < INF and (self.ub - f0 + 64) < budget
        t0 = time.perf_counter()
        self.st = _Static(problem, self.heuristic, batch, capacity,
                          self.device, f0=f0)
        self.statics_wall = time.perf_counter() - t0  # the statics' build, seconds
        self._check_layout()
        self.regrown = False
        self.graph_captures = 0  # chunk graphs the last run captured
        self.resumed_steps = None  # steps of the checkpoint the run resumed

    @property
    def layout(self) -> str:
        """Resolved table layout: 'sig' | 'packed' | 'unpacked'."""
        if self.layout_pref != "auto":
            return self.layout_pref
        if self.packed and self.st.sig_ok:
            return "sig"
        return "packed" if self.packed else "unpacked"

    def _check_layout(self) -> None:
        """Refuse a pinned layout this problem and capacity cannot take
        (the checks of JAX ``_make_fns``)."""
        if self.layout == "sig" and not (self.packed and self.st.sig_ok):
            raise ValueError("sig layout requires packed eligibility and "
                             "sig_bits <= log2(capacity) + 22")
        if self.layout == "packed" and not self.packed:
            raise ValueError("packed layout requires a finite upper bound "
                             "whose f spread ub - f0 + 64 fits 31 - N bits")

    def _init_table(self):
        return {"sig": self._init_table_sig, "packed": self._init_table_packed,
                "unpacked": self._init_table_unpacked}[self.layout]()

    def _root(self):
        """(root coordinate as a (1, N) tensor, h(root))."""
        st = self.st
        h_root = self.heuristic.calculate_h(np.zeros(st.n, dtype=np.int32))
        return torch.zeros((1, st.n), dtype=torch.int64), int(h_root)

    def _init_table_sig(self) -> SigTable:
        st = self.st
        root, h_root = self._root()
        home, sigb = _sig_encode(st, root)
        slot = int(home[0]) * st.ways  # way 0 of the home bucket
        size = (st.C + TRASH,)
        t_sig = torch.full(size, _EMPTY_WORD, dtype=torch.int32, device=st.device)
        t_best = torch.full(size, INFP, dtype=torch.int32, device=st.device)
        t_closed = torch.full(size, INFP, dtype=torch.int32, device=st.device)
        t_sig[slot] = int(sigb[0])
        t_best[slot] = ((h_root - st.f0) << st.nb) | st.root_parent_mask
        return SigTable(t_sig, t_best, t_closed)

    def _init_table_packed(self) -> PackedTable:
        st = self.st
        root, h_root = self._root()
        key = _pack_keys(root, st.W)
        slot = int(_probe_slot(_hash_keys(key), 0, st.C - 1)[0])
        size = (st.C + TRASH,)
        t_key = torch.full(size + (st.KW,), _EMPTY_WORD, dtype=torch.int32,
                           device=st.device)
        t_best = torch.full(size, INFP, dtype=torch.int32, device=st.device)
        t_closed = torch.full(size, INFP, dtype=torch.int32, device=st.device)
        claim = torch.full(size, INFP, dtype=torch.int32, device=st.device)
        t_key[slot, : st.W] = _as_i32(key[0]).to(st.device)
        t_key[slot, st.W] = h_root
        t_best[slot] = ((h_root - st.f0) << st.nb) | st.root_parent_mask
        return PackedTable(t_key, t_best, t_closed, claim)

    def _init_table_unpacked(self) -> UnpackedTable:
        st = self.st
        root, h_root = self._root()
        key = _pack_keys(root, st.W)
        slot = int(_probe_slot(_hash_keys(key), 0, st.C - 1)[0])
        size = (st.C + TRASH,)
        t_key = torch.full(size + (st.W,), _EMPTY_WORD, dtype=torch.int32,
                           device=st.device)
        t_g = torch.full(size, INF, dtype=torch.int32, device=st.device)
        t_fpar = torch.full(size, INF * (1 << st.nb), dtype=torch.int64,
                            device=st.device)
        t_state = torch.zeros(size, dtype=torch.int32, device=st.device)
        claim = torch.full(size, INFP, dtype=torch.int32, device=st.device)
        # place the root (ref: pastar/PAStar.cpp:147-155 enqueues node_zero)
        t_key[slot] = _as_i32(key[0]).to(st.device)
        t_g[slot] = 0
        t_fpar[slot] = h_root * (1 << st.nb) + st.root_parent_mask
        t_state[slot] = 1
        return UnpackedTable(t_key, t_g, t_fpar, t_state, claim)

    def run(self) -> FrontierResult:
        """Run to the provably optimal goal; on table overflow the capacity is
        doubled (up to 2^26) and the search restarts."""
        attempts = 0
        while True:
            try:
                res = self._run_once()
                scale = getattr(self.heuristic, "cost_scale", 1)
                if scale > 1:
                    # the fractional cover ran the search in (n-2)-scaled
                    # cost units; every path cost divides by the scale
                    res = replace(res, g=res.g // scale, h=res.h // scale,
                                  f=res.f // scale,
                                  closed={c: (g // scale, m)
                                          for c, (g, m) in res.closed.items()})
                return res
            except RuntimeError as e:
                if ("overflow" not in str(e) or attempts >= 2
                        or self.st.C >= (1 << 26)):
                    raise
                attempts += 1
                self.regrown = True
                t0 = time.perf_counter()
                self.st = _Static(self.problem, self.heuristic, self.st.B,
                                  self.st.C * 2, self.device, f0=self.st.f0)
                self.statics_wall += time.perf_counter() - t0
                self._check_layout()

    def _run_once(self) -> FrontierResult:
        st = self.st
        if self.degenerate:
            warnings.warn(
                "non-positive Altschul pair weights detected: edge costs "
                "can be negative, so A* optimality is undefined for this "
                "input (the reference has the same limitation)",
                RuntimeWarning, stacklevel=3)
        self.last_phase_walls = {"cubes": self.cubes_wall, "statics": self.statics_wall}
        layout = self.layout
        tab, counters = self._load_checkpoint()
        t0 = time.perf_counter()
        self.resumed_steps = None if tab is None else int(counters[2])
        if tab is None:
            tab = self._init_table()
            counters = torch.as_tensor(fresh_counters(), device=st.device)
        self.last_phase_walls["init_table"] = time.perf_counter() - t0
        from .step import capture_parts, capture_stats
        captures0, capture_s0 = capture_stats(st)
        parts0 = capture_parts(st)
        host = self.driver == "host"
        chunks = 0
        t_loop = time.perf_counter()
        while True:
            if (self.checkpoint_path and chunks
                    and chunks % self.checkpoint_every == 0):
                self._save_checkpoint(tab, counters)
            counters = _run_chunk(st, tab, counters,
                                  1 if host else self.chunk_steps, self.ub,
                                  self.fill_target, layout, graph=not host)
            chunks += 1
            c = counters.tolist()  # one host read per chunk (a step: host)
            goal_v, fmin_v, steps, total_expanded, total_reopen, _, overflow = c[:7]
            self.last_acct = dict(zip(
                ("sel_proc", "lanes_true", "lanes_r0", "lanes_probe",
                 "lanes_unmatched", "lanes_tail"), c[8:14]))
            if fmin_v >= goal_v or overflow > 0 or steps >= self.max_steps:
                break
        walls = self.last_phase_walls
        walls["chunk_loop"] = time.perf_counter() - t_loop  # captures included
        # the step graphs this run captured (on the card: one a table),
        # and their seconds by part
        captures, capture_s = capture_stats(st)
        self.graph_captures = captures - captures0
        walls["graph_capture"] = capture_s - capture_s0
        for k, v in capture_parts(st).items():
            walls[f"capture_{k}"] = v - parts0[k]
        if overflow > 0:
            raise RuntimeError(f"hash table overflow after {steps} steps "
                               f"(capacity {st.C}); increase capacity")
        if steps >= self.max_steps and fmin_v < goal_v:
            if self.checkpoint_path:
                self._save_checkpoint(tab, counters)
            raise RuntimeError("max_steps exceeded")
        if goal_v >= INF:
            raise RuntimeError("open set exhausted without reaching the goal")
        t0 = time.perf_counter()
        res = self._finish(tab, goal_v, steps, total_expanded, total_reopen)
        walls["finish"] = time.perf_counter() - t0  # the walk included
        return res

    def _ckpt_meta(self) -> str:
        """What a checkpoint must match to be resumed (JAX ``_ckpt_meta``):
        the problem, B, C, W and the layout, the cube set and the f-rebase
        origin (stored f values depend on both), the sig table's ways; and,
        beside JAX's fields, the port's format tag, the counters' slots and
        the table's tensor names, so that neither package reads the other's
        file."""
        st = self.st
        h = hashlib.sha256(b"mpi_pastar_msa_tpu_torch checkpoint v1")
        for s in self.problem.seqs:
            h.update(s.encode())
        h.update(f"{st.B}:{st.C}:{st.W}:{self.layout}".encode())
        h.update(f":tri{getattr(self.heuristic, 'triangles', None)}"
                 f":{getattr(self.heuristic, 'tri_weights', None)}"
                 f":f0{st.f0}".encode())
        if self.layout == "sig":
            h.update(f":w{st.ways}".encode())
        names = [f.name for f in fields(_TABLES[self.layout])]
        h.update(f":ctr{N_COUNTERS}:{','.join(names)}".encode())
        return h.hexdigest()[:16]

    def _save_checkpoint(self, tab, counters: torch.Tensor) -> None:
        """Write the table's tensors and the counters to checkpoint_path,
        atomically (a rename); the seconds go to last_phase_walls."""
        t0 = time.perf_counter()
        tmp = self.checkpoint_path + ".tmp"
        arrays = {f"tab_{f.name}": getattr(tab, f.name).cpu().numpy()
                  for f in fields(tab)}
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f, meta=np.frombuffer(self._ckpt_meta().encode(), dtype=np.uint8),
                counters=counters.cpu().numpy(), **arrays)
        os.replace(tmp, self.checkpoint_path)
        walls = self.last_phase_walls
        walls["checkpoint_save"] = walls.get("checkpoint_save", 0.0) + time.perf_counter() - t0

    def _load_checkpoint(self):
        """(table, counters) on the engine's device from checkpoint_path,
        or (None, None) when there is none or it was written for another
        problem, configuration or format (then the run starts afresh).  The
        tensors are new, so a step graph captured before is never
        replayed on them."""
        if not self.checkpoint_path or not os.path.exists(self.checkpoint_path):
            return None, None
        t0 = time.perf_counter()
        cls = _TABLES[self.layout]
        with np.load(self.checkpoint_path) as z:
            names = [f"tab_{f.name}" for f in fields(cls)]
            if ("meta" not in z.files or bytes(z["meta"]).decode() != self._ckpt_meta()
                    or any(k not in z.files for k in names + ["counters"])):
                return None, None
            dev = self.st.device
            tab = cls(*(torch.from_numpy(z[k]).to(dev) for k in names))
            counters = torch.from_numpy(z["counters"]).to(dev)
        self.last_phase_walls["checkpoint_load"] = time.perf_counter() - t0
        return tab, counters

    def _finish(self, tab, goal_v, steps, total_expanded,
                total_reopen) -> FrontierResult:
        st = self.st
        t0 = time.perf_counter()
        masks, coord_fin = walk(st, tab, self.layout)
        if np.any(coord_fin != 0):
            raise RuntimeError("backtrace did not reach the origin")
        self.last_phase_walls["walk"] = time.perf_counter() - t0

        closed: Dict[Tuple[int, ...], Tuple[int, int]] = {}
        coord = tuple(int(v) for v in st.final_np)
        origin = (0,) * st.n
        for mv in masks:
            if coord == origin:
                break
            mv = int(mv)
            if mv == 0:
                continue
            closed[coord] = (0, mv)
            coord = tuple(coord[i] - ((mv >> i) & 1) for i in range(st.n))
        # exact g per path node, asserted against the goal g (the tables
        # store (f << n) | parent, not g); skipped for degenerate weights
        closed = attach_path_g(self.problem, self.heuristic.weight_i, closed,
                               goal_g=None if self.degenerate else goal_v)

        h_goal = self.heuristic.calculate_h(st.final_np)
        # closed = selected and not since reopened, open = waiting to be
        # selected (ref: pastar/PAStar.cpp:591-619)
        if isinstance(tab, UnpackedTable):
            t_state = tab.t_state[: st.C]
            n_open = int((t_state == 1).sum())
            n_closed = int((t_state == 2).sum())
        else:
            t_best, t_closed = tab.t_best[: st.C], tab.t_closed[: st.C]
            n_open = int((t_best < t_closed).sum())
            n_closed = int(((t_closed < INFP) & (t_best >= t_closed)).sum())
        return FrontierResult(
            g=goal_v, h=h_goal, f=goal_v + h_goal, closed=closed,
            nodes_expanded=total_expanded, nodes_reopened=total_reopen,
            open_size=n_open, steps=steps,
            shard_stats=[(total_expanded, total_reopen, n_closed, n_open)])
