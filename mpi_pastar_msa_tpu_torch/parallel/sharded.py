"""Multi-device sharded frontier engine: HDA* over a mesh of shards.

Port of the JAX package's ``parallel/sharded.py`` on its three table
layouts, chosen as JAX chooses them (ref: pastar/PAStar.cpp,
pastar/pastar_functions/).  Every lattice state is owned by exactly one
shard through the owner hash (``partition.py``, ref:
pastar/CoordHash.cpp:191-245).  Each step, on every shard in turn and with
the mesh's collectives between (``mesh.py``):

  1. K3 selects the shard's lowest-f open batch (search/step.py; on the
     unpacked layout its unpacked instantiation);
  2. with sharded cubes (sig and packed), ``sig_coords`` or
     ``keyrow_coords`` decodes the batch, the mesh gathers every shard's,
     K12 (``csrc/tri_partial.cu``) adds this shard's cubes' corners for all
     of them, and a reduce-scatter hands each shard the cube h of its own
     rows (JAX ``_sharded_h3``); an unpacked shard reads the whole cube
     stack itself, as JAX's unpacked step does;
  3. the sharded expand, K4's sharded instantiation on sig rows, K9's on
     key rows (packed, unpacked): a self-owned child is matched in its
     home row (sig, packed) or goes to the pending list, every child
     owned elsewhere becomes a candidate row (dest, fsort, payload: on
     key rows the receiver's pending entry);
  4. K11 (``csrc/route_pack.cu``) routes the candidate rows and the carry
     ring of rows spilled before: per destination the best f ride the wire
     up to its allowance (dense: a fixed cap per destination; ragged: a
     receiver takes at most ndev cap rows, from the all-gathered send
     counts), the rest spill into the new ring, whose min f stays in the
     bound (JAX ``_route_cap``, ``_route_ragged``; ``carry_bound``: the
     min packed word's f on sig and packed rows, the min f itself on
     unpacked ones);
  5. the mesh gathers every shard's counts (JAX ``_consensus``: goal g,
     f-min with the ring's, rows selected, overflow) and the host reads
     them, once a step: that gives the exchange's sizes and the stop test;
  6. the mesh exchanges the wire rows (all-to-all, dense or ragged) into
     the front of each shard's pending list;
  7. the consensus (goal_g, f-min, the global rows selected) goes into
     every shard's step state, and the insert (K5 on sig, K10 on key
     rows) places the received rows and the self-owned pending lanes,
     then writes the counters and the threshold.  On key rows a received
     row claims a slot with its place in the received region, a
     self-owned lane with ndev x the exchange cap + its content tag, so no
     tag depends on the order in which lanes arrive.

A CPU shard runs the plain versions of every kernel
(``_select_best_plain``, ``_select_open_plain``, ``sig_coords_plain``,
``keyrow_coords_plain``, ``tri_partial_plain``, ``expand_sharded_plain``,
``expand_keyrow_sharded_plain``, ``route_plain``, ``_insert_sig``,
``insert_pending_plain``), a CUDA shard the kernels, and never the plain
versions.  After the search the walk runs in rounds (JAX
``_make_batched_walk``): every shard walks at most K = 8 hops from the
current coordinate on its own table (K7's hop-limited mode, any layout),
stopping where another shard owns the node; the mesh sums the runs (one
shard's is non-zero) and the coordinate moves on.

One shard with the dense exchange is the single-table search itself
(JAX's ndev == 1 fast path): the engine's chunk (``_run_chunk``: on a
card the chunk graph of the layout's three step kernels) and the
one-table walk.  A multi-process mesh refuses the unpacked layout when it
runs, as JAX's does.
"""
from __future__ import annotations

import functools
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from ..core.cost import GAP_EXTENSION, GAP_OPEN
from ..core.problem import Problem
from ..heuristic.hpair import HPairHeuristic
from ..heuristic.triples import HTriples
from ..search.backtrace import attach_path_g
from ..search.bounds import greedy_upper_bound
from ..search.engine import (_LAYOUT_FNS, INF, INFP, TRASH, _EMPTY_WORD, PackedTable, SigTable,
                             UnpackedTable, _Static, _adapt_thr, _as_i32, _expand, _hash_keys,
                             _insert_core, _insert_core_packed, _insert_sig, _pack_keys,
                             _probe_slot, _rebase_origin, _run_chunk, _select_best_plain,
                             _select_open_plain, _sig_decode, _sig_encode, _unpack_keys,
                             fresh_counters, walk)
from .mesh import LocalMesh, ProcessMesh
from .partition import owner_fn, owner_params

#: the walk's hops a round (JAX ``_make_batched_walk``'s K)
WALK_HOPS = 8
#: the empty candidate and ring row: (dest = ndev, INFP, home 0, sig -1)
_FILL_TAIL = (INFP, 0, -1)
#: report slots: goal g, overflow (counters 0, 6), then state slots 0-4
#: (K3's g max, open, selected, reopened, f-min), then the route's out
R_GOAL, R_OVF, R_NOPEN, R_NSEL, R_REOPEN, R_FMIN, R_ROUTE = 0, 1, 3, 4, 5, 6, 7


@dataclass
class ShardedSearchResult:
    g: int
    h: int
    f: int
    closed: Dict[Tuple[int, ...], Tuple[int, int]]
    nodes_expanded: int
    nodes_reopened: int
    open_size: int
    steps: int
    # per-shard (expanded, reopened, closed, open, migrated)
    shard_stats: List[Tuple[int, int, int, int, int]]
    # candidates routed to a shard other than the one that made them (the
    # reference's remote-send volume, ref: pastar/PAStar.cpp:387-393)
    nodes_migrated: int = 0


# --- K11, the route: plain versions and wrappers


def route_plain(cand: torch.Tensor, n_lanes: int, carry: torch.Tensor, ndev: int, me: int,
                cap: int, S: Optional[torch.Tensor] = None, fill: Optional[Sequence[int]] = None):
    """The plain version of K11 (csrc/route_pack.cu, both passes): rows
    [cand[:n_lanes]; carry] of (dest, fsort, payload...) int32, a row
    remote when dest < ndev.  Per destination d the remote rows in (fsort,
    position) order: the first allow[d] to wire rows base[d] + col (the
    receiver's pending row: on sig rows (dest, fsort, home, sig) the row
    (home, sig, fsort) of the sig insert, on key rows the payload, which
    is the pending entry of K10), the rest in (d, fsort, position) order
    to the new ring, the empty row ``fill`` after them (default the sig
    row's (ndev, INFP, 0, -1); key rows: ``keyrow_fill``).  allow and base:
    dense (S None) cap and d cap; ragged from the all-gathered counts S
    (ndev, ndev): allow[d] = clip(ndev cap - sum_{i<me} S[i][d], 0,
    S[me][d]), base the exclusive prefix of allow.  Returns (wire rows
    (rows, width - 2) int32, 0 where nothing was sent; new ring (Ccar,
    width) int32; out (ndev + 3,) int32: counts, migrants among the lanes,
    carry overflow, the ring's min fsort or fill[1] when it is empty)."""
    dev = cand.device
    width = cand.shape[1]
    fill = [ndev, *_FILL_TAIL] if fill is None else list(fill)
    rows = torch.cat([cand[:n_lanes], carry]).long()
    T, ccar = rows.shape[0], carry.shape[0]
    dest = rows[:, 0]
    remote = (dest >= 0) & (dest < ndev)
    counts = torch.bincount(dest[remote], minlength=ndev)[:ndev]
    migr = int(remote[:n_lanes].sum())
    if S is None:
        allow = torch.full((ndev,), cap, dtype=torch.int64, device=dev)
        base = torch.arange(ndev, device=dev) * cap
    else:
        before = S[:me].long().sum(0)
        allow = torch.minimum(torch.clamp(ndev * cap - before, min=0), counts)
        base = torch.cumsum(allow, 0) - allow
    idx = torch.nonzero(remote)[:, 0]
    key = (dest[idx] * 2**31 + rows[idx, 1]) * T + idx
    order = idx[torch.argsort(key)]
    d_s = dest[order]
    col = torch.arange(order.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[d_s]
    on_wire = col < allow[d_s]
    n_wire = max(ndev * cap, cand.shape[0] + ccar)
    cols = [2, 3, 1] if width == 4 else list(range(2, width))
    wire = torch.zeros((n_wire, len(cols)), dtype=torch.int32, device=dev)
    wire[(base[d_s] + col)[on_wire]] = rows[order[on_wire]][:, cols].to(torch.int32)
    spill = order[~on_wire]
    n_spill = spill.numel()
    ring = torch.tensor([fill], dtype=torch.int32, device=dev).repeat(ccar, 1)
    kept = spill[:ccar]
    ring[: kept.numel()] = rows[kept].to(torch.int32)
    ring_min = int(rows[kept, 1].min()) if kept.numel() else fill[1]
    out = torch.tensor(counts.tolist() + [migr, max(n_spill - ccar, 0), ring_min],
                       dtype=torch.int32, device=dev)
    return wire, ring, out


def route_sizes(S: np.ndarray, ndev: int, cap: int, ragged: bool) -> np.ndarray:
    """The rows shard i sends shard j, A[i][j], from the send counts S
    (host ints, as the kernel computes its allowance)."""
    S = np.asarray(S, dtype=np.int64)
    if not ragged:
        return np.minimum(S, cap)
    before = np.cumsum(S, axis=0) - S
    return np.clip(ndev * cap - before, 0, S)


# --- K12, the sharded cube h: plain versions


def sig_coords_plain(st: _Static, t_sig: torch.Tensor, sel: torch.Tensor, n_sel: int,
                     B: int) -> torch.Tensor:
    """The plain version of ``sig_coords`` (csrc/tri_partial.cu): the
    coordinates of the compact list's rows (slot, packed word), decoded
    from (slot, t_sig[slot]), rows n_sel .. B zero: (B, N) int32."""
    out = torch.zeros((B, st.n), dtype=torch.int32, device=t_sig.device)
    if n_sel:
        slots = sel[:n_sel, 0].long()
        out[:n_sel] = _sig_decode(st, slots, t_sig[slots]).to(torch.int32)
    return out


def keyrow_coords_plain(st: _Static, t_key: torch.Tensor, sel: torch.Tensor, n_sel: int,
                        B: int) -> torch.Tensor:
    """The plain version of ``keyrow_coords`` (csrc/tri_partial.cu): the
    coordinates of the compact list's rows, decoded from the W key words of
    t_key[slot] (``_unpack_keys``), rows n_sel .. B zero: (B, N) int32."""
    out = torch.zeros((B, st.n), dtype=torch.int32, device=t_key.device)
    if n_sel:
        out[:n_sel] = _unpack_keys(st, t_key[sel[:n_sel, 0].long()]).to(torch.int32)
    return out


def tri_partial_plain(coords: torch.Tensor, cubes: torch.Tensor, tri: torch.Tensor,
                      M: int, S: int) -> torch.Tensor:
    """The plain version of K12 (csrc/tri_partial.cu; JAX
    ``_make_tri_partial``): for every row and each local triangle (x, y,
    z), the 8 corners of the cube cell at clip(coords[x, y, z], 0, S - 2);
    column m - 1 sums corner 4 bx + 2 by + bz of mask m's bits, column M
    corner 0.  cubes (Tl, S, S, S) int32 (cells out of reach zeroed), tri
    (Tl, 3).  Returns (rows, M + 1) int32."""
    rows = coords.shape[0]
    out = torch.zeros((rows, M + 1), dtype=torch.int64, device=coords.device)
    c = coords.long()
    flat = cubes.reshape(cubes.shape[0], S ** 3)
    off = torch.tensor([bx * S * S + by * S + bz for bx in (0, 1) for by in (0, 1)
                        for bz in (0, 1)], device=coords.device)
    # column m - 1 is mask m, column M the row itself (mask 0)
    order = torch.tensor(list(range(1, M + 1)) + [0], device=coords.device)
    for t in range(tri.shape[0]):
        x, y, z = (int(v) for v in tri[t])
        c3 = c[:, [x, y, z]].clamp(0, S - 2)
        at = (c3[:, 0] * S + c3[:, 1]) * S + c3[:, 2]
        corners = flat[t][at[:, None] + off].long()  # (rows, 8)
        corner = 4 * ((order >> x) & 1) + 2 * ((order >> y) & 1) + ((order >> z) & 1)
        out += corners[:, corner]
    return out.to(torch.int32)


def _tri_partial_cuda(coords, cubes, tri, n: int, S: int) -> torch.Tensor:
    rows = coords.shape[0]
    out = torch.empty((rows, (1 << n) - 1 + 1), dtype=torch.int32, device=coords.device)
    Tl = 0 if tri is None else tri.shape[0]
    _kernels.launch("tri_partial", coords.data_ptr(), cubes.data_ptr() if Tl else None,
                    tri.data_ptr() if Tl else None, n, S, Tl, rows, out.data_ptr(),
                    torch.cuda.current_stream(coords.device).cuda_stream)
    return out


# --- K4's sharded instantiation: plain version


def expand_sharded_plain(st: _Static, tab: SigTable, sel: torch.Tensor, n_sel: int, ub: int,
                         h3: Optional[torch.Tensor], own, ndev: int, me: int):
    """The plain version of K4's sharded instantiation (csrc/sig_expand.cu,
    ``sig_expand_sharded``) over the compact list's first n_sel rows (slot,
    packed word): expand (h3 (B, M + 1), or None: the cubes of ``st``),
    prune at ``ub``, and for every lane i M + m - 1 its candidate row
    (owner, packed, home, sig) when another shard owns the child, else the
    empty row; a self-owned lane whose home bucket row holds its word
    settles there (a scatter-min of its packed word into t_best, in
    place), the others are returned pending, in lane order.  Returns
    (goal g or INF, cand (B M, 4) int32, pending (n, 3) int32 (home, sig,
    packed), surviving lanes)."""
    dev = tab.t_sig.device
    M, L = st.M, st.B * st.M
    cand = torch.tensor([[ndev, *_FILL_TAIL]], dtype=torch.int32, device=dev).repeat(L, 1)
    if n_sel == 0:
        return INF, cand, torch.zeros((0, 3), dtype=torch.int32, device=dev), 0
    slots = sel[:n_sel, 0].long()
    vmin = sel[:n_sel, 1].long()
    coords = _sig_decode(st, slots, tab.t_sig[slots])
    g_c, f_c, mask_c, valid, is_goal, child = _expand(
        st, coords, (vmin >> st.nb) + st.f0, vmin & ((1 << st.nb) - 1),
        torch.ones(n_sel, dtype=torch.bool, device=dev), g_is_f=True,
        h3=None if h3 is None else h3[:n_sel])
    goal = int(torch.where(is_goal, g_c, INF).min())
    valid = valid & (f_c <= ub)
    home, sigb = _sig_encode(st, child)
    packed = ((f_c - st.f0) << st.nb) | mask_c
    dst = own(child.to(torch.int32)).long()
    remote = valid & (dst != me)
    stay = valid & (dst == me)
    rows = torch.stack([dst, packed, home, sigb], dim=1)
    cand[: n_sel * M][remote] = rows[remote].to(torch.int32)
    # round 0 of the self-owned lanes: the first way of the home row that
    # holds the word
    wrange = torch.arange(st.ways, device=dev)
    row = tab.t_sig[(home * st.ways)[:, None] + wrange]
    match = (row == sigb[:, None]) & stay[:, None]
    hit = match.any(1)
    slot = home * st.ways + torch.argmax(match.to(torch.uint8), dim=1)
    trash = st.C + torch.arange(slot.numel(), device=dev) % TRASH
    tab.t_best.scatter_reduce_(0, torch.where(hit, slot, trash), packed.to(torch.int32), "amin")
    pend = stay & ~hit
    pending = torch.stack([home[pend], sigb[pend], packed[pend]], dim=1).to(torch.int32)
    return goal, cand, pending, int(valid.sum())


# --- K9's sharded instantiation and K10 on the received rows: plain versions


def pend_words(st: _Static, layout: str) -> int:
    """Words of a pending entry of K10 (search/step.py::StepBuffers.pend):
    packed (key words, hash, tag, h, packed word), unpacked (key words,
    hash, tag, g, f * 2^n + mask as two words)."""
    return st.W + (4 if layout == "packed" else 5)


def keyrow_fill(st: _Static, layout: str, ndev: int) -> List[int]:
    """The empty candidate and ring row of a key-row layout: (dest = ndev,
    the empty fsort: INFP packed, INF unpacked, key words -1, the rest
    0)."""
    empty = INFP if layout == "packed" else INF
    return [ndev, empty] + [-1] * st.W + [0] * (pend_words(st, layout) - st.W)


def carry_bound(layout: str, ring_min, nb: int, f0: int):
    """The f that the rows of a carry ring keep in the bound, from K11's
    ring min (JAX ``_consensus`` input): on sig and packed rows the min
    packed word, (word >> n) + f0, INF when the ring is empty (INFP); on
    unpacked rows the min f itself, INF when empty."""
    ring_min = np.asarray(ring_min, dtype=np.int64)
    if layout == "unpacked":
        return ring_min
    return np.where(ring_min < INFP, (ring_min >> nb) + f0, INF)


def expand_keyrow_sharded_plain(st: _Static, tab, layout: str, sel: torch.Tensor, n_sel: int,
                                ub: int, h3: Optional[torch.Tensor], own, ndev: int, me: int,
                                tag_base: int):
    """The plain version of K9's sharded instantiation
    (csrc/keyrow_expand.cu, ``keyrow_expand_sharded``) over the compact
    list's first n_sel rows (slot, packed word; unpacked: slot, f): the
    rows' key words, g (packed: f - h, h the key row's last column;
    unpacked: t_g) and parent mask, expand (h3 (B, M + 1) in place of the
    cube reads, or None: the cubes of ``st``; unpacked with pathmax from
    t_fpar), prune at ``ub``; every surviving lane i M + m - 1 gets its
    pending entry (``pend_words``) with the claim tag tag_base + i M + m -
    1, and its candidate row (owner, fsort, entry) when another shard owns
    the child (fsort: the packed word, unpacked f), else the empty row
    (``keyrow_fill``).  On the packed layout a self-owned lane whose home
    probe row holds its key settles there (a scatter-min of its packed
    word into t_best, in place); the other self-owned lanes are returned
    pending, in lane order.  Returns (goal g or INF, cand (B M, 2 + PW)
    int32, pending (n, PW) int32, surviving lanes)."""
    dev = tab.t_key.device
    M, L, W, nb = st.M, st.B * st.M, st.W, st.nb
    fill = keyrow_fill(st, layout, ndev)
    cand = torch.tensor([fill], dtype=torch.int32, device=dev).repeat(L, 1)
    if n_sel == 0:
        return INF, cand, torch.zeros((0, len(fill) - 2), dtype=torch.int32, device=dev), 0
    slots = sel[:n_sel, 0].long()
    word = sel[:n_sel, 1].long()
    rows = tab.t_key[slots]
    coords = _unpack_keys(st, rows)
    pm = (1 << nb) - 1
    if layout == "packed":
        g, par, f_par = (word >> nb) + st.f0 - rows[:, W].long(), word & pm, None
    else:
        fp = tab.t_fpar[slots]
        g, par, f_par = tab.t_g[slots].long(), fp & pm, fp >> nb
    g_c, f_c, mask_c, valid, is_goal, child = _expand(
        st, coords, g, par, torch.ones(n_sel, dtype=torch.bool, device=dev), f_parent=f_par,
        h3=None if h3 is None else h3[:n_sel])
    goal = int(torch.where(is_goal, g_c, INF).min())
    valid = valid & (f_c <= ub)
    keys = _pack_keys(child, W)
    h0 = _hash_keys(keys)
    tag = tag_base + torch.arange(n_sel * M, device=dev)
    if layout == "packed":
        fsort = ((f_c - st.f0) << nb) | mask_c
        tail = [f_c - g_c, fsort]
    else:
        fsort = f_c
        fpar = f_c * (1 << nb) + mask_c
        tail = [g_c, _as_i32(fpar & 0xFFFFFFFF).long(), fpar >> 32]
    entry = torch.cat([_as_i32(keys).long(), torch.stack([_as_i32(h0).long(), tag, *tail], 1)],
                      dim=1)
    dst = own(child.to(torch.int32)).long()
    remote = valid & (dst != me)
    stay = valid & (dst == me)
    crow = torch.cat([torch.stack([dst, fsort], 1), entry], dim=1)
    cand[: n_sel * M][remote] = crow[remote].to(torch.int32)
    pend = stay
    if layout == "packed":
        # round 0 of the self-owned lanes: the home probe row holds the key
        home = _probe_slot(h0, 0, st.C - 1)
        at = tab.t_key[home][:, :W]
        hit = stay & (at[:, 0] != _EMPTY_WORD) & (at == _as_i32(keys)).all(1)
        trash = st.C + torch.arange(home.numel(), device=dev) % TRASH
        tab.t_best.scatter_reduce_(0, torch.where(hit, home, trash), fsort.to(torch.int32),
                                   "amin")
        pend = stay & ~hit
    return goal, cand, entry[pend].to(torch.int32), int(valid.sum())


def insert_pending_plain(st: _Static, tab, layout: str, rows: torch.Tensor, n_front: int):
    """The plain version of K10 over a pending list whose first ``n_front``
    entries are rows received from other shards (``keyrow_insert_recv``):
    a received row's claim tag is its place i < n_front in the list, every
    other entry's the tag it carries (K9's); then the claim rounds of
    ``_probe_claim`` and the placement (packed: t_best; unpacked: the
    decrease-key of ``_insert_core``), in place.  Returns (overflow,
    reopen_ct, rounds, unsettled after round 0, after round 1)."""
    n = rows.shape[0]
    if n == 0:
        return 0, 0, 0, 0, 0
    W = st.W
    keys = rows[:, :W].long() & 0xFFFFFFFF
    tag = rows[:, W + 1].clone()
    tag[:n_front] = torch.arange(n_front, dtype=tag.dtype, device=tag.device)
    if layout == "packed":
        ovf, reopen, acct = _insert_core_packed(st, tab, keys, rows[:, W + 2], rows[:, W + 3],
                                                tag)
    else:
        fpar = (rows[:, W + 4].long() << 32) | (rows[:, W + 3].long() & 0xFFFFFFFF)
        ovf, reopen, acct = _insert_core(st, tab, keys, rows[:, W + 2], fpar >> st.nb,
                                         fpar & ((1 << st.nb) - 1), tag)
    acct = [int(v) for v in acct]
    return int(ovf), int(reopen), acct[2] // n + 1, acct[3], acct[4]


def finish_plain(c: torch.Tensor, state: Sequence[int], fill: int, lanes: int, undone: int,
                 rounds: int, unmatched: int, tail: int) -> None:
    """The step's 14 counters after the insert, in place (csrc/step_state.cuh
    finish_step, as K10 writes them): ``state`` the step's (g max, open,
    rows selected, reopened, f-min), lanes the shard's surviving lanes (K9),
    undone the lanes the insert left, rounds its claim rounds."""
    n_sel = int(state[2])
    c[1] = int(state[4])
    c[2] += 1
    c[3] += n_sel
    c[4] += int(state[3])
    c[5] = int(state[1])
    c[6] += undone
    c[7] = int(_adapt_thr(torch.tensor(int(c[7])), torch.tensor(n_sel), fill))
    c[8] += n_sel
    c[9] += lanes
    c[10] += lanes
    c[11] += max(rounds - 1, 0) * lanes
    c[12] += unmatched
    c[13] += tail


def walk_hops_plain(st: _Static, tab, coord, hops: int, layout: str = "sig") -> torch.Tensor:
    """The plain version of K7's hop-limited mode (``path_walk_hops``): the
    walk of ``engine._walk`` from ``coord`` on one shard's table of
    ``layout`` for at most ``hops`` steps.  Returns (hops + N + 1,) int32:
    the run of masks (0 past its end), the coordinate it stopped at, the
    run's length."""
    lookup = _LAYOUT_FNS[layout].lookup
    c = torch.as_tensor(np.asarray(coord, dtype=np.int64))
    masks = []
    while len(masks) < hops and bool(c.any()):
        par = lookup(st, tab, c)
        if par is None:
            break
        masks.append(par)
        c = c - torch.tensor([(par >> i) & 1 for i in range(st.n)])
    return torch.tensor(masks + [0] * (hops - len(masks)) + c.tolist() + [len(masks)],
                        dtype=torch.int32)


# --- one shard


def _sig_table(st: _Static, h_root: int, holds_root: bool) -> SigTable:
    """A shard's empty sig table, with the root in way 0 of its home
    bucket when this shard owns it (JAX :357-361)."""
    tab = SigTable(*(torch.full((st.C + TRASH,), v, dtype=torch.int32, device=st.device)
                     for v in (_EMPTY_WORD, INFP, INFP)))
    if holds_root:
        home, sigb = _sig_encode(st, torch.zeros((1, st.n), dtype=torch.int64))
        slot = int(home[0]) * st.ways
        tab.t_sig[slot] = int(sigb[0])
        tab.t_best[slot] = ((h_root - st.f0) << st.nb) | st.root_parent_mask
    return tab


def _keyrow_table(st: _Static, layout: str, h_root: int, holds_root: bool):
    """A shard's empty packed or unpacked table, with the root at its home
    probe slot when this shard owns it (JAX :602-619, :773-794; the
    engine's ``_init_table_packed`` and ``_init_table_unpacked``)."""
    size = (st.C + TRASH,)
    i32 = dict(dtype=torch.int32, device=st.device)
    cols = st.KW if layout == "packed" else st.W
    t_key = torch.full(size + (cols,), _EMPTY_WORD, **i32)
    claim = torch.full(size, INFP, **i32)
    if layout == "packed":
        tab = PackedTable(t_key, torch.full(size, INFP, **i32), torch.full(size, INFP, **i32),
                          claim)
    else:
        tab = UnpackedTable(t_key, torch.full(size, INF, **i32),
                            torch.full(size, INF * (1 << st.nb), dtype=torch.int64,
                                       device=st.device),
                            torch.zeros(size, **i32), claim)
    if holds_root:
        key = _pack_keys(torch.zeros((1, st.n), dtype=torch.int64), st.W)
        slot = int(_probe_slot(_hash_keys(key), 0, st.C - 1)[0])
        t_key[slot, : st.W] = _as_i32(key[0]).to(st.device)
        if layout == "packed":
            t_key[slot, st.W] = h_root
            tab.t_best[slot] = ((h_root - st.f0) << st.nb) | st.root_parent_mask
        else:
            tab.t_g[slot] = 0
            tab.t_fpar[slot] = h_root * (1 << st.nb) + st.root_parent_mask
            tab.t_state[slot] = 1
    return tab


def _shard_table(st: _Static, layout: str, h_root: int, holds_root: bool):
    if layout == "sig":
        return _sig_table(st, h_root, holds_root)
    return _keyrow_table(st, layout, h_root, holds_root)


def _open_closed(st: _Static, tab) -> Tuple[int, int]:
    """(open, closed) slots of a finished table: on sig and packed open
    while t_best < t_closed, closed when selected and not reopened since
    (JAX :710-711); on unpacked by t_state, 1 open and 2 closed (JAX
    :872)."""
    if isinstance(tab, UnpackedTable):
        state = tab.t_state[: st.C]
        return int((state == 1).sum()), int((state == 2).sum())
    best, closed = tab.t_best[: st.C], tab.t_closed[: st.C]
    return (int((best < closed).sum()), int(((closed < INFP) & (best >= closed)).sum()))


def _on_device(phase):
    """Run a shard's phase with the shard's card current: a kernel launches
    on the current device, and a mesh may hold shards on several cards."""
    @functools.wraps(phase)
    def run(self, *args, **kw):
        if not self.cuda:
            return phase(self, *args, **kw)
        with torch.cuda.device(self.dev):
            return phase(self, *args, **kw)
    return run


class _Shard:
    """One shard's table, counters, carry ring and step buffers, and its
    phases of the step: on a CUDA device the kernels, on the CPU their
    plain versions.  The table is the engine's layout: sig, packed or
    unpacked."""

    def __init__(self, eng: "ShardedFrontierSearch", me: int, device: torch.device,
                 st: _Static):
        self.me, self.dev, self.st = me, device, st
        self.layout = layout = eng.layout
        self.cuda = device.type == "cuda"
        ndev, B, M = eng.ndev, st.B, st.M
        L = B * M
        self.R = ndev * eng.exchange_cap  # received rows at most
        # a self-owned lane's claim tag starts above every received row's
        self.tag_base = self.R
        self.ccar = L
        i32 = dict(dtype=torch.int32, device=device)
        self.tab = _shard_table(st, layout, eng.h_root, eng.root_owner == me)
        self.ctr = torch.as_tensor(fresh_counters(), device=device)
        self.fill = [ndev, *_FILL_TAIL] if layout == "sig" else keyrow_fill(st, layout, ndev)
        self.pw = 3 if layout == "sig" else pend_words(st, layout)  # a wire row's words
        row = torch.tensor([self.fill], **i32)
        self.rings = [row.repeat(self.ccar, 1), row.repeat(self.ccar, 1)]
        self.cur = 0
        self.cubes = self.tri = None
        if eng.cubes_split:
            T_loc = -(-st.T3 // ndev)
            lo, hi = min(me * T_loc, st.T3), min((me + 1) * T_loc, st.T3)
            self.tri = st.d_tri_xyz[lo:hi].to(device, torch.int32).contiguous()
            self.cubes = eng.cube_stack[lo:hi].to(device, copy=True)
        if self.cuda:
            from ..search import step as S

            self.S = S
            self.cand = torch.empty((L, len(self.fill)), **i32)
            self.seg = 1 << max(1, (L + self.ccar - 1).bit_length())
            self.keys = torch.empty(2 * ndev * self.seg, dtype=torch.int64, device=device)
            self.route_out = torch.empty(ndev + 3, **i32)
            self.wire = torch.empty((max(self.R, L + self.ccar), self.pw), **i32)
            bufs = S.StepBuffers.select_only(st, device)
            # the select's scratch is the shard's own (select_only shares it
            # between the tables of one statics)
            bufs.sel = torch.empty((B, 2), **i32)
            bufs.partial = torch.empty((S.K3_MAX_BLOCKS, 2), dtype=torch.int64, device=device)
            bufs.ticket = torch.zeros(1, **i32)
            bufs.run = torch.ones(1, **i32)
            bufs.pend = torch.empty((self.R + L, self.pw), **i32)
            bufs.lane_cur, bufs.lane_dest = (torch.empty(self.R + L, **i32) for _ in range(2))
            if layout == "sig":
                bufs.lane_word = torch.empty(self.R + L, **i32)
            else:
                bufs.tail = torch.empty(S.K10_CAP, **i32)
            bufs.params = S._kernel_params(st, device)
            bufs.layout = layout
            self.bufs = bufs
            self.bitw = torch.tensor(st.bitw, **i32)

    @property
    def ring(self) -> torch.Tensor:
        return self.rings[self.cur]

    # 1. select
    @_on_device
    def select(self) -> None:
        st, tab = self.st, self.tab
        if self.cuda:
            if self.layout == "unpacked":
                self.S.select_open_cuda(st, tab.t_state, tab.t_fpar, self.ctr[0], self.ctr[7],
                                        run=self.bufs.run, bufs=self.bufs)
            else:
                self.S.select_best_cuda(st, tab.t_best, tab.t_closed, self.ctr[0], self.ctr[7],
                                        run=self.bufs.run, bufs=self.bufs)
            return
        if self.layout == "unpacked":
            out = _select_open_plain(st, tab.t_state, tab.t_fpar, self.ctr[0], self.ctr[7])
        else:
            out = _select_best_plain(st, tab.t_best, tab.t_closed, self.ctr[0], self.ctr[7])
        slots, vmin, active, fmin, n_open, n_sel, reopen = out
        self.sel = torch.stack([slots[active], vmin[active]], dim=1).to(torch.int32)
        self.n_sel = int(n_sel)
        self.state = [0, int(n_open), self.n_sel, int(reopen), int(fmin)]

    # 2. the coordinates K12 gathers (sig and packed), and K12
    @_on_device
    def coords(self) -> torch.Tensor:
        st = self.st
        if self.cuda:
            out = torch.empty((st.B, st.n), dtype=torch.int32, device=self.dev)
            nsel = self.bufs.state[self.S.STATE_NSEL].data_ptr()
            stream = torch.cuda.current_stream(self.dev).cuda_stream
            if self.layout == "sig":
                _kernels.launch("sig_coords", self.tab.t_sig.data_ptr(), self.bufs.sel.data_ptr(),
                                nsel, self.bitw.data_ptr(), st.n, st.bbits, st.B,
                                out.data_ptr(), stream)
            else:
                _kernels.launch("keyrow_coords", self.tab.t_key.data_ptr(),
                                self.tab.t_key.shape[1], self.bufs.sel.data_ptr(), nsel, st.n,
                                st.B, out.data_ptr(), stream)
            return out
        if self.layout == "sig":
            return sig_coords_plain(st, self.tab.t_sig, self.sel, self.n_sel, st.B)
        return keyrow_coords_plain(st, self.tab.t_key, self.sel, self.n_sel, st.B)

    @_on_device
    def partial(self, coords_g: torch.Tensor) -> torch.Tensor:
        st = self.st
        if self.cuda:
            return _tri_partial_cuda(coords_g, self.cubes, self.tri if self.tri.numel() else None,
                                     st.n, st.S)
        return tri_partial_plain(coords_g, self.cubes, self.tri, st.M, st.S)

    # 3. expand
    @_on_device
    def expand(self, eng: "ShardedFrontierSearch", h3: Optional[torch.Tensor]) -> None:
        st = self.st
        if self.cuda:
            if self.layout == "sig":
                self.S.expand_sharded_cuda(st, self.tab, self.bufs, self.ctr, eng.ub, h3,
                                           self.cand, self.R, eng.hash_params, eng.ndev, self.me)
            else:
                self.S.expand_keyrow_sharded_cuda(st, self.tab, self.bufs, self.ctr, eng.ub, h3,
                                                  self.cand, self.R, eng.hash_params, eng.ndev,
                                                  self.me, self.tag_base)
            return
        if self.layout == "sig":
            goal, self.cand, self.pending, self.lanes = expand_sharded_plain(
                st, self.tab, self.sel, self.n_sel, eng.ub, h3, eng.own, eng.ndev, self.me)
        else:
            goal, self.cand, self.pending, self.lanes = expand_keyrow_sharded_plain(
                st, self.tab, self.layout, self.sel, self.n_sel, eng.ub, h3, eng.own, eng.ndev,
                self.me, self.tag_base)
        self.ctr[0] = min(int(self.ctr[0]), goal)

    # 4. the route's two passes
    def _route_args(self):
        """The row width, key words and empty fsort of key-row routes."""
        return len(self.fill), self.st.W, self.fill[1]

    @_on_device
    def count(self, eng) -> torch.Tensor:
        if self.cuda:
            nsel = self.bufs.state[self.S.STATE_NSEL]
            stream = torch.cuda.current_stream(self.dev).cuda_stream
            if self.layout == "sig":
                _kernels.launch("route_count", self.cand.data_ptr(), self.ring.data_ptr(),
                                nsel.data_ptr(), self.st.M, self.cand.shape[0], self.ccar,
                                eng.ndev, self.seg, self.route_out.data_ptr(),
                                self.keys.data_ptr(), stream)
            else:
                _kernels.launch("route_count_rows", self.cand.data_ptr(), self.ring.data_ptr(),
                                nsel.data_ptr(), self.st.M, self.cand.shape[0], self.ccar,
                                eng.ndev, self.seg, *self._route_args(),
                                self.route_out.data_ptr(), self.keys.data_ptr(), stream)
            return self.route_out[: eng.ndev]
        self._route = route_plain(self.cand, self.n_sel * self.st.M, self.ring, eng.ndev,
                                  self.me, eng.exchange_cap, fill=self.fill)
        return self._route[2][: eng.ndev]

    @_on_device
    def pack(self, eng, S_all: Optional[torch.Tensor]) -> None:
        nxt = 1 - self.cur
        if self.cuda:
            nsel = self.bufs.state[self.S.STATE_NSEL]
            args = (self.cand.data_ptr(), self.ring.data_ptr(), nsel.data_ptr(), self.st.M,
                    self.ccar, eng.ndev, self.me, eng.exchange_cap,
                    None if S_all is None else S_all.data_ptr(), self.seg)
            outs = (self.route_out.data_ptr(), self.keys.data_ptr(), self.wire.data_ptr(),
                    self.rings[nxt].data_ptr(), torch.cuda.current_stream(self.dev).cuda_stream)
            if self.layout == "sig":
                _kernels.launch("route_pack", *args, *outs)
            else:
                _kernels.launch("route_pack_rows", *args, *self._route_args(), *outs)
        else:
            if S_all is not None:  # the ragged allowance
                self._route = route_plain(self.cand, self.n_sel * self.st.M, self.ring,
                                          eng.ndev, self.me, eng.exchange_cap, S_all, self.fill)
            self.wire, self.rings[nxt], self.route_out = self._route
        self.cur = nxt

    # 5. what the host reads
    @_on_device
    def report(self) -> torch.Tensor:
        if self.cuda:
            return torch.cat([self.ctr[0:1], self.ctr[6:7], self.bufs.state[0:5],
                              self.route_out.long()])
        return torch.cat([self.ctr[0:1], self.ctr[6:7], torch.tensor(self.state),
                          self.route_out.long()])

    # 6. the rows received go to the front of the pending list
    def recv_region(self, n_recv: int) -> torch.Tensor:
        if self.cuda:
            return self.bufs.pend[self.R - n_recv: self.R]
        self._recv = torch.empty((n_recv, self.pw), dtype=torch.int32)
        return self._recv

    # 7. insert, with the consensus in the step state
    @_on_device
    def insert(self, eng, goal_g: int, fmin_g: int, n_sel_g: int, n_recv: int) -> None:
        st = self.st
        if self.cuda:
            S = self.S
            state = self.bufs.state
            self.ctr[0].fill_(goal_g)
            state[S.STATE_FMIN].fill_(fmin_g)
            state[S.STATE_NSEL].fill_(n_sel_g)
            if n_recv:
                state[S.STATE_NPEND].add_(n_recv)
            if self.layout == "sig":
                S.probe_pending_cuda(st, self.tab, self.bufs, self.ctr, eng.fill, self.R - n_recv)
            else:
                S.insert_pending_cuda(st, self.tab, self.bufs, self.ctr, eng.fill,
                                      self.R - n_recv, n_recv)
            return
        c = self.ctr
        if self.layout == "sig":
            rows = torch.cat([self._recv, self.pending]).long()
            ovf, _, _ = _insert_sig(st, self.tab, rows[:, 0], rows[:, 1], rows[:, 2])
            c[0], c[1], c[2] = goal_g, fmin_g, c[2] + 1
            c[6] += int(ovf)
            c[7] = _adapt_thr(c[7], torch.tensor(n_sel_g), eng.fill)
            return
        ovf, reopen, rounds, un, tail = insert_pending_plain(
            st, self.tab, self.layout, torch.cat([self._recv, self.pending]), n_recv)
        c[0] = goal_g
        state = [0, self.state[1], n_sel_g, self.state[3] + reopen, fmin_g]
        finish_plain(c, state, eng.fill, self.lanes, ovf, rounds, un, tail)

    @_on_device
    def walk_hops(self, coord, hops: int) -> torch.Tensor:
        if self.cuda:
            return self.S.walk_hops_cuda(self.st, self.tab, coord, hops, self.layout)
        return walk_hops_plain(self.st, self.tab, coord, hops, self.layout)


def _devices_of(devices) -> list:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass devices=['cpu', ...] "
                               "(CLI: --device cpu) to run the shards on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    for d in out:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available for the shards")
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported shard device {d}")
    return out


class ShardedFrontierSearch:
    """Sharded frontier A* over a mesh of shards (JAX
    ``ShardedFrontierSearch``): ``devices`` is a list of shard devices,
    which may repeat (``["cuda:0"] * 4``: four shards on one card; default:
    every visible card), or a mesh (``LocalMesh``, ``ProcessMesh``).  The
    arguments, their defaults, the automatic capacity and batch and the
    layout (``auto``: sig where the upper bound's f spread fits the packed
    word and the capacity takes the sig word, else packed where the
    spread fits, else unpacked) are JAX's.  ``shard_cubes`` splits the
    triangle cubes over the shards on the sig and packed layouts; an
    unpacked shard reads the whole stack whatever it says, as JAX's
    unpacked step does.  A multi-process mesh refuses the unpacked layout
    when it runs, as JAX does."""

    def __init__(self, problem: Problem, heuristic: Optional[HPairHeuristic] = None,
                 devices=None, hash_type: str = "FSUM", hash_shift: int = 4,
                 batch: Optional[int] = None, capacity: Optional[int] = None,
                 max_steps: int = 500_000, chunk_steps: int = 256,
                 layout: str = "auto", exchange_cap: Optional[int] = None,
                 shard_cubes="auto", exchange: str = "auto",
                 fill_target: Optional[int] = None):
        if fill_target is not None and fill_target < 1:
            raise ValueError("fill_target must be >= 1")
        if exchange not in ("auto", "ragged", "dense"):
            raise ValueError(f"unknown exchange mode {exchange!r}")
        if layout not in ("auto", "sig", "packed", "unpacked"):
            raise ValueError(f"layout={layout!r}: choose auto, sig, packed or unpacked")
        self.fill_target = fill_target
        self.layout_pref = layout
        self.problem = problem
        if isinstance(devices, (LocalMesh, ProcessMesh)):
            self.mesh = devices
        else:
            self.mesh = LocalMesh(_devices_of(devices))
        self.ndev = self.mesh.ndev
        self.multiprocess = self.mesh.multiprocess
        self.local_devices = [self.mesh.devices[i if isinstance(self.mesh, LocalMesh) else 0]
                              for i in self.mesh.local]
        dev0 = self.local_devices[0]
        self.heuristic = (heuristic if heuristic is not None
                          else HPairHeuristic.build(problem, dev0))
        n = problem.n_seq
        M = (1 << n) - 1
        if batch is None:
            # a fixed total selection width across the mesh (strong
            # scaling): each shard's batch shrinks as the shards grow
            batch = max(64, min(2048, (1 << 18) // M) // self.ndev)
        auto_capacity = capacity is None
        if capacity is None:
            lattice = 1
            for L in problem.final_coord:
                lattice *= int(L) + 1
                if lattice > (1 << 26):
                    break
            # the total table across the mesh, then a shard's part of it
            total = max(1 << 16, min(1 << 23, lattice * 2))
            per_dev = max(1 << 14, min(1 << 22, total // self.ndev))
            capacity = 1 << (per_dev - 1).bit_length()
        batch = max(16, min(batch, capacity))
        batch = 1 << (batch.bit_length() - 1)  # grouped selection needs B | C
        self.max_steps = max_steps
        self.chunk_steps = chunk_steps
        self.hash_type = hash_type
        self.hash_shift = hash_shift

        wi = self.heuristic.weight_i
        self.degenerate = bool((wi[~np.eye(n, dtype=bool)] <= 0).any())
        if GAP_OPEN == GAP_EXTENSION and not self.degenerate:
            beam = 1024 if capacity * self.ndev >= (1 << 22) else 32
            self.ub = greedy_upper_bound(problem, self.heuristic, beam=beam)
        else:
            self.ub = INF
        # the triple cubes, built on this process's first shard device as
        # JAX builds them on a local mesh device
        if not self.degenerate and getattr(self.heuristic, "triangles", None) is None:
            ht = HTriples.build(self.heuristic, device=dev0)
            if ht is not None:
                self.heuristic = ht
        budget = 1 << (31 - n)
        f0 = _rebase_origin(self.heuristic, n)
        if (self.ub < INF and not (self.ub - f0 + 64) < budget
                and getattr(self.heuristic, "triangles", None)):
            f0 = int(self.heuristic.calculate_h(np.zeros(n, dtype=np.int32)))
        self.packed = self.ub < INF and (self.ub - f0 + 64) < budget
        self._f0, self._batch = f0, batch
        self._make_statics(capacity)

        if shard_cubes == "auto":
            self.shard_cubes = self.ndev > 1 and self.st.T3 > 0
        else:
            self.shard_cubes = bool(shard_cubes) and self.st.T3 > 0
        L_cand = self.st.B * self.st.M
        if exchange_cap is None:
            exchange_cap = 128 if self.ndev == 1 else min(L_cand, max(256, (2 * L_cand) // self.ndev))
        if int(exchange_cap) < 1:
            raise ValueError(
                f"exchange_cap must be >= 1 (got {exchange_cap}): a zero-width wire "
                "delivers no migrants, so every remote candidate would cycle the "
                "carry ring until it overflows")
        self.exchange_cap = int(exchange_cap)
        if exchange == "auto":
            exchange = ("ragged" if all(d.type == "cuda" for d in self.local_devices)
                        else "dense")
        self.exchange = exchange
        if self.layout_pref != "auto":
            self.layout = self.layout_pref
            if self.layout == "sig" and not (self.packed and self.st.sig_ok):
                raise ValueError("sig layout requires packed eligibility and a "
                                 "sig-encodable lattice")
            if self.layout == "packed" and not self.packed:
                raise ValueError("packed layout requires a finite upper bound")
        else:
            self.layout = ("sig" if self.packed and self.st.sig_ok
                           else "packed" if self.packed else "unpacked")
        # the unpacked step reads the whole cube stack on every shard
        self.cubes_split = self.shard_cubes and self.layout != "unpacked"
        self.own = owner_fn(hash_type, self.ndev, hash_shift)
        self.hash_params = owner_params(hash_type, self.ndev, hash_shift, n)
        self.root_owner = int(self.own(np.zeros((1, n), dtype=np.int32))[0])
        self.h_root = int(self.heuristic.calculate_h(np.zeros(n, dtype=np.int32)))
        self.last_stats: dict = {}

    def _make_statics(self, capacity: int) -> None:
        """One _Static a distinct local device (shards on one card share
        it)."""
        self.statics = {}
        for d in self.local_devices:
            if d not in self.statics:
                self.statics[d] = _Static(self.problem, self.heuristic, self._batch, capacity,
                                          d, f0=self._f0)
        self.st = self.statics[self.local_devices[0]]

    @property
    def fill(self) -> int:
        return self.fill_target if self.fill_target is not None else self.st.B * self.ndev

    def run(self) -> ShardedSearchResult:
        """Run to the provably optimal goal; on table or exchange-carry
        overflow the per-shard capacity (table) or the exchange cap (carry)
        doubles and the search restarts, at most 3 times and only in a
        single process (the ranks of several would have to agree).
        ``retries`` lists the restarts: (overflow kind, capacity a shard,
        exchange cap) after each."""
        attempts = 0
        self.retries = []
        while True:
            try:
                res = self._run_once()
                scale = getattr(self.heuristic, "cost_scale", 1)
                if scale > 1:
                    # the fractional cover ran in (n-2)-scaled cost units
                    res = ShardedSearchResult(
                        g=res.g // scale, h=res.h // scale, f=res.f // scale,
                        closed={c: (g // scale, m) for c, (g, m) in res.closed.items()},
                        nodes_expanded=res.nodes_expanded, nodes_reopened=res.nodes_reopened,
                        open_size=res.open_size, steps=res.steps,
                        shard_stats=res.shard_stats, nodes_migrated=res.nodes_migrated)
                return res
            except RuntimeError as e:
                msg = str(e)
                carry_only = "exchange-carry overflow" in msg
                table_ovf = "hash table overflow" in msg
                if ((not carry_only and not table_ovf) or attempts >= 3
                        or self.multiprocess):
                    raise
                if table_ovf and self.st.C >= (1 << 23):
                    raise
                attempts += 1
                if table_ovf:
                    self._make_statics(self.st.C * 2)
                self.exchange_cap = min(self.st.B * self.st.M, self.exchange_cap * 2)
                self.retries.append(("table" if table_ovf else "exchange-carry", self.st.C,
                                     self.exchange_cap))
                print(f"sharded search: {'table' if table_ovf else 'exchange-carry'} "
                      f"overflow; retry {attempts} with capacity {self.st.C} a shard and "
                      f"exchange cap {self.exchange_cap}")

    def _shards(self) -> List[_Shard]:
        self.cube_stack = None
        if self.cubes_split:
            st = self.st
            self.cube_stack = st.d_cubes.view(st.T3, st.S, st.S, st.S)
        shards = [_Shard(self, me, d, self.statics[d])
                  for me, d in zip(self.mesh.local, self.local_devices)]
        if self.cubes_split:  # each shard holds its own cubes now
            for st in self.statics.values():
                st.d_cubes = torch.zeros(0, dtype=torch.int32, device=st.device)
            self.cube_stack = None
        return shards

    def _run_once(self) -> ShardedSearchResult:
        st = self.st
        if self.degenerate:
            warnings.warn(
                "non-positive Altschul pair weights detected: edge costs can be "
                "negative, so A* optimality is undefined for this input (the "
                "reference has the same limitation)", RuntimeWarning, stacklevel=3)
        if self.multiprocess and self.layout == "unpacked":
            raise NotImplementedError(
                "multi-process meshes require the packed or sig layout (degenerate inputs "
                "and O != E are single-process only)")
        if self.ndev == 1 and self.exchange == "dense":
            return self._run_single()
        if self.cubes_split and st.d_cubes.numel() == 0:
            # a retry: the statics were rebuilt, their cubes with them
            self._make_statics(st.C)
            st = self.st
        shards = self._shards()
        mesh, ndev = self.mesh, self.ndev
        cap, ragged = self.exchange_cap, self.exchange == "ragged"
        nb, f0, pw = st.nb, st.f0, shards[0].pw
        per = np.zeros((ndev, 5), dtype=np.int64)  # expanded, reopened, -, open, migrated
        stats = dict(steps=0, host_reads=0, wire_rows=0, migrated=0, peak_carry=0,
                     exchange=self.exchange, cap=cap)
        goal_g, steps = INF, 0
        t0 = time.perf_counter()
        while True:
            for sh in shards:
                sh.select()
            h3s = [None] * len(shards)
            if self.cubes_split:
                gathered = mesh.all_gather([sh.coords() for sh in shards])
                parts = [sh.partial(g.reshape(ndev * st.B, st.n))
                         for sh, g in zip(shards, gathered)]
                h3s = mesh.reduce_scatter(parts)
            for sh, h3 in zip(shards, h3s):
                sh.expand(self, h3)
            counts = [sh.count(self) for sh in shards]
            S_all = mesh.all_gather(counts) if ragged else [None] * len(shards)
            for sh, S in zip(shards, S_all):
                sh.pack(self, S)
            rep = mesh.all_gather([sh.report() for sh in shards])[0].cpu().numpy()
            stats["host_reads"] += 1
            steps += 1
            # the consensus (JAX _consensus): goal g, f-min with the carried
            # rows' (a spilled node keeps its f in the bound), rows
            # selected, overflow
            route = rep[:, R_ROUTE:]
            carry_f = carry_bound(self.layout, route[:, ndev + 2], nb, f0)
            goal_g = int(rep[:, R_GOAL].min())
            fmin_g = int(np.minimum(rep[:, R_FMIN], carry_f).min())
            n_sel_g = int(rep[:, R_NSEL].sum())
            carry_ovf = int((route[:, ndev + 1] > 0).sum())
            table_ovf = int((rep[:, R_OVF] > 0).sum())
            A = route_sizes(route[:, :ndev], ndev, cap, ragged)
            per[:, 0] += rep[:, R_NSEL]
            per[:, 1] += rep[:, R_REOPEN]
            per[:, 3] = rep[:, R_NOPEN]
            per[:, 4] += route[:, ndev]
            stats["wire_rows"] += int(A.sum())
            stats["migrated"] += int(route[:, ndev].sum())
            stats["peak_carry"] = max(stats["peak_carry"],
                                      int(np.minimum(np.maximum(route[:, :ndev].sum(1)
                                                                - A.sum(1), 0),
                                                     shards[0].ccar).max()))
            if table_ovf or carry_ovf:
                break
            # the exchange: each shard's received rows, in sender order, in
            # front of its self-owned pending lanes
            n_recv = A.sum(0)
            regions = [sh.recv_region(int(n_recv[sh.me])) for sh in shards]
            if ragged:
                off = np.cumsum(A, axis=1) - A
                mesh.all_to_all_ragged([sh.wire for sh in shards], off, A, regions)
            else:
                blocks = mesh.all_to_all([sh.wire[: ndev * cap].view(ndev, cap, pw)
                                          for sh in shards])
                for sh, blk, region in zip(shards, blocks, regions):
                    at = 0
                    for i in range(ndev):
                        k = int(A[i][sh.me])
                        region[at:at + k].copy_(blk[i, :k])
                        at += k
            for sh in shards:
                sh.insert(self, goal_g, fmin_g, n_sel_g, int(n_recv[sh.me]))
            if fmin_g >= goal_g:
                break
            if steps % self.chunk_steps == 0 and steps >= self.max_steps:
                break
        # the last step's insert may have overflowed a table
        table_ovf = table_ovf or int(sum(int(sh.ctr[6]) > 0 for sh in shards))
        if self.multiprocess:
            t = torch.tensor([table_ovf], dtype=torch.int64, device=shards[0].dev)
            table_ovf = int(mesh.all_sum([t])[0])
        stats.update(steps=steps, search_s=time.perf_counter() - t0)
        self.last_stats = stats
        if table_ovf:
            raise RuntimeError(f"shard hash table overflow (per-shard capacity {st.C}"
                               + (f"; also exchange-carry overflow, cap {cap}"
                                  if carry_ovf else "") + "); increase capacity")
        if carry_ovf:
            raise RuntimeError(f"exchange-carry overflow (exchange cap {cap}); increase "
                               "exchange_cap")
        if steps >= self.max_steps and fmin_g < goal_g:
            raise RuntimeError("max_steps exceeded")
        if goal_g >= INF:
            raise RuntimeError("open set exhausted without reaching the goal")
        t0 = time.perf_counter()
        masks, rounds = self._walk(shards)
        stats.update(walk_rounds=rounds, walk_s=time.perf_counter() - t0)
        table = np.zeros((ndev, 2), dtype=np.int64)  # closed, open of each shard
        for sh in shards:
            n_open, n_closed = _open_closed(st, sh.tab)
            table[sh.me] = n_closed, n_open
        if self.multiprocess:
            table = mesh.all_sum([torch.as_tensor(table, device=shards[0].dev)])[0]
            table = table.cpu().numpy()
        per[:, 2:4] = table
        return self._result(goal_g, steps, masks, per)

    def _walk(self, shards: List[_Shard]) -> Tuple[List[int], int]:
        """The batched distributed walk (JAX ``_make_batched_walk``): rounds
        of at most WALK_HOPS hops on every shard's table, summed by the
        mesh, one host read a round; it stops at the origin or when a round
        makes no progress."""
        n = self.st.n
        coord = [int(v) for v in self.problem.final_coord]
        masks, rounds = [], 0
        while any(coord):
            runs = [sh.walk_hops(coord, WALK_HOPS)[:WALK_HOPS] for sh in shards]
            tot = self.mesh.all_sum(runs)[0].cpu().tolist()
            rounds += 1
            run = [m for m in tot if m > 0]
            if not run:
                break
            for m in run:
                masks.append(m)
                coord = [coord[i] - ((m >> i) & 1) for i in range(n)]
        if any(coord):
            raise RuntimeError("distributed backtrace did not reach the origin")
        return masks, rounds

    def _run_single(self) -> ShardedSearchResult:
        """One shard, dense: the single-table search (JAX's ndev == 1 fast
        path), the engine's own chunk and walk."""
        st = self.st
        tab = _shard_table(st, self.layout, self.h_root, True)
        ctr = torch.as_tensor(fresh_counters(), device=st.device)
        t0 = time.perf_counter()
        chunks = 0
        while True:
            ctr = _run_chunk(st, tab, ctr, self.chunk_steps, self.ub, self.fill, self.layout)
            chunks += 1
            c = ctr.tolist()
            goal_v, fmin_v, steps, expanded, reopened, _, overflow = c[:7]
            if fmin_v >= goal_v or overflow > 0 or steps >= self.max_steps:
                break
        self.last_stats = dict(steps=steps, host_reads=chunks, wire_rows=0, migrated=0,
                               peak_carry=0, exchange="none", cap=self.exchange_cap,
                               search_s=time.perf_counter() - t0)
        if overflow > 0:
            raise RuntimeError(f"shard hash table overflow (per-shard capacity {st.C}); "
                               "increase capacity")
        if steps >= self.max_steps and fmin_v < goal_v:
            raise RuntimeError("max_steps exceeded")
        if goal_v >= INF:
            raise RuntimeError("open set exhausted without reaching the goal")
        t0 = time.perf_counter()
        masks, coord = walk(st, tab, self.layout)
        if np.any(coord != 0):
            raise RuntimeError("distributed backtrace did not reach the origin")
        self.last_stats.update(walk_rounds=1, walk_s=time.perf_counter() - t0)
        n_open, n_closed = _open_closed(st, tab)
        per = np.array([[expanded, reopened, n_closed, n_open, 0]], dtype=np.int64)
        return self._result(goal_v, steps, [int(m) for m in masks], per)

    def _result(self, goal_g: int, steps: int, masks: Sequence[int],
                per: np.ndarray) -> ShardedSearchResult:
        st = self.st
        closed: Dict[Tuple[int, ...], Tuple[int, int]] = {}
        coord = tuple(int(v) for v in st.final_np)
        for mv in masks:
            if not any(coord):
                break
            if mv == 0:
                continue
            closed[coord] = (0, mv)
            coord = tuple(coord[i] - ((mv >> i) & 1) for i in range(st.n))
        # the exact g of every path node (the tables store (f << n) | parent)
        closed = attach_path_g(self.problem, self.heuristic.weight_i, closed,
                               goal_g=None if self.degenerate else goal_g)
        h_goal = self.heuristic.calculate_h(st.final_np)
        return ShardedSearchResult(
            g=goal_g, h=h_goal, f=goal_g + h_goal, closed=closed,
            nodes_expanded=int(per[:, 0].sum()), nodes_reopened=int(per[:, 1].sum()),
            open_size=int(per[:, 3].sum()), steps=steps,
            shard_stats=[tuple(int(v) for v in row) for row in per],
            nodes_migrated=int(per[:, 4].sum()))
