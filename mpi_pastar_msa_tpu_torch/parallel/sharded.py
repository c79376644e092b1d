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
  5. ``consensus`` (csrc/shard_loop.cu; JAX ``_consensus`` and the
     allowance A of ``_route_cap`` / ``_route_ragged``), on every card
     over every shard's report, computes on the device goal g, f-min with
     the rings', the rows selected, overflow, A, the rows each shard
     receives and the run's telemetry (``cons``), and writes its own
     shards' step state, received count and insert's flag, and the run
     flag of the next step (the stop test);
  6. ``exchange`` (csrc/shard_loop.cu) moves the wire rows, A[i][r] from
     sender i to receiver r, into each receiver's pending list just before
     its self-owned lanes, every size read on the device (the rank form,
     below, reads its senders' wires by address under the ragged
     exchange, another process's mapped into this one through CUDA IPC,
     and first moves the wires with the mesh's fixed-shape all-to-all
     under the dense one);
  7. the insert (K5 on sig, K10 on key rows) places the received rows and
     the self-owned pending lanes, reading where the list starts and how
     many rows were received on the device, then writes the counters and
     the threshold.  On key rows a received row claims a slot with its
     place in the received region, a self-owned lane with ndev x the
     exchange cap + its content tag, so no tag depends on the order in
     which lanes arrive.

Every kernel of the step returns at once when the run flag of its device
reads 0 (the insert under its own flag, which the consensus sets), as the
single-table step's do, so a chunk of steps needs no host read.  The
step has two forms.  The card form (every shard of the mesh in this
process: a ``LocalMesh``) keeps every size on the cards: on one card the
shards write their rows of the card's gathers in place and the consensus
reads each report where it lies; across cards (peer access enabled) each
card runs its shards on its own stream, pulls the other cards' rows of
each gather by copies, snapshots its shards' reports, and reads its
peers' snapshots, wires and walk runs by address, the phases joined by
events between the cards' streams.  The chunked driver (JAX's, one host
read a chunk) captures one step of the whole mesh, every card in it, as
a CUDA graph for each parity of the carry rings, and runs a chunk as that
many replays of the two in turn.  The rank form (a ``ProcessMesh``, one
shard a rank; the host driver on a LocalMesh of several cards) runs the
mesh's collectives between the phases, each into a preallocated buffer
and with no host value, so each rank captures its own step graph with
NCCL's calls in it, and the chunked driver replays it as the card form's;
its ragged exchange reads every rank's wire by address (``map_peers``:
CUDA IPC on a ProcessMesh of cards), and only on a mesh that maps no wire
(gloo ranks on the CPU, cards without peer access) is it sized on the
host, once a step.
A CPU shard
runs the plain versions of every kernel (``_select_best_plain``, ``_select_open_plain``,
``sig_coords_plain``, ``keyrow_coords_plain``, ``tri_partial_plain``,
``expand_sharded_plain``, ``expand_keyrow_sharded_plain``,
``route_plain``, ``consensus_plain``, ``exchange_plain``, ``_insert_sig``,
``insert_pending_plain``, ``walk_advance_plain``), a CUDA shard the
kernels, and never the plain versions.  After the search the walk runs in
rounds (JAX ``_make_batched_walk``): every shard walks at most K = 8 hops
from the current coordinate on its own table (K7's hop-limited mode, any
layout), stopping where another shard owns the node; the runs are summed
(one shard's is non-zero) and the coordinate moves on: under the chunked
driver ``walk_advance`` on the device, WALK_ROUNDS rounds a host read
(in the rank form after the mesh's sum of the runs), under the host
driver the mesh's sum and one host read a round.

One shard with the dense exchange is the single-table search itself
(JAX's ndev == 1 fast path): the engine's chunk (``_run_chunk``: on a
card the chunk graph of the layout's three step kernels) and the
one-table walk.  A multi-process mesh refuses the unpacked layout when it
runs, as JAX's does.
"""
from __future__ import annotations

import contextlib
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
                             N_COUNTERS, fresh_counters, walk)
from ..search.step import (STATE_FMIN, STATE_NPEND, STATE_NSEL, STATE_NVALID, STATE_WORDS,
                           _check)
from ..utils.graph import join_full
from .mesh import LocalMesh, ProcessMesh
from .partition import owner_fn, owner_params

#: the walk's hops a round (JAX ``_make_batched_walk``'s K)
WALK_HOPS = 8
#: the empty candidate and ring row: (dest = ndev, INFP, home 0, sig -1)
_FILL_TAIL = (INFP, 0, -1)
#: report slots: goal g, overflow (counters 0, 6), then state slots 0-4
#: (K3's g max, open, selected, reopened, f-min), then the route's out
R_GOAL, R_OVF, R_NOPEN, R_NSEL, R_REOPEN, R_FMIN, R_ROUTE = 0, 1, 3, 4, 5, 6, 7
#: the consensus vector's slots (csrc/shard_loop.cu q*): steps, goal g,
#: f-min, rows selected, the shards whose table or carry ring overflowed,
#: wire rows, migrated rows, peak carry, the run flag; then 4 words a shard
#: (expanded, reopened, open, migrated) from C_HEAD, then A (ndev, ndev)
(C_STEPS, C_GOAL, C_FMIN, C_NSEL, C_TOVF, C_COVF, C_WIRE, C_MIGR, C_PEAK, C_RUN,
 C_HEAD) = range(11)
#: the most shards the sharded loop's kernels take (kMaxDev)
MAX_SHARDS = 32
#: the walk's rounds a host read of the chunked driver's walk loop in its
#: round form (on a card that many replays of a one-round graph)
WALK_ROUNDS = 32


def replay_parities(parity: int, steps: int) -> List[int]:
    """The ring parity of each step graph a chunk of ``steps`` replays
    starting from rings at ``parity``: every step packs into the other
    ring, so the two graphs alternate."""
    return [(parity + k) % 2 for k in range(steps)]


def parity_after(parity: int, steps_run: int) -> int:
    """The ring parity after a chunk that started at ``parity`` and ran
    ``steps_run`` steps (the consensus counts them; the replays after the
    stop pack nothing)."""
    return (parity + steps_run) % 2


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


def _tri_partial_cuda(coords, cubes, tri, n: int, S: int, out: Optional[torch.Tensor] = None,
                      run: Optional[torch.Tensor] = None, launch=None) -> torch.Tensor:
    """K12 into ``out`` (default a new (rows, M + 1) int32), nothing while
    ``run`` (the step loop's flag) reads 0; ``launch`` takes the C
    arguments in place of ``_kernels.launch``."""
    rows = coords.shape[0]
    if out is None:
        out = torch.empty((rows, (1 << n) - 1 + 1), dtype=torch.int32, device=coords.device)
    _check(out, "out", coords.device, torch.int32, rows * (1 << n))
    Tl = 0 if tri is None else tri.shape[0]
    (launch or _kernels.launch)(
        "tri_partial", coords.data_ptr(), cubes.data_ptr() if Tl else None,
        tri.data_ptr() if Tl else None, n, S, Tl, rows, out.data_ptr(),
        None if run is None else run.data_ptr(),
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


def walk_shards_plain(st: _Static, tabs: Sequence, final, layout: str, own,
                      hops: int = WALK_HOPS) -> Tuple[List[int], List[int], int]:
    """The plain version of ``path_walk_shards`` (csrc/path_walk.cu): the
    sharded walk of ``_walk`` from ``final`` in one pass, each node looked
    up in its owner's table (``own``, the engine's owner hash; ``tabs[i]``
    shard i's table of ``layout``), and the rounds the round form takes:
    one at the start and wherever the owner changes or ``hops`` nodes of
    one owner were walked; a node its owner does not hold ends the walk
    (mid-round, the round form's next round finds nothing: one more).
    Returns (masks, the coordinate it stopped at, rounds)."""
    lookup = _LAYOUT_FNS[layout].lookup
    c = np.asarray(final, dtype=np.int64).copy()
    masks: List[int] = []
    rounds, owner, run = 0, -1, 0
    while c.any():
        o = int(own(c[None, :].astype(np.int32))[0])
        if o != owner or run == hops:
            rounds, owner, run = rounds + 1, o, 0
        par = lookup(st, tabs[o], torch.as_tensor(c))
        if par is None:
            rounds += run > 0
            break
        run += 1
        masks.append(int(par))
        c = c - np.array([(par >> i) & 1 for i in range(st.n)])
    return masks, [int(v) for v in c], rounds


def walk_shards_cuda(st: _Static, tabs: Sequence, final, layout: str, hash_params: tuple,
                     hops: int = WALK_HOPS) -> Tuple[List[int], List[int], int]:
    """``path_walk_shards`` (csrc/path_walk.cu): ``walk_shards_plain`` on
    the card of the shards' tables (every one on it), one launch and one
    host read; ``hash_params``: partition.owner_params.  Raises ValueError
    as ``walk_cuda`` and RuntimeError when the launch fails."""
    from ..search import step as S

    if not 1 <= len(tabs) <= MAX_SHARDS:
        raise ValueError(f"the one-launch walk takes 1 .. {MAX_SHARDS} shards, got {len(tabs)}")
    rows = [S._walk_table(st, tab, layout) for tab in tabs]
    dev = rows[0][0]
    if any(r[0] != dev for r in rows):
        raise ValueError(f"the one-launch walk needs every table on one card: "
                         f"{[str(r[0]) for r in rows]}")
    _, code, _, stride, _, _, probes = rows[0]
    table = torch.tensor([[r[2], r[4] or 0, r[5] or 0] for r in rows], dtype=torch.int64)
    n, tmax = st.n, int(st.final_np.sum())
    params = torch.tensor([int(v) for v in final] + list(st.bitw), dtype=torch.int32).to(dev)
    out = torch.empty(tmax + n + 2, dtype=torch.int32, device=dev)
    _kernels.launch("path_walk_shards", code, table.data_ptr(), len(tabs), stride, n, st.C,
                    st.bbits, probes, *hash_params, hops, params.data_ptr(),
                    tmax, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    v = out.cpu().tolist()  # the walk's one read
    return v[:v[tmax + n]], v[tmax:tmax + n], v[tmax + n + 1]


# --- the sharded loop (csrc/shard_loop.cu, K6s): consensus, exchange and
# walk_advance, plain versions and wrappers


def cons_words(ndev: int) -> int:
    """Words of the consensus vector: its head, 4 a shard, then A."""
    return C_HEAD + 4 * ndev + ndev * ndev


def fresh_cons(ndev: int, device) -> torch.Tensor:
    """A run's consensus vector before its first step: no goal, running."""
    cons = torch.zeros(cons_words(ndev), dtype=torch.int64, device=device)
    cons[C_GOAL] = INF
    cons[C_RUN] = 1
    return cons


def cons_sizes(cons, ndev: int):
    """A (ndev, ndev) of a consensus vector (a view, or a NumPy array)."""
    return cons[C_HEAD + 4 * ndev:].reshape(ndev, ndev)


def report_row(ctr: torch.Tensor, state: torch.Tensor, route_out: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A shard's report (R_* slots): goal, overflow (counters 0, 6), the
    step state's first five slots (K3's), K11's out; int64."""
    return torch.cat([ctr[0:1], ctr[6:7], state[0:5], route_out.to(torch.int64)], out=out)


def gather_reports(reports) -> torch.Tensor:
    """Every shard's report, row i shard i's, (ndev, R_ROUTE + ndev + 3)
    int64: ``reports`` is that tensor, or a sequence of ndev entries, shard
    i's report row (int64) or its (counters, state, route out) where they
    lie."""
    if isinstance(reports, torch.Tensor):
        return reports
    dev = torch.device("cpu")
    return torch.stack([(r if isinstance(r, torch.Tensor) else report_row(*r)).to(dev)
                        for r in reports])


def consensus_plain(reports, ndev: int, cap: int, ragged: bool, layout: str, nb: int, f0: int,
                    ccar: int, run: torch.Tensor, targets: Sequence[tuple],
                    cons: torch.Tensor) -> None:
    """The plain version of ``consensus`` (csrc/shard_loop.cu; JAX
    ``_consensus`` :312 with the allowance of ``_route_cap`` :87 and
    ``_route_ragged`` :214-:231), in place, nothing when ``run`` reads 0.
    From the reports of every shard (``gather_reports``: gathered rows, or
    each shard's words where they lie, on any card): goal_g, fmin_g (each
    shard's f-min with its ring's ``carry_bound``), the rows selected, the
    shards whose table or carry ring overflowed, A (``route_sizes``), and
    the telemetry into ``cons`` (int64, C_*: steps, wire and migrated rows
    and peak carry added up; per shard expanded, reopened and migrated
    added up, open set); then into each target, a shard of this card
    (counters, step state, int32 received count, int32 insert flag, shard
    index): on overflow the insert's flag 0 and nothing else (the step
    stops before the exchange); else ctr[0] = goal_g, state[STATE_FMIN] =
    fmin_g, state[STATE_NSEL] = rows selected, state[STATE_NPEND] += rows
    received, the received count, the flag 1.  ``run`` becomes the next
    step's: no overflow and fmin_g < goal_g.  Every card of a mesh runs it
    on every report, with its own targets, and gets the same vector."""
    if not int(run[0]):
        return
    rep = gather_reports(reports)
    r = rep.cpu().numpy().astype(np.int64)
    route = r[:, R_ROUTE:]
    S = route[:, :ndev]
    carry_f = np.asarray(carry_bound(layout, route[:, ndev + 2], nb, f0), dtype=np.int64)
    goal_g = int(r[:, R_GOAL].min())
    fmin_g = int(np.minimum(r[:, R_FMIN], carry_f).min())
    n_sel_g = int(r[:, R_NSEL].sum())
    A = route_sizes(S, ndev, cap, ragged)
    c = cons.cpu().numpy().astype(np.int64)
    per = c[C_HEAD:C_HEAD + 4 * ndev].reshape(ndev, 4)
    per[:, 0] += r[:, R_NSEL]
    per[:, 1] += r[:, R_REOPEN]
    per[:, 2] = r[:, R_NOPEN]
    per[:, 3] += route[:, ndev]
    spill = np.minimum(np.maximum(S.sum(1) - A.sum(1), 0), ccar)
    tovf, covf = int((r[:, R_OVF] > 0).sum()), int((route[:, ndev + 1] > 0).sum())
    stop = tovf > 0 or covf > 0
    c[C_STEPS] += 1
    c[C_GOAL], c[C_FMIN], c[C_NSEL], c[C_TOVF], c[C_COVF] = goal_g, fmin_g, n_sel_g, tovf, covf
    c[C_WIRE] += int(A.sum())
    c[C_MIGR] += int(route[:, ndev].sum())
    c[C_PEAK] = max(int(c[C_PEAK]), int(spill.max()))
    c[C_RUN] = int(not stop and fmin_g < goal_g)
    cons_sizes(c, ndev)[:] = A
    cons.copy_(torch.from_numpy(c))
    n_recv = A.sum(0)
    for ctr, state, recv, go, me in targets:
        if stop:
            go.fill_(0)
            continue
        ctr[0] = goal_g
        state[STATE_FMIN] = fmin_g
        state[STATE_NSEL] = n_sel_g
        state[STATE_NPEND] += int(n_recv[me])
        recv.fill_(int(n_recv[me]))
        go.fill_(1)
    run.fill_(int(c[C_RUN]))


def exchange_plain(cons: torch.Tensor, ndev: int, cap: int, ragged: bool, R: int,
                   wires: Sequence[torch.Tensor], pends: Sequence[torch.Tensor],
                   flags: Sequence[torch.Tensor], recv_me: Sequence[int],
                   received: bool = False) -> None:
    """The plain version of ``exchange`` (csrc/shard_loop.cu; the
    all_to_all of ``_route_cap`` :148 and ``_route_ragged`` :231 with the
    sizes read from A on the device): for each receiver b (shard
    recv_me[b]) whose insert flag flags[b] is set, A[i][r] rows of
    ``wires[i]`` (ragged: from row sum_{j<r} A[i][j]; dense: from r cap of
    sender i's wire, or with ``received`` from i cap of the receiver's
    buffer after the dense all-to-all) into pends[b], in sender order,
    ending at row R, in place."""
    if ragged and received:
        raise ValueError("exchange: the received blocks of a dense all-to-all, not ragged")
    A = cons_sizes(cons, ndev).cpu().numpy()
    for pend, flag, r in zip(pends, flags, recv_me):
        if not int(flag[0]):
            continue
        at = R - int(A[:, r].sum())
        for i in range(ndev):
            n = int(A[i][r])
            off = int(A[i][:r].sum()) if ragged else (i if received else r) * cap
            pend[at:at + n] = wires[i][off:off + n]
            at += n


def walk_advance_plain(wout, hops: int, n: int, params: torch.Tensor, masks: torch.Tensor,
                       wst: torch.Tensor, wrun: torch.Tensor) -> None:
    """The plain version of ``walk_advance`` (csrc/shard_loop.cu; a round
    of JAX ``_make_batched_walk``'s while_loop, :545): nothing when
    ``wrun`` reads 0; else the sum of the shards' runs (``wout``: one
    (ndev, hops + N + 1) buffer, or a sequence of each shard's run where it
    lies, on any card), its positive masks appended to ``masks`` at
    wst[0], the coordinate params[:n] stepped back by their bits, wst[1]
    += 1 (rounds), and wrun cleared at the origin, when the round emitted
    nothing, or when ``masks`` has no room for another round, in place;
    ``params``, ``masks``, ``wst`` and ``wrun`` are one card's."""
    if not int(wrun[0]):
        return
    tot = [0] * hops
    for row in wout:
        tot = [t + v for t, v in zip(tot, row[:hops].tolist())]
    run = [m for m in tot if m > 0]
    at = int(wst[0])
    for k, m in enumerate(run):
        if at + k < masks.numel():
            masks[at + k] = m
    coord = params[:n].tolist()
    for m in run:
        coord = [coord[d] - ((m >> d) & 1) for d in range(n)]
    params[:n] = torch.tensor(coord, dtype=params.dtype)
    wst[0] = at + len(run)
    wst[1] += 1
    if not run or not any(coord) or at + len(run) + hops > masks.numel():
        wrun.fill_(0)


def consensus_cuda(rtab: torch.Tensor, ndev: int, cap: int, ragged: bool, layout: str, nb: int,
                   f0: int, ccar: int, run: torch.Tensor, tgt: torch.Tensor, cons: torch.Tensor,
                   launch=None) -> None:
    """``consensus`` (csrc/shard_loop.cu) on the card of ``cons``:
    ``consensus_plain`` with the reports as ``rtab`` (``report_table``) and
    the targets as ``tgt`` (``target_table``), int64 tables in host memory
    of addresses (the C entry copies them into the launch's parameters);
    ``launch`` as ``_tri_partial_cuda``'s."""
    dev = cons.device
    _check(run, "run", dev, torch.int32, 1)
    _check(rtab, "rtab", torch.device("cpu"), torch.int64, ndev)
    _check(tgt, "tgt", torch.device("cpu"), torch.int64, 5)
    _check(cons, "cons", dev, torch.int64, cons_words(ndev))
    if (not 1 <= ndev <= MAX_SHARDS or rtab.dim() != 2 or rtab.shape[0] != ndev
            or rtab.shape[1] not in (1, 3) or tgt.dim() != 2 or tgt.shape[1] != 5
            or tgt.shape[0] > ndev or ndev * cap > 2**31 - 1):
        raise ValueError(f"consensus: {ndev} shards (at most {MAX_SHARDS}), exchange cap {cap}, "
                         f"reports {tuple(rtab.shape)}, targets {tuple(tgt.shape)}")
    (launch or _kernels.launch)(
        "consensus", rtab.data_ptr(), rtab.shape[1], ndev, int(cap), int(ragged),
        int(layout == "unpacked"), nb, f0, ccar, run.data_ptr(), tgt.data_ptr(), tgt.shape[0],
        cons.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)


def report_table(reports) -> torch.Tensor:
    """``consensus_cuda``'s reports, in host memory: the rows of gathered
    reports (``gather_reports``'s tensor, or a sequence of report rows), one
    address a shard, or (counters, state, route out) where they lie, three
    addresses a shard; on any card of the process (peers)."""
    rows = list(reports) if not isinstance(reports, torch.Tensor) else list(reports.unbind(0))
    if all(isinstance(r, torch.Tensor) for r in rows):
        for r in rows:
            _check(r, "report", r.device, torch.int64, R_ROUTE + len(rows) + 3)
        return torch.tensor([[r.data_ptr()] for r in rows], dtype=torch.int64)
    for ctr, state, out in rows:
        _check(ctr, "counters", ctr.device, torch.int64, 7)
        _check(state, "state", ctr.device, torch.int64, 7)
        _check(out, "route_out", ctr.device, torch.int32, len(rows) + 3)
    return torch.tensor([[c.data_ptr(), s.data_ptr(), o.data_ptr()] for c, s, o in rows],
                        dtype=torch.int64)


def target_table(targets: Sequence[tuple], dev) -> torch.Tensor:
    """``consensus_cuda``'s targets, whose tensors lie on ``dev``: (counters,
    state, received count, insert flag, shard index) a row, the tensors as
    addresses, in host memory (the launch's parameters carry them)."""
    dev = targets[0][0].device if torch.device(dev).index is None else dev
    for ctr, state, recv, go, _ in targets:
        _check(ctr, "counters", dev, torch.int64, 7)
        _check(state, "state", dev, torch.int64, 7)
        _check(recv, "recv", dev, torch.int32, 1)
        _check(go, "go", dev, torch.int32, 1)
    return torch.tensor([[c.data_ptr(), s.data_ptr(), r.data_ptr(), g.data_ptr(), me]
                         for c, s, r, g, me in targets], dtype=torch.int64)


# the widest wire row the exchange kernel copies (kMaxRowWords of
# csrc/shard_loop.cu): a wire row is a pending entry, at most W + 5 = 13 words
EXCHANGE_ROW_WORDS = 16


def exchange_table(wires: Sequence, pends: Sequence[torch.Tensor],
                   flags: Sequence[torch.Tensor], recv_me: Sequence[int]) -> torch.Tensor:
    """``exchange_cuda``'s address table, in host memory (the launch's
    parameters carry it): every sender's wire, then each receiver's pending
    list, insert flag and shard index, three words a receiver, as
    ``exchange_plain`` takes them.  The receivers' buffers lie on one card,
    the wires on it or on its peers, all int32 rows of one width; a wire
    of another process is the int address of its mapping into this one
    (``ProcessMesh.map_peers``, which checked that every rank's wire has
    this rank's shape and type)."""
    dev = pends[0].device if pends else wires[0].device
    local = [w for w in wires if isinstance(w, torch.Tensor)]
    pw = local[0].shape[1]
    for t, name, where in ([(w, "wire", w.device if w.is_cuda else dev) for w in local]
                           + [(p, "pend", dev) for p in pends]):
        _check(t, name, where, torch.int32, pw)
        if t.dim() != 2 or t.shape[1] != pw:
            raise ValueError(f"exchange: {name} of shape {tuple(t.shape)}, need (rows, {pw})")
    for flag in flags:
        _check(flag, "flag", dev, torch.int32, 1)
    if not len(pends) == len(flags) == len(recv_me) or not all(
            0 <= me < len(wires) for me in recv_me) or not all(
            isinstance(w, torch.Tensor) or int(w) > 0 for w in wires):
        raise ValueError(f"exchange: receivers {list(recv_me)} of {len(wires)} shards, wires "
                         f"{[w if isinstance(w, int) else 'tensor' for w in wires]}")
    return torch.tensor([w.data_ptr() if isinstance(w, torch.Tensor) else int(w) for w in wires]
                        + [v for p, f, me in zip(pends, flags, recv_me)
                           for v in (p.data_ptr(), f.data_ptr(), int(me))], dtype=torch.int64)


def exchange_cuda(cons: torch.Tensor, ndev: int, cap: int, ragged: bool, R: int, pw: int,
                  xtab: torch.Tensor, launch=None, received: bool = False) -> None:
    """``exchange`` (csrc/shard_loop.cu) on the card: ``exchange_plain``
    with the senders' wires (with ``received``, the receiver's buffer of
    received blocks, named once a sender) and the receivers' pending
    lists, flags and indices as ``xtab`` (``exchange_table``, in host
    memory: the C entry copies it into the launch's parameters);
    ``launch`` as ``_tri_partial_cuda``'s."""
    dev = cons.device
    _check(cons, "cons", dev, torch.int64, cons_words(ndev))
    _check(xtab, "xtab", torch.device("cpu"), torch.int64, ndev)
    n = (xtab.numel() - ndev) // 3
    if (not 1 <= n <= ndev <= MAX_SHARDS or xtab.numel() != ndev + 3 * n or R < 0
            or not 1 <= pw <= EXCHANGE_ROW_WORDS or (ragged and received)):
        raise ValueError(f"exchange: {n} receivers of {ndev} shards ({xtab.numel()} table "
                         f"words), R {R}, {pw} words a row, ragged {ragged}, received "
                         f"{received}")
    (launch or _kernels.launch)(
        "exchange", cons.data_ptr(), ndev, int(cap), int(ragged), int(received), int(R),
        int(pw), xtab.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)


def walk_advance_cuda(wtab: torch.Tensor, hops: int, n: int, params: torch.Tensor,
                      masks: torch.Tensor, wst: torch.Tensor, wrun: torch.Tensor) -> None:
    """``walk_advance`` (csrc/shard_loop.cu) on the card of ``params``:
    ``walk_advance_plain`` with the shards' runs as ``wtab``
    (``run_table``, in host memory: the C entry copies it into the
    launch's parameters)."""
    dev = params.device
    _check(wtab, "wtab", torch.device("cpu"), torch.int64, 1)
    for t, name, numel in ((params, "params", 2 * n), (masks, "masks", hops),
                           (wst, "wst", 2), (wrun, "wrun", 1)):
        _check(t, name, dev, torch.int32, numel)
    if wtab.dim() != 1 or not 1 <= wtab.numel() <= MAX_SHARDS or not 1 <= hops <= 32:
        raise ValueError(f"walk_advance: {wtab.numel()} runs, {hops} hops, N = {n}")
    _kernels.launch("walk_advance", wtab.data_ptr(), wtab.numel(), hops, n, params.data_ptr(),
                    masks.data_ptr(), masks.numel(), wst.data_ptr(), wrun.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)


def run_table(wout, hops: int, n: int) -> torch.Tensor:
    """``walk_advance_cuda``'s runs: one address a shard, in host memory,
    of its run (hops + N + 1 int32, a row of one buffer or a tensor of its
    own, on any card of the process)."""
    rows = list(wout) if not isinstance(wout, torch.Tensor) else list(wout.unbind(0))
    for r in rows:
        _check(r, "run", r.device, torch.int32, hops + n + 1)
    return torch.tensor([r.data_ptr() for r in rows], dtype=torch.int64)


def copy_table(rows: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """The host table of ``copies``' device-to-device copies: (destination,
    source, bytes) a row, contiguous tensors of equal bytes on any cards of
    the process."""
    for dst, src in rows:
        nbytes = dst.numel() * dst.element_size()
        if (not dst.is_contiguous() or not src.is_contiguous()
                or nbytes != src.numel() * src.element_size()):
            raise ValueError(f"copy: {tuple(src.shape)} {src.dtype} into {tuple(dst.shape)} "
                             f"{dst.dtype}")
    return torch.tensor([[d.data_ptr(), s.data_ptr(), d.numel() * d.element_size()]
                         for d, s in rows], dtype=torch.int64).reshape(-1, 3)


def copies(rows: Sequence[Tuple[torch.Tensor, torch.Tensor]], tab: Optional[torch.Tensor],
           stream=None) -> None:
    """The copies (destination, source) of a gather of the several-card
    step: on the card one ``copy_table`` call (``tab``, its table) on
    ``stream`` (default: the current one of the first destination's card),
    captured into a graph as copy nodes; CPU tensors by ``copy_``."""
    if not rows:
        return
    if rows[0][0].is_cuda:
        stream = stream or torch.cuda.current_stream(rows[0][0].device)
        _kernels.call("copy_table", tab.data_ptr(), len(rows), stream.cuda_stream)
        return
    for dst, src in rows:
        dst.copy_(src)


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


def _report_views(blk: torch.Tensor, ndev: int):
    """(counters, step state, int32 route out) of a shard's block."""
    ctr = blk[:N_COUNTERS]
    state = blk[N_COUNTERS:N_COUNTERS + STATE_WORDS]
    out = blk[N_COUNTERS + STATE_WORDS:].view(torch.int32)[:ndev + 3]
    return ctr, state, out


class _Launcher:
    """Launches of a shard's (or a card's) kernels: ``go(key, call)`` runs
    ``call(launch)``, the kernel's wrapper (its checks and C arguments),
    with ``launch`` in place of ``_kernels.launch``.  Under the chunked
    driver (a mesh of one device, where every buffer a step passes is the
    run's) the C arguments are bound once (``_kernels.bind``) for each
    ``key`` (the caller's, with the ring parity and any per-call buffer's
    address) and stream, and later calls launch the bound entry alone,
    with no check and no conversion: the captures of the step's graphs
    run the step's host code once each.  Under the host driver every call
    runs the wrapper."""

    def __init__(self, dev: torch.device, once: bool):
        self.dev, self.once = dev, once
        self.bound: Dict[tuple, object] = {}

    def go(self, key, call) -> None:
        if not self.once:
            call(_kernels.launch)
            return
        k = (key, torch.cuda.current_stream(self.dev).cuda_stream)
        bound = self.bound.get(k)
        if bound is not None:
            bound()
            return

        def first(*args):
            self.bound[k] = _kernels.bind(*args)
            self.bound[k]()

        call(first)


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
    unpacked.  ``run`` is the flag of the shards of its device: every
    phase but the insert does nothing while it reads 0 (the kernels return
    at once, the plain versions are not called); the insert runs under the
    shard's own flag ``go``, which the consensus sets."""

    def __init__(self, eng: "ShardedFrontierSearch", me: int, device: torch.device,
                 st: _Static, card: "_Card"):
        self.me, self.dev, self.st, self.run = me, device, st, card.run
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
        # the counters, step state and route out in one block (the report's
        # words), and its snapshot, the report that the consensus of every
        # card of a several-card mesh reads (the shard's own card rewrites
        # the live words meanwhile)
        self.blk = torch.zeros(N_COUNTERS + STATE_WORDS + (ndev + 4) // 2, dtype=torch.int64,
                               device=device)
        self.ctr, self.state, self.route_out = _report_views(self.blk, ndev)
        self.ctr.copy_(torch.as_tensor(fresh_counters()))
        self.snap = torch.zeros_like(self.blk)
        self.fill = [ndev, *_FILL_TAIL] if layout == "sig" else keyrow_fill(st, layout, ndev)
        self.pw = 3 if layout == "sig" else pend_words(st, layout)  # a wire row's words
        row = torch.tensor([self.fill], **i32)
        self.rings = [row.repeat(self.ccar, 1), row.repeat(self.ccar, 1)]
        self.cur = 0
        # each ring's live length (its rows from it on are the empty row),
        # and the route's counts and migrants of a step from each ring, the
        # other zeroed by the step's count (csrc/route_pack.cu)
        self.ring_len = torch.zeros(2, **i32)
        self.tally = torch.zeros((2, ndev + 1), **i32)
        self.go = torch.zeros(1, **i32)    # the insert's flag (the consensus sets it)
        self.recv = torch.zeros(1, **i32)  # rows received this step (the consensus)
        self.wire = torch.zeros((max(self.R, L + self.ccar), self.pw), **i32)
        self.cubes = self.tri = None
        if eng.cubes_split:
            T_loc = -(-st.T3 // ndev)
            lo, hi = min(me * T_loc, st.T3), min((me + 1) * T_loc, st.T3)
            self.tri = st.d_tri_xyz[lo:hi].to(device, torch.int32).contiguous()
            self.cubes = eng.cube_stack[lo:hi].to(device, copy=True)
            if eng.card_form:  # rows of the card's buffers
                self.coords_out, self.part = card.coords[me], card.parts[me]
            else:
                self.coords_out = torch.zeros((B, st.n), **i32)
                self.part = torch.zeros((ndev * B, M + 1), **i32)
        if self.cuda:
            from ..search import step as S

            self.S = S
            # the empty row where no lane writes (as the plain expand leaves it)
            self.cand = row.repeat(L, 1)
            self.seg = 1 << max(1, (L + self.ccar - 1).bit_length())
            self.keys = torch.empty(2 * ndev * self.seg, dtype=torch.int64, device=device)
            bufs = S.StepBuffers.select_only(st, device)
            bufs.state = self.state
            # the select's scratch is the shard's own (select_only shares it
            # between the tables of one statics)
            bufs.sel = torch.empty((B, 2), **i32)
            bufs.partial = torch.empty((S.K3_MAX_BLOCKS, 2), dtype=torch.int64, device=device)
            bufs.ticket = torch.zeros(1, **i32)
            bufs.run = self.run
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
            self.pend = bufs.pend
            self._go = _Launcher(device, eng.driver == "chunked").go
        else:
            self.pend = torch.zeros((self.R + L, self.pw), **i32)

    @property
    def ring(self) -> torch.Tensor:
        return self.rings[self.cur]

    def snapshot(self) -> tuple:
        """The snapshot's (counters, state, route out), as the consensus
        reads a report."""
        return _report_views(self.snap, len(self.route_out) - 3)

    def _live(self) -> bool:
        """A CPU shard's run flag (a card's is read on the card)."""
        return bool(int(self.run[0]))

    # 1. select
    @_on_device
    def select(self) -> None:
        st, tab = self.st, self.tab
        if self.cuda:
            if self.layout == "unpacked":
                self._go("select", lambda launch: self.S.select_open_cuda(
                    st, tab.t_state, tab.t_fpar, self.ctr[0], self.ctr[7], run=self.run,
                    bufs=self.bufs, launch=launch))
            else:
                self._go("select", lambda launch: self.S.select_best_cuda(
                    st, tab.t_best, tab.t_closed, self.ctr[0], self.ctr[7], run=self.run,
                    bufs=self.bufs, launch=launch))
            return
        if not self._live():
            return
        if self.layout == "unpacked":
            out = _select_open_plain(st, tab.t_state, tab.t_fpar, self.ctr[0], self.ctr[7])
        else:
            out = _select_best_plain(st, tab.t_best, tab.t_closed, self.ctr[0], self.ctr[7])
        slots, vmin, active, fmin, n_open, n_sel, reopen = out
        self.sel = torch.stack([slots[active], vmin[active]], dim=1).to(torch.int32)
        self.n_sel = int(n_sel)
        # K3 writes its five slots and zeroes the rest
        self.state.zero_()
        self.state[:5] = torch.tensor([0, int(n_open), self.n_sel, int(reopen), int(fmin)])

    # 2. the coordinates K12 gathers (sig and packed), and K12
    @_on_device
    def coords(self) -> torch.Tensor:
        st, out = self.st, self.coords_out
        if self.cuda:
            self._go("coords", self._coords_args)
        elif self._live():
            if self.layout == "sig":
                out.copy_(sig_coords_plain(st, self.tab.t_sig, self.sel, self.n_sel, st.B))
            else:
                out.copy_(keyrow_coords_plain(st, self.tab.t_key, self.sel, self.n_sel, st.B))
        return out

    def _coords_args(self, launch) -> None:
        st = self.st
        nsel = self.bufs.state[self.S.STATE_NSEL].data_ptr()
        stream = torch.cuda.current_stream(self.dev).cuda_stream
        if self.layout == "sig":
            launch("sig_coords", self.tab.t_sig.data_ptr(), self.bufs.sel.data_ptr(), nsel,
                   self.bitw.data_ptr(), st.n, st.bbits, st.B, self.coords_out.data_ptr(),
                   self.run.data_ptr(), stream)
        else:
            launch("keyrow_coords", self.tab.t_key.data_ptr(), self.tab.t_key.shape[1],
                   self.bufs.sel.data_ptr(), nsel, st.n, st.B, self.coords_out.data_ptr(),
                   self.run.data_ptr(), stream)

    @_on_device
    def partial(self, coords_g: torch.Tensor) -> torch.Tensor:
        st = self.st
        if self.cuda:
            tri = self.tri if self.tri.numel() else None
            self._go(("partial", coords_g.data_ptr()), lambda launch: _tri_partial_cuda(
                coords_g, self.cubes, tri, st.n, st.S, out=self.part, run=self.run,
                launch=launch))
            return self.part
        if self._live():
            self.part.copy_(tri_partial_plain(coords_g, self.cubes, self.tri, st.M, st.S))
        return self.part

    # 3. expand
    @_on_device
    def expand(self, eng: "ShardedFrontierSearch", h3: Optional[torch.Tensor]) -> None:
        st = self.st
        if self.cuda:
            key = ("expand", None if h3 is None else h3.data_ptr())
            if self.layout == "sig":
                # the coordinates sig_coords wrote this step, where it runs
                coords = self.coords_out if eng.cubes_split else None
                self._go(key, lambda launch: self.S.expand_sharded_cuda(
                    st, self.tab, self.bufs, self.ctr, eng.ub, h3, self.cand, self.R,
                    eng.hash_params, eng.ndev, self.me, launch=launch, coords=coords))
            else:
                self._go(key, lambda launch: self.S.expand_keyrow_sharded_cuda(
                    st, self.tab, self.bufs, self.ctr, eng.ub, h3, self.cand, self.R,
                    eng.hash_params, eng.ndev, self.me, self.tag_base, launch=launch))
            return
        if not self._live():
            return
        if self.layout == "sig":
            goal, self.cand, pending, lanes = expand_sharded_plain(
                st, self.tab, self.sel, self.n_sel, eng.ub, h3, eng.own, eng.ndev, self.me)
        else:
            goal, self.cand, pending, lanes = expand_keyrow_sharded_plain(
                st, self.tab, self.layout, self.sel, self.n_sel, eng.ub, h3, eng.own, eng.ndev,
                self.me, self.tag_base)
        # the self-owned pending lanes after the received region, as K4 and
        # K9 append them
        n = pending.shape[0]
        self.pend[self.R:self.R + n] = pending
        self.state[STATE_NVALID], self.state[STATE_NPEND] = lanes, n
        self.ctr[0] = min(int(self.ctr[0]), goal)

    # 4. the route's two passes
    def _route_args(self):
        """The row width, key words and empty fsort of key-row routes."""
        return len(self.fill), self.st.W, self.fill[1]

    @_on_device
    def count(self, eng) -> torch.Tensor:
        """The first pass: this step's send counts (the view the gathers
        read) and migrants into ``tally[cur]``, the other zeroed."""
        ndev, cur = eng.ndev, self.cur
        if self.cuda:
            self._go(("count", cur), lambda launch: self._count_args(eng, launch))
        elif self._live():
            self._route = route_plain(self.cand, self.n_sel * self.st.M, self.ring, ndev,
                                      self.me, eng.exchange_cap, fill=self.fill)
            self.route_out.copy_(self._route[2])
            self.tally[1 - cur] = 0
            self.tally[cur] = self._route[2][:ndev + 1]
        return self.tally[cur, :ndev]

    def _count_args(self, eng, launch) -> None:
        nsel = self.bufs.state[self.S.STATE_NSEL].data_ptr()
        stream = torch.cuda.current_stream(self.dev).cuda_stream
        cur = self.cur
        head = (self.cand.data_ptr(), self.ring.data_ptr(), self.ring_len[cur].data_ptr(), nsel,
                self.st.M, self.cand.shape[0], self.ccar, eng.ndev, self.seg)
        tail = (self.tally[cur].data_ptr(), self.tally[1 - cur].data_ptr(),
                self.route_out.data_ptr(), self.keys.data_ptr(), self.run.data_ptr(), stream)
        if self.layout == "sig":
            launch("route_count", *head, *tail)
        else:
            launch("route_count_rows", *head, *self._route_args(), *tail)

    @_on_device
    def pack(self, eng, S_all: Optional[torch.Tensor]) -> None:
        """The second pass into the other ring and its live length,
        ``cur`` flipped.  A card's shard flips it on the host at every call
        (the chunked driver sets it after a chunk's replays, from the steps
        that ran)."""
        nxt = 1 - self.cur
        if self.cuda:
            S_ptr = None if S_all is None else S_all.data_ptr()

            def args(launch):
                nsel = self.bufs.state[self.S.STATE_NSEL]
                head = (self.cand.data_ptr(), self.ring.data_ptr(), nsel.data_ptr(), self.st.M,
                        self.ccar, eng.ndev, self.me, eng.exchange_cap, S_ptr, self.seg)
                outs = (self.tally[self.cur].data_ptr(), self.route_out.data_ptr(),
                        self.keys.data_ptr(), self.wire.data_ptr(), self.rings[nxt].data_ptr(),
                        self.ring_len[nxt].data_ptr(), self.run.data_ptr(),
                        torch.cuda.current_stream(self.dev).cuda_stream)
                if self.layout == "sig":
                    launch("route_pack", *head, *outs)
                else:
                    launch("route_pack_rows", *head, *self._route_args(), *outs)

            self._go(("pack", self.cur, S_ptr), args)
        else:
            if not self._live():
                return
            if S_all is not None:  # the ragged allowance
                self._route = route_plain(self.cand, self.n_sel * self.st.M, self.ring,
                                          eng.ndev, self.me, eng.exchange_cap, S_all, self.fill)
            wire, self.rings[nxt], out = self._route
            # into the shard's own wire, which the exchange reads by its
            # binding (``_Card.wires``), as a card's
            self.wire[:wire.shape[0]] = wire
            self.wire[wire.shape[0]:] = 0
            self.route_out.copy_(out)
            self.ring_len[nxt] = int((self.rings[nxt][:, 0] < eng.ndev).sum())
        self.cur = nxt

    # 5. the insert of the received rows (the exchange put them before row
    # R of the pending list) and the self-owned lanes, under the flag the
    # consensus set, with its goal, f-min and rows selected in the state
    @_on_device
    def insert(self, eng) -> None:
        st = self.st
        if self.cuda:
            insert = (self.S.probe_pending_cuda if self.layout == "sig"
                      else self.S.insert_pending_cuda)
            self._go("insert", lambda launch: insert(st, self.tab, self.bufs, self.ctr, eng.fill,
                                                     self.R, self.recv, run=self.go,
                                                     launch=launch))
            return
        if not int(self.go[0]):
            return
        c, s = self.ctr, self.state
        n_recv = int(self.recv[0])
        rows = self.pend[self.R - n_recv: self.R - n_recv + int(s[STATE_NPEND])]
        if self.layout == "sig":
            rows = rows.long()
            ovf, _, _ = _insert_sig(st, self.tab, rows[:, 0], rows[:, 1], rows[:, 2])
            c[1], c[2] = s[STATE_FMIN], c[2] + 1
            c[6] += int(ovf)
            c[7] = _adapt_thr(c[7], s[STATE_NSEL], eng.fill)
        else:
            ovf, reopen, rounds, un, tail = insert_pending_plain(st, self.tab, self.layout, rows,
                                                                 n_recv)
            state = [0, int(s[1]), int(s[STATE_NSEL]), int(s[3]) + reopen, int(s[STATE_FMIN])]
            finish_plain(c, state, eng.fill, int(s[STATE_NVALID]), ovf, rounds, un, tail)
        # the flag the kernels' finish writes (csrc/step_state.cuh)
        self.go.fill_(int(int(c[1]) < int(c[0]) and int(c[6]) == 0))

    @_on_device
    def walk_hops(self, coord, hops: int, out: Optional[torch.Tensor] = None,
                  run: Optional[torch.Tensor] = None) -> torch.Tensor:
        """K7's hop mode from ``coord`` (N ints, or the walk loop's params
        on this device) into ``out``, nothing while ``run`` reads 0."""
        if self.cuda:
            return self.S.walk_hops_cuda(self.st, self.tab, coord, hops, self.layout, out=out,
                                         run=run)
        if run is not None and not int(run[0]):
            return out
        if isinstance(coord, torch.Tensor):
            coord = coord[: self.st.n].tolist()
        res = walk_hops_plain(self.st, self.tab, coord, hops, self.layout)
        if out is None:
            return res
        return out.copy_(res)


class _Card:
    """This process's shards on one device and what their step shares
    there: the run flag, the consensus vector, in the card form of the
    step (every shard of the mesh in this process, ``card_form``) the
    buffers every shard of the mesh has its row of (the batch's
    coordinates, K12's partials, whose sums are each shard's h3, and the
    send counts), in the rank form (one shard a card, as a ProcessMesh's
    rank) the outputs of the mesh's collectives (the gathered coordinates,
    the shard's h3, the gathered send counts and reports, the received
    wire blocks), the targets of the consensus and the address tables of
    the consensus, the exchange and the walk (on a card), and the step's
    graphs (one a starting parity of the rings; kept on the first card).

    On a mesh of several cards (``multi``) each card runs its shards'
    phases on a stream of its own; the phases join through events between
    the cards' streams (``signal``, ``wait``): a card's rows of a gather
    are written before any card copies them in (``pulls``), and every card
    has packed and taken its shards' snapshots before any consensus reads
    them."""

    #: the events a card records, one a phase of the step and of the walk
    PHASES = ("coords", "parts", "counts", "packs", "runs", "join")

    def __init__(self, eng: "ShardedFrontierSearch", dev: torch.device, first: int,
                 multi: bool):
        self.dev, self.first, self.multi = dev, first, multi
        self.cuda = dev.type == "cuda"
        self.shards: List[_Shard] = []
        self.run = torch.ones(1, dtype=torch.int32, device=dev)
        ndev, st = eng.ndev, eng.statics[dev]
        self.cons = fresh_cons(ndev, dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.counts = torch.zeros((ndev, ndev), **i32)
        if eng.cubes_split:
            self.coords = torch.zeros((ndev, st.B, st.n), **i32)
            if eng.card_form:
                self.parts = torch.zeros((ndev, ndev * st.B, st.M + 1), **i32)
                self.h3 = torch.zeros((ndev, st.B, st.M + 1), **i32)
            else:
                self.h3 = torch.zeros((st.B, st.M + 1), **i32)
        self.recv = None  # the rank form's received wire blocks (dense)
        self.stream = self.events = None
        if multi and self.cuda:
            self.stream = torch.cuda.Stream(dev)
            self.events = {p: torch.cuda.Event() for p in self.PHASES}
        self.pulls: Dict[object, list] = {}
        self.tabs: Dict[str, torch.Tensor] = {}
        self.graphs: Dict[int, object] = {}
        self.warm = False
        self._go = _Launcher(dev, eng.driver == "chunked").go

    def bind(self, eng: "ShardedFrontierSearch", shards: List[_Shard]) -> None:
        """The gathers' copies and the address tables of this card's
        kernels (the buffers are the run's, so a graph may hold them).
        The other cards' events, not the cards: no reference cycle, so a
        finished run's graphs go with its engine, never in a collection
        during a later capture (which a graph's destruction would break)."""
        self.others = [c.events for c in eng.cards if c is not self]
        if not eng.card_form:
            self._bind_rank(eng)
            return
        st, ndev, B = eng.st, eng.ndev, eng.st.B
        mine = {sh.me for sh in self.shards}
        others = [sh for sh in shards if sh.me not in mine]
        pulls = self.pulls
        if eng.cubes_split:
            # the coordinates of every other shard, and the rows of each
            # other shard's partials that belong to this card's shards
            pulls["coords"] = [(self.coords[sh.me], sh.coords_out) for sh in others]
            pulls["parts"] = [(self.parts[sh.me, j * B:(j + 1) * B], sh.part[j * B:(j + 1) * B])
                              for sh in others for j in sorted(mine)]
        if self.multi:
            for p in (0, 1):  # the send counts of a step from ring p
                pulls["counts", p] = [(self.counts[sh.me], sh.tally[p, :ndev]) for sh in shards]
            pulls["snaps"] = [(sh.snap, sh.blk) for sh in self.shards]
            # every shard's snapshot, where it lies
            self.reports = [sh.snapshot() for sh in shards]
        else:  # one card: every report where it lies, read after every pack
            self.reports = [(sh.ctr, sh.state, sh.route_out) for sh in shards]
        self.wires = [sh.wire for sh in shards]
        if not self.cuda:
            return
        with torch.cuda.device(self.dev):
            self.tabs = {k: copy_table(v) for k, v in pulls.items()}
            self.rtab = report_table(self.reports)
            self.tgt = target_table(self.targets(), self.dev)
            self.xtab = exchange_table(self.wires, [sh.pend for sh in self.shards],
                                       [sh.go for sh in self.shards],
                                       [sh.me for sh in self.shards])

    def _bind_rank(self, eng: "ShardedFrontierSearch") -> None:
        """The rank form's buffers and tables: the gathered report blocks
        (each shard's counters, step state and route out, as its ``blk``
        holds them), read row by row by address; under the dense exchange
        the received wire blocks, sender i's at row i cap, named once a
        sender for the exchange kernel; under the ragged one every rank's
        wire where this process reads it (``eng.wires``: the mesh's
        ``map_peers``), none on a mesh that maps nothing (a ProcessMesh on
        the CPU: ``_exchange_host``)."""
        (sh,) = self.shards
        ndev = eng.ndev
        self.reps = torch.zeros((ndev, sh.blk.numel()), dtype=torch.int64, device=self.dev)
        self.reports = [_report_views(r, ndev) for r in self.reps]
        self.wires = eng.wires
        if eng.exchange == "dense":
            self.recv = torch.zeros((ndev * eng.exchange_cap, sh.pw), dtype=torch.int32,
                                    device=self.dev)
            self.wires = [self.recv] * ndev
        if not self.cuda:
            return
        with torch.cuda.device(self.dev):
            self.rtab = report_table(self.reports)
            self.tgt = target_table(self.targets(), self.dev)
            if self.wires is not None:
                self.xtab = exchange_table(self.wires, [sh.pend], [sh.go], [sh.me])

    def on(self):
        """The context of this card's phases: its device and, on a mesh
        of several cards, its stream."""
        ctx = contextlib.ExitStack()
        if self.cuda:
            ctx.enter_context(torch.cuda.device(self.dev))
            if self.stream is not None:
                ctx.enter_context(torch.cuda.stream(self.stream))
        return ctx

    def pull(self, name) -> None:
        """The copies of one gather (``pulls[name]``) into this card's
        buffers."""
        copies(self.pulls.get(name, ()), self.tabs.get(name))

    def signal(self, phase: str) -> None:
        """This card's phase is done (an event on its stream)."""
        if self.events is not None:
            self.events[phase].record(self.stream)

    def wait(self, phase: str) -> None:
        """This card's stream waits for every other card's ``phase``."""
        if self.events is not None:
            for events in self.others:
                self.stream.wait_event(events[phase])

    def targets(self) -> List[tuple]:
        """The consensus's targets: this card's shards' counters, state,
        received count, insert flag and index."""
        return [(sh.ctr, sh.state, sh.recv, sh.go, sh.me) for sh in self.shards]

    def consensus(self, eng: "ShardedFrontierSearch") -> None:
        """The consensus of every shard's report (``reports``: each where
        it lies, its snapshot, or its row of this rank's gathered
        reports)."""
        args = (eng.ndev, eng.exchange_cap, eng.exchange == "ragged", eng.layout, eng.st.nb,
                eng.st.f0, self.shards[0].ccar, self.run)
        if self.cuda:
            with torch.cuda.device(self.dev):
                self._go("consensus", lambda launch: consensus_cuda(
                    self.rtab, *args, self.tgt, self.cons, launch=launch))
        else:
            consensus_plain(self.reports, *args, self.targets(), self.cons)

    def exchange(self, eng: "ShardedFrontierSearch", shards: List[_Shard]) -> None:
        """The wire rows of every shard into this card's receivers, sized on
        the device: read from the senders' wires (``wires``: the card form,
        and the rank form's ragged exchange, where they lie or mapped into
        this process), or from this rank's received blocks (``recv``, the
        rank form's dense exchange)."""
        sh0 = shards[0]
        args = (eng.ndev, eng.exchange_cap, eng.exchange == "ragged", sh0.R)
        received = self.recv is not None
        if self.cuda:
            with torch.cuda.device(self.dev):
                self._go("exchange", lambda launch: exchange_cuda(
                    self.cons, *args, sh0.pw, self.xtab, launch=launch, received=received))
        else:
            exchange_plain(self.cons, *args, self.wires, [sh.pend for sh in self.shards],
                           [sh.go for sh in self.shards], [sh.me for sh in self.shards],
                           received=received)


def _card_groups(devices: Sequence[torch.device]) -> List[List[int]]:
    """The local shards grouped into ``_Card``s: the positions in
    ``devices`` (a local shard's device each) of the shards of each device,
    the devices in order of first appearance.  Tests and ``chip_smoke.py``
    replace it to split the shards of one device into several cards, and
    so run the several-card step on the CPU and on one card."""
    groups: Dict[torch.device, List[int]] = {}
    for k, d in enumerate(devices):
        groups.setdefault(d, []).append(k)
    return list(groups.values())


def peer_mesh(devices: Sequence[torch.device]) -> bool:
    """Whether the several-card step can run on ``devices``: one device
    (or the CPU), or cards that all reach each other as peers."""
    distinct = sorted(set(devices), key=str)
    if len(distinct) == 1:
        return True
    if any(d.type != "cuda" for d in distinct):
        return False
    idx = [d.index for d in distinct]
    return all(torch.cuda.can_device_access_peer(a, b) for a in idx for b in idx if a != b)


def _rank_form(mesh) -> bool:
    """Whether ``mesh`` runs the step's rank form under either driver: one
    shard a rank, the mesh's fixed-shape collectives between the phases
    (the form of a ProcessMesh, where NCCL's calls are captured into each
    rank's step graph).  Tests and ``chip_smoke.py`` replace it to run a
    LocalMesh so (its collectives are copies), the very step graph a
    ProcessMesh runs, on the CPU and on one card."""
    return isinstance(mesh, ProcessMesh)


def auto_exchange(devices: Sequence[torch.device]) -> str:
    """``exchange="auto"`` on shards on ``devices`` (JAX's rule,
    ``ShardedFrontierSearch.__init__`` :1072-1082): ragged when every shard
    lies on a card, else dense."""
    return "ragged" if all(torch.device(d).type == "cuda" for d in devices) else "dense"


def maps_peers(mesh) -> bool:
    """Whether each rank of ``mesh``'s rank form can read every sender's
    wire by address (``map_peers``), as its ragged exchange does: a
    ProcessMesh of cards (CUDA IPC), a LocalMesh whose devices are one
    device or cards that are each other's peers (``peer_mesh``).  A
    ProcessMesh on the CPU maps nothing."""
    if isinstance(mesh, ProcessMesh):
        return mesh.devices[0].type == "cuda"
    return peer_mesh(mesh.devices)


def choose_driver(mesh, driver: str, exchange: str = "auto") -> str:
    """The step loop's driver on ``mesh`` for ``driver``: "chunked" (one
    step of the whole mesh a graph, one host read a chunk) on a LocalMesh
    of one device or of cards that are each other's peers, and in the
    rank form (``_rank_form``: a ProcessMesh) under the dense exchange or
    where the ranks map their peers' wires for the ragged one
    (``maps_peers``); "host" (one host read a step) on a LocalMesh over
    cards without peer access and on a ProcessMesh on the CPU with the
    ragged exchange, sized there on the host; "auto" picks chunked where it
    runs.  ``exchange`` "auto" is ``auto_exchange``'s.  An explicit chunked
    where it cannot run raises ValueError: it never falls back."""
    if driver not in ("auto", "chunked", "host"):
        raise ValueError(f"driver={driver!r}: choose auto, chunked or host")
    if exchange == "auto":
        exchange = auto_exchange(mesh.devices)
    if _rank_form(mesh):
        ok, why = exchange != "ragged" or maps_peers(mesh), (
            "the ragged exchange of a ProcessMesh's chunked step reads every rank's wire by "
            "address, and a ProcessMesh on the CPU maps no peer's wire: its ragged exchange "
            "takes its split sizes from the host")
    else:
        ok, why = peer_mesh(mesh.devices), ("it needs a LocalMesh of one device or of cards "
                                            "with peer access, and these cards have no peer "
                                            "access to each other")
    if driver == "chunked" and not ok:
        raise ValueError(f"driver='chunked' cannot run here: {why}; use driver='host'")
    return driver if driver != "auto" else ("chunked" if ok else "host")


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
    when it runs, as JAX does.

    ``driver`` (as ``FrontierSearch``'s): "chunked" runs ``chunk_steps``
    steps of the whole mesh a host read, as JAX's sharded chunk (on cards
    ``chunk_steps`` replays of a one-step CUDA graph of every card, one
    graph for each ring parity; on a ProcessMesh each rank replays its own,
    the mesh's NCCL collectives captured in it, its ragged exchange
    reading the other ranks' wires through CUDA IPC mappings; CPU shards
    the same steps with the plain versions), and the walk WALK_ROUNDS
    rounds a host read; "host" one step a host read, launched eagerly, and
    one host read a walk round; "auto" is chunked on a ``LocalMesh`` of
    one device (or the CPU) or of cards that are each other's peers and on
    a ProcessMesh, but host on a ProcessMesh on the CPU with the ragged
    exchange (``choose_driver``).  ``exchange="auto"`` is ragged when
    every shard lies on a card, else dense, as JAX's.  chunked where it
    cannot run raises ValueError: it never falls back to the host
    driver."""

    def __init__(self, problem: Problem, heuristic: Optional[HPairHeuristic] = None,
                 devices=None, hash_type: str = "FSUM", hash_shift: int = 4,
                 batch: Optional[int] = None, capacity: Optional[int] = None,
                 max_steps: int = 500_000, chunk_steps: int = 256,
                 layout: str = "auto", exchange_cap: Optional[int] = None,
                 shard_cubes="auto", exchange: str = "auto",
                 fill_target: Optional[int] = None, driver: str = "auto"):
        if fill_target is not None and fill_target < 1:
            raise ValueError("fill_target must be >= 1")
        if exchange not in ("auto", "ragged", "dense"):
            raise ValueError(f"unknown exchange mode {exchange!r}")
        if layout not in ("auto", "sig", "packed", "unpacked"):
            raise ValueError(f"layout={layout!r}: choose auto, sig, packed or unpacked")
        if chunk_steps < 1:
            raise ValueError("chunk_steps must be >= 1")
        self.fill_target = fill_target
        self.layout_pref = layout
        self.problem = problem
        if isinstance(devices, (LocalMesh, ProcessMesh)):
            self.mesh = devices
        else:
            self.mesh = LocalMesh(_devices_of(devices))
        self.ndev = self.mesh.ndev
        if self.ndev > MAX_SHARDS:
            raise ValueError(f"{self.ndev} shards: the sharded loop takes at most {MAX_SHARDS}")
        self.multiprocess = self.mesh.multiprocess
        self.local_devices = [self.mesh.devices[i if isinstance(self.mesh, LocalMesh) else 0]
                              for i in self.mesh.local]
        if exchange == "auto":
            exchange = auto_exchange(self.local_devices)
        self.exchange = exchange
        self.driver = choose_driver(self.mesh, driver, exchange)
        # set by each run's _shards: the step's card form (every shard of
        # the mesh in this process, read and written through addresses),
        # and in the rank form under the ragged exchange every rank's wire
        # where this process reads it (None where the mesh maps nothing)
        self.card_form = False
        self.wires: Optional[list] = None
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
        """This process's shards, grouped into ``_Card``s (``_card_groups``),
        each holding its card's run flag, and their cards in ``self.cards``.
        The step takes its card form (``card_form``) on a LocalMesh under
        the chunked driver and on one card: every shard of the mesh in this
        process, each card reading its peers' buffers by address (peer
        access enabled first); else its rank form (``_step_ranks``), one
        shard a card: on a ProcessMesh, and on a LocalMesh under the host
        driver over several cards (or where ``_rank_form`` says so).  The
        rank form's ragged exchange reads every rank's wire where this
        process reads it (``wires``, the mesh's ``map_peers``, before the
        cards bind their tables; ``_run_once`` closes the mappings)."""
        self.cube_stack = None
        if self.cubes_split:
            st = self.st
            self.cube_stack = st.d_cubes.view(st.T3, st.S, st.S, st.S)
        groups = _card_groups(self.local_devices)
        self.card_form = not _rank_form(self.mesh) and (
            self.driver == "chunked" or len(groups) == 1)
        if not self.card_form:
            groups = [[k] for k in range(len(self.local_devices))]
            if self.driver == "chunked" and len(set(self.local_devices)) > 1:
                raise ValueError("the chunked rank form of a LocalMesh captures its step on "
                                 "one device")
        devs = [self.local_devices[g[0]] for g in groups]
        if any(self.local_devices[k] != d for g, d in zip(groups, devs) for k in g):
            raise ValueError(f"a card's shards on several devices: {groups}")
        multi = self.card_form and len(groups) > 1
        mapped = (not self.card_form and self.exchange == "ragged"
                  and maps_peers(self.mesh))
        if (multi or mapped) and devs[0].type == "cuda" and len(set(devs)) > 1:
            _kernels.enable_peer_access(devs)
        self.cards = [_Card(self, d, g[0], multi) for g, d in zip(groups, devs)]
        shards: List[Optional[_Shard]] = [None] * len(self.local_devices)
        for card, g in zip(self.cards, groups):
            for k in g:
                shards[k] = _Shard(self, self.mesh.local[k], card.dev, self.statics[card.dev],
                                   card)
                card.shards.append(shards[k])
        if self.cubes_split:  # each shard holds its own cubes now
            for st in self.statics.values():
                st.d_cubes = torch.zeros(0, dtype=torch.int32, device=st.device)
            self.cube_stack = None
        self._ev_fork = torch.cuda.Event() if multi and devs[0].type == "cuda" else None
        self.wires = self.mesh.map_peers([sh.wire for sh in shards]) if mapped else None
        for card in self.cards:
            card.bind(self, shards)
        # the chunk's one read: the vector and each local shard's overflow
        c0 = self.cards[0]
        cw = cons_words(self.ndev)
        c0.readout = torch.zeros(cw + self.ndev, dtype=torch.int64, device=c0.dev)
        c0.pulls["read"] = [(c0.readout[:cw], c0.cons)] + [
            (c0.readout[cw + sh.me:cw + sh.me + 1], sh.ctr[6:7]) for sh in shards]
        if c0.cuda:
            c0.tabs["read"] = copy_table(c0.pulls["read"])
        self.shards = shards  # kept after the run: its tables, rings and counters
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
        try:
            return self._search_and_walk(shards)
        finally:
            if self.wires is not None:
                self.mesh.unmap_peers()

    def _search_and_walk(self, shards: List[_Shard]) -> ShardedSearchResult:
        """The search and the walk on this run's shards, and the result."""
        st, mesh, ndev = self.st, self.mesh, self.ndev
        stats = dict(driver=self.driver, exchange=self.exchange, cap=self.exchange_cap,
                     cards=len(self.cards), card_form=self.card_form, graph_captures=0,
                     graph_replays=0, capture_s=0.0)
        t0 = time.perf_counter()
        if self.driver == "chunked":
            c, ovf, reads = self._search_chunked(shards, stats)
        else:
            c, ovf, reads = self._search_host(shards)
        if not self.card_form:
            self._check_agreement()
        # the last step's insert may have overflowed a table
        table_ovf = int(c[C_TOVF]) or int(sum(int(v) > 0 for v in ovf))
        carry_ovf = int(c[C_COVF])
        if self.multiprocess:
            t = torch.tensor([table_ovf], dtype=torch.int64, device=shards[0].dev)
            table_ovf = int(mesh.all_sum([t])[0])
        steps, goal_g, fmin_g = int(c[C_STEPS]), int(c[C_GOAL]), int(c[C_FMIN])
        stats.update(steps=steps, host_reads=reads, wire_rows=int(c[C_WIRE]),
                     migrated=int(c[C_MIGR]), peak_carry=int(c[C_PEAK]),
                     search_s=time.perf_counter() - t0)
        self.last_stats = stats
        if table_ovf:
            raise RuntimeError(f"shard hash table overflow (per-shard capacity {st.C}"
                               + (f"; also exchange-carry overflow, cap {self.exchange_cap}"
                                  if carry_ovf else "") + "); increase capacity")
        if carry_ovf:
            raise RuntimeError(f"exchange-carry overflow (exchange cap {self.exchange_cap}); "
                               "increase exchange_cap")
        if steps >= self.max_steps and fmin_g < goal_g:
            raise RuntimeError("max_steps exceeded")
        if goal_g >= INF:
            raise RuntimeError("open set exhausted without reaching the goal")
        t0 = time.perf_counter()
        if self.driver == "chunked":
            masks, rounds, walk_reads = self._walk_loop(shards, stats)
        else:
            masks, rounds = self._walk(shards)
            walk_reads = rounds
        stats.update(walk_rounds=rounds, walk_reads=walk_reads,
                     walk_form=self.walk_form() if self.driver == "chunked" else "host",
                     walk_s=time.perf_counter() - t0)
        # expanded, reopened, closed, open, migrated of each shard
        per = np.zeros((ndev, 5), dtype=np.int64)
        per[:, [0, 1, 3, 4]] = np.asarray(c[C_HEAD:C_HEAD + 4 * ndev]).reshape(ndev, 4)
        table = np.zeros((ndev, 2), dtype=np.int64)  # closed, open of each shard
        for sh in shards:
            n_open, n_closed = _open_closed(st, sh.tab)
            table[sh.me] = n_closed, n_open
        if self.multiprocess:
            table = mesh.all_sum([torch.as_tensor(table, device=shards[0].dev)])[0]
            table = table.cpu().numpy()
        per[:, 2:4] = table
        return self._result(goal_g, steps, masks, per)

    def _step(self, shards: List[_Shard]) -> None:
        """One step of every local shard: its card form (``_step_cards``)
        or its rank form (``_step_ranks``).  Neither reads a host value
        (but a ProcessMesh on the CPU under the ragged exchange, whose
        split sizes its host reads from its own CPU tensors): the exchange
        is sized and the stop test made on the devices, so a graph can
        hold the step."""
        if self.card_form:
            self._step_cards(shards)
        else:
            self._step_ranks(shards)

    def _step_ranks(self, shards: List[_Shard]) -> None:
        """The step's rank form, each local shard a rank with its own card
        (``_Card``): the phases of ``_step_cards`` with the mesh's
        collectives between them, each into the card's preallocated
        outputs (JAX's collectives of the sharded step): the batch's
        coordinates gathered and K12's partials reduce-scattered into h3
        (``_sharded_h3`` :305-307), the send counts gathered (ragged:
        ``_route_ragged`` :214), each shard's report block gathered after
        its pack, the consensus of every rank over every row of its gathered
        block by address (``_consensus`` :319), then the exchange kernel, A
        read on the card: ragged, over every rank's wire by address (this
        rank's own, the others' mapped into this process: ``wires``), as
        ``_route_ragged``'s all-to-all :231 delivers them; dense, over the
        received blocks of the wires' fixed-shape all-to-all (``_route_cap``
        :148).  The same collectives in the same order on every rank,
        whatever the data, and no host value read (but the ragged sizes of
        a mesh that maps nothing, ``_exchange_host``).

        The ragged exchange reads a peer's wire with no collective of its
        own; the step's collectives order it.  Rank i's pack of step t
        writes its wire before rank i joins the gather of the report
        blocks, which completes on rank r only after every rank has joined
        it: so rank r's exchange, after that gather, reads every wire of
        step t written.  Rank i's pack of step t + 1 comes after the gather
        of step t + 1's send counts, which completes on rank i only after
        rank r has joined it, after its exchange of step t: so no wire is
        rewritten while a peer still reads it."""
        st, mesh, ndev, cards = self.st, self.mesh, self.ndev, self.cards
        cap, pw = self.exchange_cap, shards[0].pw
        ragged = self.exchange == "ragged"
        for sh in shards:
            sh.select()
        if self.cubes_split:
            mesh.all_gather([sh.coords() for sh in shards], [c.coords for c in cards])
            mesh.reduce_scatter([sh.partial(c.coords.view(ndev * st.B, st.n))
                                 for sh, c in zip(shards, cards)], [c.h3 for c in cards])
        for sh, c in zip(shards, cards):
            sh.expand(self, c.h3 if self.cubes_split else None)
        counts = [sh.count(self) for sh in shards]
        if ragged:
            mesh.all_gather(counts, [c.counts for c in cards])
        for sh, c in zip(shards, cards):
            sh.pack(self, c.counts if ragged else None)
        mesh.all_gather([sh.blk for sh in shards], [c.reps for c in cards])
        for c in cards:
            c.consensus(self)
        if ragged and self.wires is None:
            self._exchange_host(shards)
        else:
            if not ragged:
                mesh.all_to_all([sh.wire[:ndev * cap].view(ndev, cap, pw) for sh in shards],
                                [c.recv.view(ndev, cap, pw) for c in cards])
            for c in cards:
                c.exchange(self, shards)
        for sh in shards:
            sh.insert(self)

    def _check_agreement(self) -> None:
        """The rank form's end: one gather of every rank's consensus vector,
        which must be the same (the ranks ran the same collectives, so
        every one stopped at the same step)."""
        full = self.mesh.all_gather([c.cons for c in self.cards])
        for f in full:
            if not bool((f == f[0]).all()):
                raise RuntimeError(f"the ranks' consensus vectors differ at the end of the "
                                   f"search: {f.cpu().tolist()}")

    @contextlib.contextmanager
    def _fork(self):
        """The several-card step's fork and join: every card's stream
        waits for the current stream of the first card, which waits for
        every card's at the end (a graph captured on it holds all of
        them)."""
        if self._ev_fork is None:
            yield
            return
        dev0 = self.cards[0].dev
        with torch.cuda.device(dev0):
            origin = torch.cuda.current_stream(dev0)
            self._ev_fork.record(origin)
            for card in self.cards:
                card.stream.wait_event(self._ev_fork)
            yield
            for card in self.cards:
                card.signal("join")
                origin.wait_event(card.events["join"])

    def _step_cards(self, shards: List[_Shard]) -> None:
        """The step's card form, card by card in each phase.  On one card
        the gathers are in place (each shard writes its row of the card's
        buffers; the send counts stacked) and the consensus reads every
        shard's report where it lies.  On several cards each card runs on
        its stream and pulls the other cards' rows in by copies once they
        are written (``_Card.wait``): the coordinates before any partial,
        the partials before the h3 sums, the send counts before any pack;
        each card snapshots its shards' reports after their packs, and
        every snapshot and wire is written before any consensus and
        exchange reads them.  No host read, no allocation."""
        st, ndev, cards = self.st, self.ndev, self.cards
        with self._fork():
            for card in cards:
                with card.on():
                    for sh in card.shards:
                        sh.select()
                    if self.cubes_split:
                        for sh in card.shards:
                            sh.coords()
                    card.signal("coords")
            if self.cubes_split:
                for card in cards:
                    with card.on():
                        card.wait("coords")
                        card.pull("coords")
                        coords_g = card.coords.view(ndev * st.B, st.n)
                        for sh in card.shards:
                            sh.partial(coords_g)
                        card.signal("parts")
                for card in cards:
                    with card.on():
                        card.wait("parts")
                        card.pull("parts")
                        torch.sum(card.parts.view(ndev, ndev, st.B, st.M + 1), 0, out=card.h3)
            for card in cards:
                with card.on():
                    for sh in card.shards:
                        sh.expand(self, card.h3[sh.me] if self.cubes_split else None)
                    counts = [sh.count(self) for sh in card.shards]
                    card.signal("counts")
            for card in cards:
                with card.on():
                    S_all = None
                    if self.exchange == "ragged":
                        S_all = card.counts
                        if card.multi:
                            card.wait("counts")
                            card.pull(("counts", card.shards[0].cur))
                        else:
                            torch.stack(counts, out=S_all)
                    for sh in card.shards:
                        sh.pack(self, S_all)
                    card.pull("snaps")
                    card.signal("packs")
            for card in cards:
                with card.on():
                    card.wait("packs")
                    card.consensus(self)
                    card.exchange(self, shards)
                    for sh in card.shards:
                        sh.insert(self)

    def _exchange_host(self, shards: List[_Shard]) -> None:
        """The ragged exchange of the rank form on a mesh that maps no
        peer's wire (a ProcessMesh on the CPU, a LocalMesh over cards
        without peer access), sized by the host's copy of A (the
        all-to-all's split sizes): each shard's received rows, in sender
        order, just before row R of its pending list, where the insert
        reads them (the consensus wrote their count); nothing on overflow,
        where the step stops before the exchange."""
        v = self.cards[0].cons.cpu().numpy()
        if v[C_TOVF] or v[C_COVF]:
            return
        A = cons_sizes(v, self.ndev)
        n_recv = A.sum(0)
        regions = [sh.pend[sh.R - int(n_recv[sh.me]): sh.R] for sh in shards]
        off = np.cumsum(A, axis=1) - A
        self.mesh.all_to_all_ragged([sh.wire for sh in shards], off, A, regions)

    def _read(self, shards: List[_Shard]) -> Tuple[np.ndarray, np.ndarray]:
        """One host read: the consensus vector (every card's is the same)
        and every local shard's overflow counter (its last insert's
        overflow shows in the consensus only a step later; another
        rank's reads 0), copied into the first card's read buffer on its
        current stream (the rank form's other cards synchronised first:
        their streams join no event of the first's)."""
        c0 = self.cards[0]
        if not self.card_form:
            for card in self.cards[1:]:
                if card.cuda:
                    torch.cuda.synchronize(card.dev)
        with torch.cuda.device(c0.dev) if c0.cuda else contextlib.nullcontext():
            c0.pull("read")
            v = c0.readout.cpu().numpy()
        cw = cons_words(self.ndev)
        return v[:cw], v[cw:]

    def _search_host(self, shards: List[_Shard]):
        """The host driver: one step a host read of the consensus vector
        (the stop test on the host; max_steps checked at the end of every
        chunk_steps steps).  Returns (the last consensus vector, the
        shards' overflow counters, reads)."""
        reads = 0
        while True:
            self._step(shards)
            c, ovf = self._read(shards)
            reads += 1
            steps = int(c[C_STEPS])
            if not c[C_RUN] or (steps % self.chunk_steps == 0 and steps >= self.max_steps):
                return c, ovf, reads

    def _search_chunked(self, shards: List[_Shard], stats: dict):
        """The chunked driver (the card form): ``chunk_steps`` steps a host
        read (``_read``; JAX reads its counters once a chunk, :1410),
        max_steps checked once a chunk (:1430).  On cards a step of the
        whole mesh is a CUDA graph, one for each ring parity
        (``_step_graphs``), and a chunk is ``chunk_steps`` replays of them
        in turn (``replay_parities``) with no host read between; the
        replays after the stop do nothing.  ``stats`` gets the host seconds
        of the replays' launches and of the reads (which wait for the
        cards): ``replay_s``, ``read_s``.  Returns as ``_search_host``."""
        card = self.cards[0]
        reads, steps = 0, 0
        stats.update(replay_s=0.0, read_s=0.0)
        while True:
            if card.cuda:
                parity = shards[0].cur
                order = replay_parities(parity, self.chunk_steps)
                with torch.cuda.device(card.dev):
                    graphs = self._step_graphs(card, shards, stats)
                    t0 = time.perf_counter()
                    for p in order:
                        graphs[p].graph.replay()
                    stats["replay_s"] += time.perf_counter() - t0
                for p in (0, 1):
                    _kernels.replayed(graphs[p].tally, order.count(p))
                stats["graph_replays"] += len(order)
            else:
                for _ in range(self.chunk_steps):
                    self._step(shards)
            t0 = time.perf_counter()
            c, ovf = self._read(shards)
            stats["read_s"] += time.perf_counter() - t0
            reads += 1
            if card.cuda:
                # each step that ran packed into the other ring
                for sh in shards:
                    sh.cur = parity_after(parity, int(c[C_STEPS]) - steps)
            steps = int(c[C_STEPS])
            if not c[C_RUN] or steps >= self.max_steps:
                return c, ovf, reads

    def _warm(self, flags: Sequence[torch.Tensor], fn) -> None:
        """``fn`` once with every flag of ``flags`` at 0, restored after, on
        every card: each C entry's first call queries the card (and builds
        and loads its library), which a capture must not do; each kernel
        returns at once."""
        saved = [f.clone() for f in flags]
        for f in flags:
            f.zero_()
        fn()
        for f, v in zip(flags, saved):
            f.copy_(v)
        for card in self.cards:
            torch.cuda.synchronize(card.dev)

    def _capture_mode(self) -> str:
        """The captures' error mode: on a ProcessMesh "thread_local", so
        that the NCCL process group's watchdog thread, which queries its
        collectives' events, may do so during a capture (under "global"
        such a query breaks the capture); else "global"."""
        return "thread_local" if isinstance(self.mesh, ProcessMesh) else "global"

    def _step_graphs(self, card: _Card, shards: List[_Shard], stats: dict):
        """The step's CUDA graphs, one for each parity of the rings a step
        starts from (``card.graphs[p]``: it reads ring p and packs into
        ring 1 - p), each holding every card's kernels and copies (on
        several cards captured from the first card's stream, the other
        cards' streams joined by events): captured at the first chunk and
        replayed after (every buffer a step passes is the run's).  Before
        the captures the step runs once with every run flag at 0
        (``_warm``).  A failed capture raises."""
        from ..search import step as S

        if len(card.graphs) == 2:
            return card.graphs
        t0 = time.perf_counter()
        curs = [sh.cur for sh in shards]
        if not card.warm:
            self._warm([c.run for c in self.cards], lambda: self._step(shards))
            card.warm = True
        t1 = time.perf_counter()
        host = [0.0]

        def step():
            t = time.perf_counter()
            self._step(shards)
            host[0] += time.perf_counter() - t

        for parity in (0, 1):
            for sh in shards:
                sh.cur = parity
            tally: Dict[str, int] = {}
            with _kernels.capturing(tally):
                graph = S._capture(step, self._capture_mode())
            card.graphs[parity] = S.ChunkGraph(parity, graph, tally)
        for sh, cur in zip(shards, curs):
            sh.cur = cur
        t2 = time.perf_counter()
        # the captures' host seconds: the warm-up step, the step's host code
        # while captured, and the rest (instantiation and capture's ends)
        stats["graph_captures"] += 2
        stats["capture_s"] += t2 - t0
        stats["capture_warm_s"] = stats.get("capture_warm_s", 0.0) + t1 - t0
        stats["capture_host_s"] = stats.get("capture_host_s", 0.0) + host[0]
        stats["capture_instantiate_s"] = (stats.get("capture_instantiate_s", 0.0)
                                          + t2 - t1 - host[0])
        return card.graphs

    def _walk(self, shards: List[_Shard]) -> Tuple[List[int], int]:
        """The batched distributed walk (JAX ``_make_batched_walk``) of the
        host driver: rounds of at most WALK_HOPS hops on every shard's
        table, summed by the mesh, one host read a round; it stops at the
        origin or when a round makes no progress."""
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

    def walk_form(self) -> str:
        """The chunked driver's walk: "launch" where the card form has one
        card (every shard's table on one device, or the CPU): the whole
        walk in one launch of ``path_walk_shards`` (a CPU card
        ``walk_shards_plain``) and one host read; else "rounds", the device
        loop of rounds (``_walk_loop``)."""
        return "launch" if self.card_form and len(self.cards) == 1 else "rounds"

    def _walk_loop(self, shards: List[_Shard], stats: Optional[dict] = None,
                   form: Optional[str] = None) -> Tuple[List[int], int, int]:
        """The batched distributed walk of the chunked driver: ``form``
        (default ``walk_form()``) "launch", the walk in one launch, each
        node looked up in its owner's table, the rounds the round form
        would take counted on the way (``_walk_launch``); or "rounds", a
        device loop (JAX ``_make_batched_walk``'s while_loop, :545): a round is
        every shard's K7 hop mode from its card's copy of the coordinate,
        each run written where the shard lies, then on every card
        ``walk_advance``, which sums the runs (read by address, on that
        card or its peers; in the rank form the one run the mesh's sum of
        every rank's wrote into the card's ``wsum``, JAX's psum :521, a
        non-owner's run all zeros), appends the masks and moves the card's
        coordinate on (on several cards after every card's runs are
        written: ``_Card.wait``; where they lie on several devices over a
        full edge, ``join_full``); WALK_ROUNDS rounds a host read of the
        first card (on cards a CUDA graph of one round over every card,
        replayed WALK_ROUNDS times), until the walk's flag reads 0.
        Returns (masks, rounds, host reads); raises as ``_walk``.
        ``stats`` gets the host seconds of the round form's warm-up round
        (a C entry's first calls) and of its capture (``walk_warm_s``,
        ``walk_capture_s``)."""
        from ..search import step as S

        form = form or self.walk_form()
        if form == "launch":
            if not self.card_form or len(self.cards) != 1:
                raise ValueError("the one-launch walk needs the card form on one card")
            return self._walk_launch(shards)
        if form != "rounds":
            raise ValueError(f"unknown walk form {form!r}")
        st, n, hops, cards = self.st, self.st.n, WALK_HOPS, self.cards
        ranks = not self.card_form
        final = [int(v) for v in self.problem.final_coord]
        i32 = dict(dtype=torch.int32)
        for card in cards:  # each card's walk state, and its shards' runs
            dev = card.dev
            card.wparams = torch.tensor(final + list(st.bitw), **i32).to(dev)
            card.masks = torch.zeros(sum(final) + hops, **i32).to(dev)
            card.wst = torch.zeros(2, **i32).to(dev)  # masks emitted, rounds
            card.wrun = torch.tensor([int(any(final))], **i32).to(dev)
            for sh in card.shards:
                sh.wout = torch.zeros(hops + n + 1, **i32).to(dev)
            if ranks:
                card.wsum = torch.zeros(hops + n + 1, **i32).to(dev)
        runs = sorted(shards, key=lambda sh: sh.me)
        for card in cards:
            card.runs = [card.wsum] if ranks else [sh.wout for sh in runs]
            if card.cuda:
                card.wtab = run_table(card.runs, hops, n)
        # runs written on other devices: walk_advance on a full edge
        spread = len({c.dev for c in cards}) > 1

        def round_() -> None:
            with self._fork():
                for card in cards:
                    with card.on():
                        for sh in card.shards:
                            sh.walk_hops(card.wparams, hops, out=sh.wout, run=card.wrun)
                        card.signal("runs")
                if ranks:
                    self.mesh.all_sum([sh.wout for sh in shards], [c.wsum for c in cards])
                for card in cards:
                    with card.on():
                        card.wait("runs")
                        args = (hops, n, card.wparams, card.masks, card.wst, card.wrun)
                        if card.cuda:
                            if spread:
                                join_full()
                            walk_advance_cuda(card.wtab, *args)
                        else:
                            walk_advance_plain(card.runs, *args)

        c0 = cards[0]
        graph = None
        if c0.cuda:
            t0 = time.perf_counter()
            with torch.cuda.device(c0.dev):
                self._warm([c.wrun for c in cards], round_)
                t1 = time.perf_counter()
                tally: Dict[str, int] = {}
                with _kernels.capturing(tally):
                    graph = S._capture(round_, self._capture_mode())
            if stats is not None:
                stats.update(walk_warm_s=t1 - t0, walk_capture_s=time.perf_counter() - t1)
        reads = 0
        while True:
            if graph is not None:
                with torch.cuda.device(c0.dev):
                    for _ in range(WALK_ROUNDS):
                        graph.replay()
                _kernels.replayed(tally, WALK_ROUNDS)
            else:
                for _ in range(WALK_ROUNDS):
                    round_()
            # the replay's one read: the first card's flag, counts,
            # coordinate and masks (every card's are the same)
            v = torch.cat([c0.wrun, c0.wst, c0.wparams[:n], c0.masks]).cpu().tolist()
            reads += 1
            if not v[0]:
                break
        n_masks, n_rounds, coord = v[1], v[2], v[3:3 + n]
        if any(coord):
            raise RuntimeError("distributed backtrace did not reach the origin")
        return v[3 + n:3 + n + n_masks], n_rounds, reads

    def _walk_launch(self, shards: List[_Shard]) -> Tuple[List[int], int, int]:
        """The walk of one card in one launch (``walk_shards_cuda``; CPU
        shards ``walk_shards_plain``): (masks, rounds, 1 host read);
        raises as ``_walk``."""
        final = [int(v) for v in self.problem.final_coord]
        tabs = [sh.tab for sh in sorted(shards, key=lambda sh: sh.me)]
        if self.cards[0].cuda:
            masks, coord, rounds = walk_shards_cuda(self.st, tabs, final, self.layout,
                                                    self.hash_params)
        else:
            masks, coord, rounds = walk_shards_plain(self.st, tabs, final, self.layout,
                                                     self.own)
        if any(coord):
            raise RuntimeError("distributed backtrace did not reach the origin")
        return masks, rounds, 1

    def _run_single(self) -> ShardedSearchResult:
        """One shard, dense: the single-table search (JAX's ndev == 1 fast
        path), the engine's own chunk (one step a chunk under the host
        driver, as FrontierSearch's) and walk."""
        st = self.st
        tab = _shard_table(st, self.layout, self.h_root, True)
        ctr = torch.as_tensor(fresh_counters(), device=st.device)
        host = self.driver == "host"
        t0 = time.perf_counter()
        chunks = 0
        while True:
            ctr = _run_chunk(st, tab, ctr, 1 if host else self.chunk_steps, self.ub, self.fill,
                             self.layout, graph=not host)
            chunks += 1
            c = ctr.tolist()
            goal_v, fmin_v, steps, expanded, reopened, _, overflow = c[:7]
            if fmin_v >= goal_v or overflow > 0 or steps >= self.max_steps:
                break
        self.last_stats = dict(steps=steps, host_reads=chunks, wire_rows=0, migrated=0,
                               peak_carry=0, exchange="none", cap=self.exchange_cap,
                               driver=self.driver, search_s=time.perf_counter() - t0)
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
        self.last_stats.update(walk_rounds=1, walk_reads=1, walk_s=time.perf_counter() - t0)
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
