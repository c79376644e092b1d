"""The packed and unpacked search step of the port on the CPU: NumPy
emulations of the step kernels K3 (csrc/select_best.cu, its unpacked
instantiation), K9 (csrc/keyrow_expand.cu) and K10 (csrc/keyrow_insert.cu)
against the plain step and the JAX engine (all values exact integers: zero
tolerance).

- K3's unpacked schedule (lanes, warps and blocks of the read pass, block
  partials, the last block's cut, close and compact list) against
  _select_open_plain / _select and JAX _select, at G = 1 to 1024, on an
  empty table and with negative f;
- K9's schedule (warps over K3's list in a random order, masks in passes of
  32 lanes, pending places by one atomic a warp) against the plain
  _expand -> prune -> _candidates_packed / _candidates_unpacked with its
  content tags, and against JAX _expand, at N = 4, 6 and 10, with cubes and
  without;
- K10's rounds (threads and blocks in random orders, the lanes shuffled;
  round 0 on the grid, then the tail in one block or every round on the
  grid, cap K10_CAP and 0) against _insert_core_packed / _insert_core
  exactly (claim included), with its grid syncs against
  step.k10_grid_syncs, and the plain inserts against JAX _insert_packed /
  _insert on the key map, with duplicate keys, colliding homes, the
  128-round overflow and 0 lanes;
- the step loop of K3 -> K9 -> K10 with its run flag against
  _run_chunk_plain, chunk by chunk, on test, test2, a 5 x 130 family
  (packed) and the degenerate input (unpacked);
- the content tag leaves the plain step's tables as lane indices did;
- the kernels' constants, the wrappers' refusals and the chunk graph's host
  logic on key-row tables (stub C entries, a fake graph).
"""
import ctypes
import functools
import json
import os
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu.core.problem import Problem as JProblem
from mpi_pastar_msa_tpu.heuristic import triples as JT
from mpi_pastar_msa_tpu.heuristic.hpair import HPairHeuristic as JHPair
from mpi_pastar_msa_tpu.search import engine as JE
from mpi_pastar_msa_tpu_torch import _kernels
from mpi_pastar_msa_tpu_torch.core.cost import GAP_EXTENSION, GAP_GAP
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic import triples as TT
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.parallel import sharded as TSH
from mpi_pastar_msa_tpu_torch.search import engine as TE
from mpi_pastar_msa_tpu_torch.search import step as TS

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "mpi_pastar_msa_tpu_torch", "csrc")
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))
M32 = 0xFFFFFFFF
INF, INFP = TE.INF, TE.INFP
# csrc/select_best.cu: kThreads, kItems; csrc/keyrow_insert.cu: kThreads,
# kLanes
K3_THREADS, K3_ITEMS, K10_THREADS, K10_LANES = 512, 16, 512, 2
K3_WARPS = K3_THREADS // 32
BIAS = 0x80000000
NONE_OPEN = INF ^ BIAS  # K3's key of a slot that is not open (unpacked)


def golden_seqs(name):
    return tuple(r.replace("-", "") for r in GOLD[name]["alignment"])


def random_seqs(seed, n, lo, hi):
    rs = np.random.RandomState(seed)
    return tuple("".join(rs.choice(list("ACDEFGHIKLMNPQRSTVWY"), size=rs.randint(lo, hi + 1)))
                 for _ in range(n))


def near_identical(n=5, L=130, seed=5):
    """n x L residues, 5% substitutions (tests/test_large_n.py's family)."""
    rng = np.random.default_rng(seed)
    aa = "ARNDCQEGHILKMFPSTWYV"
    anc = "".join(aa[i] for i in rng.integers(0, 20, L))
    return tuple("".join(aa[rng.integers(0, 20)] if rng.random() < 0.05 else ch for ch in anc)
                 for _ in range(n))


@functools.lru_cache(maxsize=None)
def both_hpair(seqs):
    jh = JHPair.build(JProblem(seqs), backend="host")
    th = HPairHeuristic.from_numpy(Problem(seqs), jh.tables, jh.weight_f, jh.weight_i)
    return jh, th


@functools.lru_cache(maxsize=None)
def both_cubes(seqs):
    jh, th = both_hpair(seqs)
    jh3 = JT.HTriples.build(jh)
    th3 = TT.HTriples.from_numpy(th, jh3.triangles, jh3.tri_weights, np.asarray(jh3.tri_tabs),
                                 jh3.cost_scale)
    return jh3, th3


def statics(seqs, batch, capacity, triples="off"):
    jh, th = both_cubes(seqs) if triples == "auto" else both_hpair(seqs)
    return (JE._Static(JProblem(seqs), jh, batch, capacity),
            TE._Static(Problem(seqs), th, batch, capacity, "cpu"))


def clone(tab):
    return type(tab)(*(t.clone() for t in vars(tab).values()))


def same_table(a, b, C):
    return all(torch.equal(x[:C], y[:C]) for x, y in zip(vars(a).values(), vars(b).values()))


def mix32(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def hash_words(words):
    h = 2166136261
    for w in words:
        h = ((h ^ (w & M32)) * 16777619) & M32
    return mix32(h)


def i32(x):
    x &= M32
    return x - (1 << 32) if x >= 1 << 31 else x


# ----------------------------------------------------- K3, both instantiations

def emu_k3(st, tab, goal, thr, blocks=132, aligned=True, rng=None):
    """csrc/select_best.cu's schedule on a packed table (words) or an
    unpacked one (f biased to u32), in place: each lane's (min key, first
    index) over its slots (a warp a group with 4 slots a lane per int4, or
    L lanes a group), merged as (key << 32 | index), the groups strided
    over ``blocks`` blocks of K3_WARPS warps, one (min, open count) partial
    a block; then a random last block reduces the partials, forms the cut,
    flags the groups in rounds of K3_ITEMS a thread, scans the (item, warp)
    counts into list positions and closes the active slots.  Returns
    (slots, vmin, active, fmin, n_open, n_sel, reopen, sel)."""
    rng = rng or np.random.default_rng(0)
    C, B, nb = st.C, st.B, st.nb
    G = C // B
    unpacked = isinstance(tab, TE.UnpackedTable)
    if unpacked:
        f = tab.t_fpar[:C].numpy() >> nb
        is_open = (tab.t_state[:C].numpy() == 1) & (f < goal)
        key = np.where(is_open, (f.astype(np.int64) & M32) ^ BIAS, NONE_OPEN)
        none = NONE_OPEN
    else:
        w = tab.t_best[:C].numpy().astype(np.int64)
        is_open = (w < tab.t_closed[:C].numpy()) & ((w >> nb) < goal - st.f0)
        key = np.where(is_open, w, INFP)
        none = INFP
    key = key.reshape(B, G).astype(np.uint64)
    vec = G % 128 == 0 and aligned
    L = 32 if G >= 32 else 1 << (G.bit_length() - 1)
    j = np.arange(G)
    lane = (j // 4) % 32 if vec else j % L
    full = (key << np.uint64(32)) | j.astype(np.uint64)
    start = np.uint64(none) << np.uint64(32)  # a lane starts at (none, 0)
    lane_key = np.stack([np.minimum(full[:, lane == k].min(axis=1), start)
                         for k in range(32 if vec else L)], 1)
    kmin = lane_key.min(axis=1)
    vmin = (kmin >> np.uint64(32)).astype(np.int64)
    slots = np.arange(B, dtype=np.int64) * G + (kmin & np.uint64(M32)).astype(np.int64)
    opens = is_open.reshape(B, G).sum(axis=1)
    gpw = 1 if vec else 32 // L
    block_of = (np.arange(B) // gpw % (blocks * K3_WARPS)) // K3_WARPS
    p_min = np.full(blocks, none, dtype=np.int64)
    p_cnt = np.zeros(blocks, dtype=np.int64)
    np.minimum.at(p_min, block_of, vmin)
    np.add.at(p_cnt, block_of, opens)
    order = rng.permutation(blocks)
    m, n_open = int(p_min[order].min()), int(p_cnt[order].sum())
    if unpacked:
        fmin = i32(m ^ BIAS)
        val = np.where(vmin == NONE_OPEN, INF, (vmin ^ BIAS) - ((vmin ^ BIAS) >= BIAS) * 2**32)
        act_all = (vmin != NONE_OPEN) & (val <= fmin + thr)
    else:
        fmin_r = m >> nb
        cut = (min(fmin_r + thr + 1, INFP >> nb) << nb) - 1
        val = vmin
        act_all = vmin <= cut
        fmin = fmin_r + st.f0
    active = np.zeros(B, dtype=bool)
    sel = np.zeros((B, 2), dtype=np.int64)
    base = reopen = 0
    t = np.arange(K3_THREADS)
    for r0 in range(0, B, K3_ITEMS * K3_THREADS):
        b = r0 + np.arange(K3_ITEMS)[:, None] * K3_THREADS + t  # (item, thread)
        inside = b < B
        act = inside & act_all[np.minimum(b, B - 1)]
        by_warp = act.reshape(K3_ITEMS, K3_WARPS, 32)
        counts = by_warp.sum(axis=2).reshape(-1)
        off = base + np.cumsum(counts) - counts
        pos = off.reshape(K3_ITEMS, K3_WARPS, 1) + np.cumsum(by_warp, axis=2) - by_warp
        for bb, at in zip(b[act], pos.reshape(K3_ITEMS, K3_THREADS)[act]):
            active[bb] = True
            s_ = int(slots[bb])
            if unpacked:
                tab.t_state[s_] = 2
            else:
                reopen += int(tab.t_closed[s_]) < INFP
                tab.t_closed[s_] = int(val[bb])
            sel[at] = (s_, val[bb])
        base += int(counts.sum())
    if unpacked:
        vmin = np.where(active, val, INF)
        slots = np.where(active, slots, np.arange(B) * G)
    else:
        vmin = np.where(active, vmin, INFP)
    return slots, vmin, active, fmin, n_open, base, reopen, sel[:base]


def open_table(st, rs, empty=0.0, negative=False):
    """An unpacked table for a select: keys at a third of the slots, states
    open and closed, f in a narrow band (ties: the first index wins), whole
    groups empty with probability ``empty``; ``negative`` shifts f below 0;
    f of some open slots at INF."""
    C, nb = st.C, st.nb
    size = C + TE.TRASH
    used = (rs.rand(C) < 0.35) & np.repeat(rs.rand(st.B) >= empty, C // st.B)
    f = rs.randint(0, 40, size=C) + (-500 if negative else st.f0)
    f[rs.rand(C) < 0.02] = INF
    fpar = np.full(size, INF << nb, dtype=np.int64)
    fpar[:C][used] = (f[used].astype(np.int64) << nb) + rs.randint(1, st.M + 1, size=used.sum())
    state = np.zeros(size, dtype=np.int32)
    state[:C][used] = np.where(rs.rand(used.sum()) < 0.7, 1, 2)
    t_key = np.full((size, st.W), -1, dtype=np.int32)
    t_key[:C][used] = rs.randint(0, 1 << 20, size=(used.sum(), st.W))
    t_g = np.full(size, INF, dtype=np.int32)
    t_g[:C][used] = rs.randint(0, 1000, size=used.sum())
    return TE.UnpackedTable(torch.from_numpy(t_key), torch.from_numpy(t_g),
                            torch.from_numpy(fpar), torch.from_numpy(state),
                            torch.full((size,), INFP, dtype=torch.int32))


def check_k3_open(jst, st, tab, goal, thr, **schedule):
    """K3's unpacked schedule against _select_open_plain (every output and
    t_state), its list against the active rows in group order, and the
    plain _select against JAX _select."""
    C, nb = st.C, st.nb
    a = clone(tab)
    got = emu_k3(st, a, goal, thr, **schedule)
    b = clone(tab)
    want = TE._select_open_plain(st, b.t_state, b.t_fpar, torch.tensor(goal), torch.tensor(thr))
    for x, y in zip(got[:7], want):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert torch.equal(a.t_state[:C], b.t_state[:C])
    rows = np.nonzero(got[2])[0]
    assert np.array_equal(got[7], np.stack([got[0][rows], got[1][rows]], 1))
    # the plain _select against JAX _select on the same table
    c = clone(tab)
    coords, g, par, fpar, act, fmin, n_open, n_sel, re = TE._select(
        st, c, torch.tensor(goal), torch.tensor(thr))
    fp = tab.t_fpar[:C].numpy()
    jtab = (jnp.asarray(tab.t_key[:C].numpy().view(np.uint32)), jnp.asarray(tab.t_g[:C].numpy()),
            jnp.asarray((fp >> nb).astype(np.int32)),
            jnp.asarray((fp & ((1 << nb) - 1)).astype(np.int32)),
            jnp.asarray(tab.t_state[:C].numpy()))
    jt, jc, jg, jpar, jfpar, jact, jfmin, jnopen, jnsel = JE._select(
        jst, jtab, jnp.int32(goal), jnp.int32(thr))
    assert np.array_equal(np.asarray(jact), act.numpy())
    for x, y in ((coords, jc), (g, jg), (par, jpar), (fpar, jfpar)):
        assert np.array_equal(x.numpy()[rows], np.asarray(y).astype(np.int64)[rows])
    assert (int(fmin), int(n_open), int(n_sel)) == (int(jfmin), int(jnopen), int(jnsel))
    assert np.array_equal(c.t_state[:C].numpy(), np.asarray(jt[4])) and int(re) == 0
    return got


@pytest.mark.parametrize("G,aligned,blocks,empty,negative", [
    (1, True, 132, 0.2, False), (2, True, 3, 0.2, False), (32, True, 132, 0.2, True),
    (128, True, 3, 0.3, False), (1024, True, 1, 0.0, True),
    # G a multiple of 128 on an unaligned table: the scalar path
    (128, False, 132, 0.2, True)])
def test_k3_open_schedule_equals_plain_and_jax(G, aligned, blocks, empty, negative):
    C = 1 << 14
    jst, st = statics(golden_seqs("PF08184.fasta"), C // G, C)
    rs = np.random.RandomState(G + negative)
    tab = open_table(st, rs, empty, negative)
    goal = INF if negative else st.f0 + 30
    got = check_k3_open(jst, st, tab, goal, 5, blocks=blocks, aligned=aligned,
                        rng=np.random.default_rng(G))
    assert 0 < got[5] <= st.B and (got[3] < 0) == negative
    assert (got[1][got[2]] < 0).all() == negative


def test_k3_open_schedule_on_an_empty_table():
    jst, st = statics(golden_seqs("PF08184.fasta"), 64, 1 << 12)
    tab = open_table(st, np.random.RandomState(1), empty=1.0)
    got = check_k3_open(jst, st, tab, INF, 40)
    assert got[3] == INF and got[4] == got[5] == 0 and not got[2].any()


# ------------------------------------------------------------------------ K9

class KernelStatics:
    """The constants csrc/keyrow_expand.cu stages, as NumPy arrays."""

    def __init__(self, st):
        self.st = st
        self.xs = np.array([x for x, _ in st.pairs])
        self.ys = np.array([y for _, y in st.pairs])
        self.w = st.d_w.numpy()
        self.wh = st.d_w_h.numpy()
        self.tri = st.d_tri_xyz.numpy() if st.T3 else np.zeros((0, 3), dtype=np.int64)
        self.final = st.final_np
        self.t4 = st.d_tables4.numpy()
        self.cubes = st.d_cubes.numpy() if st.T3 else None


def pair_terms(ks, t8, par, gap_oe):
    """expand_row.cuh pair_terms: (P, 4) cost and h terms of a row, entry
    [p, 2 bx + by], from its T8 rows ``t8`` (P, 5) and parent mask."""
    E, GG = GAP_EXTENSION, GAP_GAP
    bx, by = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    w, wh = ks.w.astype(np.int64)[:, None], ks.wh.astype(np.int64)[:, None]
    mm = t8[:, 4:5].astype(np.int64)
    cost = w * (GG + (E - GG) * (bx + by) + (bx & by) * (mm + GG - 2 * E))
    cost += gap_oe * w * (bx * (1 - by) * (par >> ks.ys[:, None] & 1)
                          + (1 - bx) * by * (par >> ks.xs[:, None] & 1))
    return cost, t8[:, :4].astype(np.int64) * wh


def term_sums(ks, cost_t, h_t, cube, ms):
    """expand_row.cuh child_cost_h_terms for the masks ``ms``: P lookups of
    the term tables and T cube corners each."""
    idx = ((ms[:, None] >> ks.xs) & 1) * 2 + ((ms[:, None] >> ks.ys) & 1)
    p = np.arange(len(ks.xs))
    h = h_t[p, idx].sum(1)
    for t, (x, y, z) in enumerate(ks.tri):
        h = h + cube[t, 4 * (ms >> x & 1) + 2 * (ms >> y & 1) + (ms >> z & 1)]
    return cost_t[p, idx].sum(1), h


def k9_home_match(st, tab, entries):
    """K9's round-0 match on the packed layout: a lane whose home probe row
    holds its key settles there (t_best min of its packed word).  Returns
    (the lanes that stay pending, the settled ones); the unpacked layout
    keeps every lane pending."""
    if isinstance(tab, TE.UnpackedTable):
        return list(entries), []
    W, key = st.W, tab.t_key.numpy()
    left, settled = [], []
    for e in entries:
        at = (e[W] & M32) & (st.C - 1)
        if key[at, 0] != -1 and key[at, :W].tolist() == list(e[:W]):
            tab.t_best[at] = min(int(tab.t_best[at]), e[W + 3])
            settled.append(e)
        else:
            left.append(e)
    return left, settled


def emu_k9(ks, tab, sel, goal, ub, rng):
    """csrc/keyrow_expand.cu: a block a row of K3's list ``sel`` of (slot,
    word) rows, the block's threads and passes and the grid from
    step.k9_launch_shape, blocks striding over the list and running in a
    random interleaving.  A block reads its row (coordinate from the key
    words; packed g = f - h(column W), unpacked g, parent mask and parent f
    from t_g and t_fpar), builds its term tables (pair_terms) and cube
    corners, and takes the masks in passes of its threads: cost and h as
    term sums, validity and the goal as the row's two masks, pathmax
    (unpacked), the goal before the prune; on the packed layout each
    surviving lane then reads its home row (k9_home_match: the table as K3
    left it); each pass's pending lanes take consecutive places at the
    block's one atomic, in thread order.  Returns (goal, pending entries in
    list order, surviving lanes, entries settled by the home-row match)."""
    st = ks.st
    S, N, nb, f0, W, M = st.S, st.n, st.nb, st.f0, st.W, st.M
    unpacked = isinstance(tab, TE.UnpackedTable)
    key = tab.t_key.numpy()
    blocks, threads, passes = TS.k9_launch_shape(st.B, M)
    by_block = {}
    n_valid = 0
    for i in range(len(sel)):
        slot, v = int(sel[i][0]), int(sel[i][1])
        row = key[slot]
        coord = np.array([(int(row[d // 2]) & M32) >> (16 * (d % 2)) & 0xFFFF
                          for d in range(N)])
        cx = np.clip(coord[ks.xs], 0, S - 2)
        cy = np.clip(coord[ks.ys], 0, S - 2)
        t8 = ks.t4[np.arange(st.P) * S * S + cx * S + cy, :5].astype(np.int64)
        cube = np.zeros((st.T3, 8), dtype=np.int64)
        for t, (x, y, z) in enumerate(ks.tri):
            c3 = np.clip(coord[[x, y, z]], 0, S - 2)
            for q in range(8):
                cube[t, q] = ks.cubes[t * S ** 3 + ((c3[0] + (q >> 2 & 1)) * S + c3[1]
                                                    + (q >> 1 & 1)) * S + c3[2] + (q & 1)]
        if unpacked:
            fp = int(tab.t_fpar[slot])
            g, par, f_par = int(tab.t_g[slot]), fp & ((1 << nb) - 1), fp >> nb
        else:
            g, par = (v >> nb) + f0 - int(row[W]), v & ((1 << nb) - 1)
        cost_t, h_t = pair_terms(ks, t8, par, st.gap_oe)
        final = ks.final
        room = int(sum(int(c < f) << d for d, (c, f) in enumerate(zip(coord, final))))
        near = bool(((coord == final) | (coord + 1 == final)).all())
        goal_m = int(sum(int(c + 1 == f) << d for d, (c, f) in enumerate(zip(coord, final)))
                     ) if near else -1
        fits = bool((coord <= final).all())
        for ps in range(passes):
            ms = 1 + ps * threads + np.arange(threads)
            valid = (ms <= M) & fits & ((ms & ~room) == 0)
            cost, h = term_sums(ks, cost_t, h_t, cube, np.minimum(ms, M))
            gc, fc = g + cost, g + cost + h
            if unpacked:
                fc = np.maximum(fc, f_par)
            if valid[ms == goal_m].any():
                goal = min(goal, int(gc[ms == goal_m][0]))  # before the prune
            valid &= fc <= ub
            n_valid += int(valid.sum())
            lanes = []
            for k in np.flatnonzero(valid).tolist():  # thread order
                m = int(ms[k])
                child = coord + (m >> np.arange(N) & 1)
                words = [int(child[2 * j]) | (int(child[2 * j + 1]) << 16
                                              if 2 * j + 1 < N else 0) for j in range(W)]
                entry = [i32(w) for w in words] + [i32(hash_words(words)), i * M + m - 1]
                if unpacked:
                    fpar = int(fc[k]) * (1 << nb) + m
                    entry += [int(gc[k]), i32(fpar), fpar >> 32]
                else:
                    entry += [int(h[k]), ((int(fc[k]) - f0) << nb) | m]
                lanes.append(tuple(entry))
            by_block.setdefault(i % blocks, []).append(lanes)
    # blocks run at once: their passes' atomics interleave in a random
    # order, each block's in its own order; the home-row reads see the
    # table as K3 left it (K9 writes no key row)
    queues = list(by_block.values())
    pend, matched = [], []
    while queues:
        q = queues[int(rng.integers(len(queues)))]
        left, settled = k9_home_match(st, tab, q.pop(0))
        if not q:
            queues.remove(q)
        pend += left
        matched += settled
    return goal, pend, n_valid, matched


def plain_pending(st, tab, coords, g, par, f_par, active, ub):
    """The plain step's insert lanes: _expand -> prune -> candidates, as
    K9's pending entries, and the goal."""
    sel = torch.nonzero(active)[:, 0]
    g_c, f_c, m_c, valid, is_goal, child = TE._expand(
        st, coords[sel], g[sel], par[sel], torch.ones_like(sel, dtype=torch.bool),
        f_parent=None if f_par is None else f_par[sel])
    goal = int(torch.where(is_goal, g_c, INF).min())
    keep = torch.nonzero(valid & (f_c <= ub))[:, 0]
    keys = TE._pack_keys(child[keep], st.W)
    cols = [TE._as_i32(keys), TE._as_i32(TE._hash_keys(keys))[:, None], keep[:, None]]
    if f_par is None:
        _, h, packed, _ = TE._candidates_packed(st, child[keep], g_c[keep], f_c[keep],
                                                m_c[keep], keep)
        cols += [h[:, None], packed[:, None]]
    else:
        fpar = f_c[keep] * (1 << st.nb) + m_c[keep]
        cols += [g_c[keep][:, None], TE._as_i32(fpar & M32)[:, None], (fpar >> 32)[:, None]]
    return goal, sorted(map(tuple, torch.cat([c.long() for c in cols], 1).tolist()))


def mid_search(seqs, layout, triples, batch, capacity, steps):
    """A port engine on the CPU ``steps`` steps into its search, the layout
    pinned."""
    th = (both_cubes(seqs) if triples == "auto" else both_hpair(seqs))[1]
    eng = TE.FrontierSearch(Problem(seqs), th, device="cpu", batch=batch, capacity=capacity,
                            triples=triples, layout=layout)
    tab = eng._init_table()
    ctr = TE._run_chunk(eng.st, tab, torch.as_tensor(TE.fresh_counters()), steps, eng.ub,
                        eng.fill_target, layout)
    return eng, tab, ctr


@pytest.mark.parametrize("name,triples,steps", [
    ("rand4", "auto", 5), ("rand4", "off", 5), ("rand6", "auto", 4), ("test2", "off", 6),
    # N = 10: 1023 masks, 4 passes of a block of 256 threads
    ("rand10", "off", 2)])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_k9_lanes_equal_plain_and_jax(name, triples, steps, layout):
    seqs = (golden_seqs(f"{name}.fasta") if name == "test2"
            else random_seqs(int(name[4:]), int(name[4:]), 8, 14))
    eng, tab, ctr = mid_search(seqs, layout, triples, 16, 1 << 14, steps)
    st, ub = eng.st, eng.ub
    goal, thr = int(ctr[0]), int(ctr[7])
    # the plain select and the plain expand on its rows
    ptab = clone(tab)
    coords, g, par, f_par, active, *_ = TE._LAYOUT_FNS[layout].select(
        st, ptab, torch.tensor(goal), torch.tensor(thr))
    assert int(active.sum()) > 0
    want_goal, want = plain_pending(st, tab, coords, g, par, f_par, active, ub)
    # the kernels' view: K3 then K9 on a copy; on the packed layout the
    # lanes whose home row holds their key settle in K9 (t_best as the
    # plain insert's round 0 leaves it), the rest stay pending
    etab = clone(tab)
    sel = emu_k3(st, etab, goal, thr)[7]
    before = clone(etab)
    egoal, pend, n_valid, matched = emu_k9(KernelStatics(st), etab, sel, goal, ub,
                                           np.random.default_rng(2))
    assert egoal == min(goal, want_goal)
    assert sorted(pend + matched) == want and len(pend) > 0 and n_valid == len(want)
    assert len({e[st.W + 1] for e in pend + matched}) == n_valid  # unique tags
    left, settled = k9_home_match(st, before, sorted(pend + matched))
    assert sorted(left) == sorted(pend) and sorted(settled) == sorted(matched)
    assert same_table(before, etab, st.C)
    if layout == "unpacked":
        assert matched == []
    elif name.startswith("rand") and triples == "off":
        assert matched  # children already stored at their home rows
    pend = pend + matched
    # and JAX's _expand on the same rows: g, f, validity and key words
    jst = statics(seqs, 16, 1 << 14, triples)[0]
    rows = torch.nonzero(active)[:, 0]
    jargs = [jnp.asarray(coords[rows].numpy().astype(np.int32)),
             jnp.asarray(g[rows].numpy().astype(np.int32)),
             jnp.asarray(par[rows].numpy().astype(np.int32)), jnp.ones(len(rows), dtype=bool)]
    if layout == "packed":
        jkeys, jg, jf, jm, jv, _, _, _ = JE._expand(jst, *jargs, None, jst.d_tables4, jst.d_enc)
    else:
        jkeys, jg, jf, jm, jv, _, _, _ = JE._expand(
            jst, *jargs, jnp.asarray(f_par[rows].numpy().astype(np.int32)))
    keep = np.nonzero(np.asarray(jv) & (np.asarray(jf) <= ub))[0]
    jkw = np.asarray(jkeys).reshape(-1, st.W)[keep].view(np.int32)
    by_tag = {e[st.W + 1]: e for e in pend}
    assert sorted(by_tag) == keep.tolist()
    for k, kw in zip(keep.tolist(), jkw):
        e = by_tag[k]
        assert list(e[: st.W]) == kw.tolist()
        if layout == "packed":
            assert e[st.W + 3] == ((int(np.asarray(jf)[k]) - st.f0) << st.nb) | int(
                np.asarray(jm)[k])
        else:
            assert e[st.W + 2] == int(np.asarray(jg)[k])


@pytest.mark.parametrize("N", range(3, 17))
def test_k9_term_tables_equal_child_cost_h(N):
    # expand_row.cuh: a mask's cost and h as sums of the row's term tables
    # (pair_terms) against child_cost_h's per-pair products, for every mask
    # of N sequences, with O - E != 0 (the parent-mask gap terms) and cubes
    rs = np.random.RandomState(N)
    E, GG, gap_oe = GAP_EXTENSION, GAP_GAP, 7
    pairs = [(x, y) for x in range(N) for y in range(x + 1, N)]
    tri = np.array([t for t in [(0, 1, 2), (N - 3, N - 2, N - 1), (0, N // 2, N - 1)]
                    if len(set(t)) == 3])
    ks = types.SimpleNamespace(xs=np.array([x for x, _ in pairs]),
                               ys=np.array([y for _, y in pairs]),
                               w=rs.randint(1, 1 << 20, size=len(pairs)),
                               wh=rs.randint(1, 1 << 12, size=len(pairs)), tri=tri)
    t8 = rs.randint(-(1 << 20), 1 << 20, size=(len(pairs), 5)).astype(np.int64)
    cube = rs.randint(-(1 << 24), 1 << 24, size=(len(tri), 8)).astype(np.int64)
    par = int(rs.randint(1, 1 << N))
    cost_t, h_t = pair_terms(ks, t8, par, gap_oe)
    w, wh = ks.w.astype(np.int64), ks.wh.astype(np.int64)
    for m0 in range(1, 1 << N, 8192):
        ms = np.arange(m0, min(m0 + 8192, 1 << N))
        bx, by = (ms[:, None] >> ks.xs) & 1, (ms[:, None] >> ks.ys) & 1
        # child_cost_h, pair by pair
        cost = (w * (GG + (E - GG) * (bx + by) + (bx & by) * (t8[:, 4] + GG - 2 * E))).sum(1)
        cost += (gap_oe * w * (bx * (1 - by) * (par >> ks.ys & 1)
                               + (1 - bx) * by * (par >> ks.xs & 1))).sum(1)
        h = (t8[np.arange(len(pairs)), 2 * bx + by] * wh).sum(1)
        for t, (x, y, z) in enumerate(tri):
            h += cube[t, 4 * (ms >> x & 1) + 2 * (ms >> y & 1) + (ms >> z & 1)]
        got_cost, got_h = term_sums(ks, cost_t, h_t, cube, ms)
        assert np.array_equal(got_cost, cost) and np.array_equal(got_h, h)


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_k9_match_and_k10_claims_on_planted_keys(layout):
    # one step's lanes on a planted table: two lanes of a key stored at
    # its home row (packed: K9 settles both, t_best their min); two lanes of
    # other rows with one new key that both claim its empty home row in
    # K10's round 0 (the smaller tag writes, the other matches on the
    # re-read); a new key whose home row holds the stored key, so it goes
    # on to K10 and a later round; a new key alone.  Then K10 on what K9
    # left: every table tensor (claim included) and the counters the plain
    # insert's
    jst, st = statics(golden_seqs("kinase.fasta"), 64, 1 << 10)
    rs = np.random.RandomState(11)
    tab, _ = keyrow_table(jst, st, rs, layout, 0)
    pool = np.unique(np.stack([rs.randint(0, int(v) + 1, size=20000) for v in st.final_np],
                              1), axis=0)
    home = TE._hash_keys(TE._pack_keys(torch.from_numpy(pool), st.W)).numpy() & (st.C - 1)
    k1 = 0
    k3 = int(np.flatnonzero(home == home[k1])[1])  # another key, the same home row
    k2, k4 = (int(k) for k in np.flatnonzero((home != home[k1])
                                               & (home != home[k3]))[:2])
    assert home[k2] != home[k4]
    stored = torch.from_numpy(pool[[k1]])
    if layout == "packed":
        TE._insert_core_packed(st, tab, TE._pack_keys(stored, st.W),
                               torch.tensor([77]), torch.tensor([(900 << st.nb) | 1]))
    else:
        TE._insert_core(st, tab, TE._pack_keys(stored, st.W), torch.tensor([1500]),
                        torch.tensor([2500]), torch.tensor([1]))
    assert int(tab.t_key[home[k1], 0]) != -1
    coords = torch.from_numpy(pool[[k1, k1, k2, k2, k3, k4]])
    tag = torch.tensor([5, 9, 3, 7, 1, 2])
    L = len(tag)
    keys = TE._pack_keys(coords, st.W)
    if layout == "packed":
        args = (keys, coords.sum(1) * 7, torch.tensor([800, 700, 600, 500, 400, 300]) << st.nb
                | torch.tensor([1, 2, 3, 4, 5, 6]))
    else:
        args = (keys, torch.tensor([1400, 1450, 1000, 1001, 1002, 1003]),
                torch.tensor([2400, 2450, 2000, 2001, 2002, 2003]), torch.arange(1, L + 1))
    want = clone(tab)
    insert = TE._insert_core_packed if layout == "packed" else TE._insert_core
    ovf, reopen, acct = insert(st, want, *args, tag)
    pend = entries(st, args, tag, layout)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        got = clone(tab)
        left, settled = k9_home_match(st, got, [pend[k] for k in rng.permutation(L)])
        if layout == "packed":  # K9 settles the stored key's lanes: 4 of 6 pending
            assert sorted(settled) == sorted(pend[:2]) and len(left) == L - 2
            assert int(got.t_best[home[k1]]) == min(pend[0][st.W + 3], pend[1][st.W + 3],
                                                    int(tab.t_best[home[k1]]))
        else:
            assert settled == [] and len(left) == L
        rounds, counts, ereopen, _ = emu_k10(st, got, left, rng, lanes=L)
        assert same_table(got, want, st.C)  # claim included
        assert k10_acct(L, rounds, counts) == acct.tolist() and int(ovf) == 0
        assert ereopen == int(reopen)
        # after round 0 only the key behind the stored one is open
        assert counts[0] == 1 and rounds >= 2
    assert int(want.claim[home[k2]]) == 3 and int(want.claim[home[k4]]) == 2
    assert want.t_key[home[k2], :st.W].tolist() == TE._as_i32(keys[2]).tolist()


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_n10_steps_equal_plain_step(layout):
    # N = 10, 1023 masks a row: K3 -> K9 -> K10 emulated for two steps
    # from a mid-search table against the plain step (tables and counters)
    seqs = random_seqs(10, 10, 8, 14)
    eng, tab, ctr = mid_search(seqs, layout, "off", 16, 1 << 14, 2)
    st = eng.st
    a, b = clone(tab), clone(tab)
    ca = TE._run_chunk_plain(st, a, ctr, 2, eng.ub, eng.fill_target, layout)
    cb = emu_chunk(st, b, ctr, 2, eng.ub, eng.fill_target, np.random.default_rng(4))
    assert ca.tolist() == cb.tolist() and same_table(a, b, st.C)
    assert int(ca[2]) == int(ctr[2]) + 2 and int(ca[9]) - int(ctr[9]) > 1023


# ----------------------------------------------------------------------- K10

def emu_k10(st, tab, pend, rng, blocks=132, cap=TS.K10_CAP, lanes=None, n_front=0,
            claims=None):
    """csrc/keyrow_insert.cu on the pending list ``pend`` (K9's entries; of
    ``lanes`` surviving lanes, default all of them: round 0 runs when there
    is one, over the list; the first ``n_front`` entries are received rows,
    which claim with their places), in place.  A list of at most ``cap``
    (> 0) entries takes the whole-list block path: block 0 alone, thread t
    holding the lanes t + k x 512, runs every round from round 0 (each
    phase visits the threads in a random order), no grid sync, and then
    (unpacked) the decrease-key in the block.  A longer list: ``blocks``
    blocks whose threads stride over the list; round 0's reads (grid sync),
    its claim winners' writes (grid sync), its losers' re-reads merged with
    round 1's reads, each lane left appending itself to the tail list (grid
    sync); then, when the tail holds at most ``cap`` lanes, block 0 alone
    runs rounds 1, 2, ... over it, a thread holding the tail's places
    tid + k x 512, else every round on the grid as round 0, two grid syncs
    a round; then (unpacked; after the tail's block path a grid sync
    first) the g min, the (f, parent) reset and state, (grid sync) the
    (f, parent) min of the winners.  Each grid phase visits the threads of
    every block in a random order.  ``claims``, a dict, counts the claims
    of each (round, slot).  Returns (rounds, unsettled after each round,
    reopens, grid syncs)."""
    C, W = st.C, st.W
    unpacked = isinstance(tab, TE.UnpackedTable)
    key, claim = tab.t_key.numpy(), tab.claim.numpy()
    n = len(pend)
    stride = blocks * K10_THREADS
    lane_slot, lane_flag = [0] * n, [0] * n

    def tag_of(i):
        return i if i < n_front else pend[i][W + 1]

    def phase(fn):
        for t in rng.permutation(min(n, stride)).tolist():
            for i in range(t, n, stride):
                fn(i)

    def holds(slot, e):
        return key[slot, :W].tolist() == list(e[:W])

    def slot_of(e, r):
        return (e[W] & M32) + (r * (r + 1) >> 1) & (C - 1)

    def settle(i, slot):
        e = pend[i]
        lane_slot[i] = slot
        flag = 0
        if unpacked:
            if e[W + 2] < int(tab.t_g[slot]):
                flag = 2 | (4 if int(tab.t_state[slot]) == 2 else 0)
        else:
            tab.t_best[slot] = min(int(tab.t_best[slot]), e[W + 3])
        lane_flag[i] = flag

    def probe(i, r):
        e = pend[i]
        slot = slot_of(e, r)
        if key[slot, 0] != -1:
            if holds(slot, e):
                return settle(i, slot)
            lane_flag[i] = 0
        else:
            claim[slot] = min(int(claim[slot]), tag_of(i))
            lane_flag[i] = 1
            if claims is not None:
                claims[r, slot] = claims.get((r, slot), 0) + 1
        lane_slot[i] = -1

    def write(i, r):
        e = pend[i]
        if lane_flag[i] != 1:
            return
        slot = slot_of(e, r)
        if claim[slot] == tag_of(i):
            key[slot, :W] = e[:W]
            if not unpacked:
                key[slot, W] = e[W + 2]
            settle(i, slot)

    def reread(i, r, left, tail):
        if lane_slot[i] >= 0:
            return
        e = pend[i]
        if lane_flag[i] == 1 and holds(slot_of(e, r), e):
            return settle(i, slot_of(e, r))
        left[0] += 1
        if tail is not None:
            tail.append(i)  # its place: the order of the appends
        if r + 1 < st.max_probes:
            probe(i, r + 1)

    def block_phase(held, fn):
        for t in rng.permutation(K10_THREADS).tolist():
            for i in held[t]:
                fn(i)

    def block_rounds(held, r):
        counts = []
        while True:
            block_phase(held, lambda i: write(i, r))
            left = [0]
            block_phase(held, lambda i: reread(i, r, left, None))
            counts.append(left[0])
            if left[0] == 0 or r + 1 >= st.max_probes:
                return r + 1, counts
            r += 1

    rounds, counts, syncs, block = 0, [], 0, False
    whole = bool(cap) and n <= cap
    active = n > 0 or bool(lanes)  # round 0 runs, over the list
    if active and whole:
        # block 0: thread t holds list places t + k * 512, k < kLanes
        assert n <= K10_THREADS * K10_LANES
        held = [list(range(t, n, K10_THREADS)) for t in range(K10_THREADS)]
        block_phase(held, lambda i: probe(i, 0))
        rounds, counts = block_rounds(held, 0)
    elif active:
        phase(lambda i: probe(i, 0))
        syncs += 1
        tail, r = [], 0
        while True:
            phase(lambda i: write(i, r))
            left = [0]
            phase(lambda i: reread(i, r, left, tail if r == 0 else None))
            syncs += 2
            counts.append(left[0])
            rounds = r + 1
            if left[0] == 0 or rounds >= st.max_probes:
                break
            if r == 0 and left[0] <= cap:
                block = True
                break
            r += 1
        if block:
            # block 0: thread t holds tail places t + k * 512, k < kLanes
            assert len(tail) <= K10_THREADS * K10_LANES
            rounds, more = block_rounds([tail[t::K10_THREADS] for t in range(K10_THREADS)], 1)
            counts += more
            syncs += unpacked  # the decrease-key waits for block 0
    reopen = 0
    if unpacked and rounds:
        improved = [i for i in range(n) if lane_slot[i] >= 0 and lane_flag[i] & 2]
        for i in rng.permutation(improved).tolist():
            s_ = lane_slot[i]
            tab.t_g[s_] = min(int(tab.t_g[s_]), pend[i][W + 2])
            tab.t_fpar[s_] = 2**63 - 1
            tab.t_state[s_] = 1
            reopen += bool(lane_flag[i] & 4)
        syncs += not whole  # in the block: its barrier
        for i in rng.permutation(improved).tolist():
            s_, e = lane_slot[i], pend[i]
            if int(tab.t_g[s_]) == e[W + 2]:
                fpar = (e[W + 4] << 32) | (e[W + 3] & M32)
                tab.t_fpar[s_] = min(int(tab.t_fpar[s_]), fpar)
    return rounds, counts, reopen, syncs


def k10_acct(n, rounds, counts):
    """Counter slots 9-13 of an insert as K10's finish forms them."""
    return [n, n, max(rounds - 1, 0) * n, counts[0] if rounds >= 1 else 0,
            counts[1] if rounds >= 2 else 0]


def k10_finish(c, fmin, n_open, n_sel, reopen, fill, lanes, rounds, counts):
    """The 14 counters ``c`` (a list, in place) after K10, as its last
    thread writes them (step::finish_step): the step's f-min, open and
    selected rows and reopens, ``lanes`` K9's survivors, then the insert's
    rounds and unsettled counts.  Returns the run flag."""
    c[1] = fmin
    c[2] += 1
    c[3] += n_sel
    c[4] += reopen
    c[5] = n_open
    c[6] += counts[-1] if rounds else 0
    thr = c[7]
    nt = thr * 2 + 32 if n_sel < fill // 2 else (thr // 2 if n_sel >= fill - fill // 8 else thr)
    c[7] = min(nt, 1 << 20)
    c[8] += n_sel
    for k, v in zip(range(9, 14), k10_acct(lanes, rounds, counts)):
        c[k] += v
    return c[1] < c[0] and c[6] == 0


def key_lanes(st, rs, stored, n_new, layout):
    """Insert lanes as K9's pending entries: stored keys, new keys (among
    them keys that share a home slot), duplicates of both; unique tags in
    random order; packed h and word, or unpacked g and f * 2^n + mask (g
    in a narrow band: improvements, ties)."""
    final = st.final_np
    pool = np.unique(np.stack([rs.randint(0, int(v) + 1, size=4 * n_new + 50) for v in final],
                              1), axis=0)
    home = TE._hash_keys(TE._pack_keys(torch.from_numpy(pool), st.W)).numpy() & (st.C - 1)
    homes, cnt = np.unique(home, return_counts=True)
    shared = np.concatenate([pool[home == h][:3] for h in homes[cnt >= 2][:10]]
                            or [pool[:0]])
    fresh = pool[rs.choice(len(pool), n_new, replace=False)]
    distinct = np.concatenate([stored, shared, fresh]) if len(stored) else np.concatenate(
        [shared, fresh])
    coords = np.repeat(distinct, rs.randint(1, 4, size=len(distinct)), axis=0)
    L = len(coords)
    keys = TE._pack_keys(torch.from_numpy(coords), st.W)
    tag = torch.from_numpy(rs.permutation(4 * L)[:L])
    if layout == "packed":
        a = torch.from_numpy(coords.sum(1) * 7)  # h, a function of the key
        b = torch.from_numpy((rs.randint(0, 4000, size=L) << st.nb) | rs.randint(1, st.M + 1,
                                                                                size=L))
        args = (keys, a, b)
    else:
        g = torch.from_numpy(rs.randint(1000, 1100, size=L))
        f = g + 1000 + torch.from_numpy(rs.randint(0, 3, size=L))
        args = (keys, g, f, torch.from_numpy(rs.randint(1, st.M + 1, size=L)))
    return args, tag


def entries(st, args, tag, layout):
    """The K9 pending entries of insert arguments."""
    keys = args[0]
    cols = [TE._as_i32(keys), TE._as_i32(TE._hash_keys(keys))[:, None], tag[:, None]]
    if layout == "packed":
        cols += [args[1][:, None], args[2][:, None]]
    else:
        fpar = args[2] * (1 << st.nb) + args[3]
        cols += [args[1][:, None], TE._as_i32(fpar & M32)[:, None], (fpar >> 32)[:, None]]
    return [tuple(r) for r in torch.cat([c.long() for c in cols], 1).tolist()]


def keyrow_table(jst, st, rs, layout, n_keys):
    """A key-row table about n_keys / C full (plain inserts of random keys
    with tags from 0), and the coordinates it holds."""
    C, size = st.C, st.C + TE.TRASH
    if layout == "packed":
        tab = TE.PackedTable(torch.full((size, st.KW), -1, dtype=torch.int32),
                             torch.full((size,), INFP, dtype=torch.int32),
                             torch.full((size,), INFP, dtype=torch.int32),
                             torch.full((size,), INFP, dtype=torch.int32))
    else:
        tab = TE.UnpackedTable(torch.full((size, st.W), -1, dtype=torch.int32),
                               torch.full((size,), INF, dtype=torch.int32),
                               torch.full((size,), INF << st.nb, dtype=torch.int64),
                               torch.zeros(size, dtype=torch.int32),
                               torch.full((size,), INFP, dtype=torch.int32))
    if not n_keys:
        return tab, np.zeros((0, st.n), dtype=np.int64)
    coords = np.unique(np.stack([rs.randint(0, int(v) + 1, size=n_keys) for v in jst.final_np],
                                1), axis=0)
    keys = TE._pack_keys(torch.from_numpy(coords), st.W)
    L = len(coords)
    if layout == "packed":
        ovf, _, _ = TE._insert_core_packed(st, tab, keys, torch.from_numpy(coords.sum(1) * 7),
                                           torch.from_numpy(rs.randint(0, 4000, size=L) << st.nb
                                                            | 1))
    else:
        g = torch.from_numpy(rs.randint(1000, 1100, size=L))
        ovf, _, _ = TE._insert_core(st, tab, keys, g, g + 500, torch.ones(L, dtype=torch.int64))
        # a third of the stored keys closed: their improvements are reopens
        tab.t_state[:C][(tab.t_state[:C] == 1) & (torch.rand(C) < 0.33)] = 2
    assert int(ovf) == 0
    return tab, coords


@pytest.mark.parametrize("cap", [0, TS.K10_CAP])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("case", ["mid", "empty-table", "no-lanes", "overflow"])
def test_k10_rounds_equal_plain_insert(layout, case, cap):
    jst, st = statics(golden_seqs("kinase.fasta"), 64, 1 << 8 if case == "overflow" else 1 << 10)
    rs = np.random.RandomState({"mid": 1, "empty-table": 2, "no-lanes": 3, "overflow": 4}[case])
    torch.manual_seed(0)
    tab, stored = keyrow_table(jst, st, rs, layout, 0 if case == "empty-table" else
                               {"overflow": 120}.get(case, 410))
    args, tag = key_lanes(st, rs, stored[rs.choice(len(stored), min(150, len(stored)),
                                                   replace=False)] if len(stored) else stored,
                          {"overflow": 400}.get(case, 100), layout)
    if case == "no-lanes":
        args, tag = tuple(a[:0] for a in args), tag[:0]
    want = clone(tab)
    insert = TE._insert_core_packed if layout == "packed" else TE._insert_core
    ovf, reopen, acct = insert(st, want, *args, tag)
    pend = entries(st, args, tag, layout)
    for seed, blocks in ((0, 132), (1, 3)):
        rng = np.random.default_rng(seed)
        got = clone(tab)
        order = rng.permutation(len(pend)).tolist()
        # K9's round-0 match first (packed), then K10 on the lanes it left
        left, _ = k9_home_match(st, got, [pend[k] for k in order])
        rounds, counts, ereopen, syncs = emu_k10(st, got, left, rng, blocks, cap,
                                                 lanes=len(pend))
        assert same_table(got, want, st.C)  # claim included
        assert (counts[-1] if rounds else 0) == int(ovf)
        assert k10_acct(len(pend), rounds, counts) == acct.tolist()
        assert ereopen == int(reopen)
        unpacked = layout == "unpacked"
        path = TS.k10_path(len(left), rounds, counts[0] if rounds else 0, cap)
        assert syncs == TS.k10_grid_syncs(rounds, len(left), counts[0] if rounds else 0, cap,
                                          unpacked)
        if cap and rounds and len(left) <= cap:  # the whole list in block 0: no grid sync
            assert path == "block" and syncs == 0
        elif not cap and rounds:  # every round on the grid
            assert path == "grid" and syncs == (2 * rounds + 2 if unpacked else 2 * rounds + 1)
    if case == "no-lanes":
        assert acct.tolist() == [0] * 5 and same_table(want, tab, st.C)
    elif case == "overflow":
        assert int(ovf) > 0 and int(acct[2]) == 127 * len(pend)
    else:
        assert int(ovf) == 0 and int(acct[3]) > 0
        assert int(reopen) > 0 if layout == "unpacked" and case == "mid" else int(reopen) == 0


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_plain_insert_with_content_tags_matches_jax(layout):
    # the plain insert given tags in random order (as the content tags of a
    # step are to a shuffled lane list) against JAX's insert on the key
    # map: keys, h and t_best (packed), or keys, g and state (unpacked);
    # XLA keeps an unspecified racing writer, so slots may differ
    jst, st = statics(golden_seqs("kinase.fasta"), 64, 1 << 10)
    C, W, nb = st.C, st.W, st.nb
    rs = np.random.RandomState(7)
    torch.manual_seed(1)
    tab, stored = keyrow_table(jst, st, rs, layout, 410)
    args, tag = key_lanes(st, rs, stored[rs.choice(len(stored), 150, replace=False)], 100,
                          layout)
    want, jovf = jax_key_map(jst, st, tab, args, layout)
    insert = TE._insert_core_packed if layout == "packed" else TE._insert_core
    ovf, _, _ = insert(st, tab, *args, tag)
    assert int(ovf) == int(jovf) == 0
    assert key_map(st, tab, layout) == want


def jax_key_map(jst, st, tab, args, layout):
    """JAX's insert (_insert_packed / _insert) of the lanes ``args`` into
    ``tab``'s key map, and its overflow: keys -> (h, t_best) packed, (g,
    state) unpacked.  XLA keeps an unspecified racing writer, so only the
    map is compared, not the slots."""
    C, W, nb = st.C, st.W, st.nb
    L = len(args[0])
    key = tab.t_key[:C].numpy().view(np.uint32)
    jkeys = jnp.asarray(args[0].numpy().astype(np.uint32))
    if layout == "packed":
        jtab, jovf, _, _ = JE._insert_packed(
            jst, (jnp.asarray(key), jnp.asarray(tab.t_best[:C].numpy()),
                  jnp.asarray(tab.t_closed[:C].numpy())), jkeys,
            jnp.asarray(args[1].numpy().astype(np.int32)),
            jnp.asarray(args[2].numpy().astype(np.int32)), jnp.ones(L, dtype=bool))
        want = {tuple(r[:W]): (r[W], b) for r, b in zip(
            np.asarray(jtab[0]).view(np.int32).tolist(), np.asarray(jtab[1]).tolist())
            if r[0] != -1}
    else:
        fp = tab.t_fpar[:C].numpy()
        jtab, _, jovf, _ = JE._insert(
            jst, (jnp.asarray(key), jnp.asarray(tab.t_g[:C].numpy()),
                  jnp.asarray((fp >> nb).astype(np.int32)),
                  jnp.asarray((fp & ((1 << nb) - 1)).astype(np.int32)),
                  jnp.asarray(tab.t_state[:C].numpy())), jkeys,
            jnp.asarray(args[1].numpy().astype(np.int32)),
            jnp.asarray(args[2].numpy().astype(np.int32)),
            jnp.asarray(args[3].numpy().astype(np.int32)), jnp.ones(L, dtype=bool))
        want = {tuple(r): (g, s) for r, g, s in zip(
            np.asarray(jtab[0]).view(np.int32).tolist(), np.asarray(jtab[1]).tolist(),
            np.asarray(jtab[4]).tolist()) if r[0] != -1}
    return want, int(jovf)


def key_map(st, tab, layout):
    """The port's table as jax_key_map gives JAX's."""
    C, W = st.C, st.W
    k = tab.t_key[:C].numpy()
    occ = np.nonzero(k[:, 0] != -1)[0]
    if layout == "packed":
        return {tuple(k[s, :W].tolist()): (int(k[s, W]), int(tab.t_best[s])) for s in occ}
    return {tuple(k[s].tolist()): (int(tab.t_g[s]), int(tab.t_state[s])) for s in occ}


# the list lengths around K10_CAP, where the insert changes schedule
K10_LIST_LENGTHS = [0, 1, TS.K10_CAP - 1, TS.K10_CAP, TS.K10_CAP + 1]


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("received", ["none", "some", "only"])
@pytest.mark.parametrize("n", K10_LIST_LENGTHS)
def test_k10_list_length_paths_equal_plain(n, received, layout):
    # K10 over a list of n entries whose first n_front are rows received
    # from other shards (they claim with their places; the sharded step's
    # keyrow_insert_recv), on a table of 2^11 slots about a third full:
    # the whole list in block 0 up to K10_CAP entries (no grid sync),
    # round 0 on the grid above.  Every table word (claim included), the
    # rounds and the 14 counters those of insert_pending_plain and
    # finish_plain, whatever the threads' order; lanes race for one slot
    # and reach round 3; the key map JAX's insert over the same list
    jst, st = statics(golden_seqs("kinase.fasta"), 64, 1 << 11)
    rs = np.random.RandomState(100 + n)
    torch.manual_seed(n)
    tab, stored = keyrow_table(jst, st, rs, layout, 700)
    args, tag = key_lanes(st, rs, stored[rs.choice(len(stored), 300, replace=False)], 700,
                          layout)
    assert len(tag) >= n
    args, tag = tuple(a[:n] for a in args), tag[:n]
    n_front = {"none": 0, "some": n // 3, "only": n}[received]
    tag = tag + n_front  # the self-owned tags lie above the received rows' places
    pend = entries(st, args, tag, layout)
    rows = torch.tensor(pend, dtype=torch.int32).reshape(n, st.W + (4 if layout == "packed"
                                                                     else 5))
    lanes = n - n_front  # the shard's own survivors (kNValid)
    want = clone(tab)
    ovf, reopen, rounds, un, tail = TSH.insert_pending_plain(st, want, layout, rows, n_front)
    fill, k3 = 64, dict(fmin=1200, n_open=900, n_sel=40, reopen=3)
    c0 = TE.fresh_counters()
    c0[0] = 5000
    want_c = torch.tensor(c0, dtype=torch.int64)
    TSH.finish_plain(want_c, [0, k3["n_open"], k3["n_sel"], k3["reopen"] + reopen, k3["fmin"]],
                     fill, lanes, ovf, rounds, un, tail)
    for seed, blocks in ((0, 132), (1, 3)):
        rng = np.random.default_rng(seed)
        got, claims = clone(tab), {}
        e_rounds, counts, e_reopen, syncs = emu_k10(st, got, pend, rng, blocks, lanes=lanes,
                                                    n_front=n_front, claims=claims)
        assert same_table(got, want, st.C)  # claim included
        c = list(c0)
        k10_finish(c, k3["fmin"], k3["n_open"], k3["n_sel"], k3["reopen"] + e_reopen, fill,
                   lanes, e_rounds, counts)
        assert c == want_c.tolist() and e_rounds == rounds
        path = TS.k10_path(n, rounds, counts[0] if rounds else 0, TS.K10_CAP)
        assert syncs == TS.k10_grid_syncs(rounds, n, counts[0] if rounds else 0, TS.K10_CAP,
                                          layout == "unpacked")
        if n == 0:
            assert path == "none" and rounds == 0
        elif n <= TS.K10_CAP:
            assert path == "block" and syncs == 0
        else:
            assert path in ("tail", "grid") and syncs >= 3
        if n >= TS.K10_CAP - 1:
            assert max(claims.values()) >= 2 and rounds >= 4 and ovf == 0
    if n:
        want_map, jovf = jax_key_map(jst, st, tab, args, layout)
        assert jovf == ovf == 0 and key_map(st, want, layout) == want_map


# ---------------------------------------------------------------- the step loop

def emu_chunk(st, tab, counters, chunk_steps, ub, fill, rng):
    """search/step.py::run_chunk_keyrow_cuda with K3, K9 and K10 emulated:
    the run flag of a chunk starts from f-min 0, K10's last thread writes
    the counters (step::finish_step) and the flag, every kernel skips
    while it reads 0."""
    c = counters.tolist()
    c[1] = 0
    run = c[0] > 0 and c[6] == 0
    ks = KernelStatics(st)
    for _ in range(chunk_steps):
        if not run:
            continue
        _, _, _, fmin, n_open, n_sel, reopen, sel = emu_k3(st, tab, c[0], c[7], rng=rng)
        c[0], pend, n_valid, _ = emu_k9(ks, tab, sel, c[0], ub, rng)
        rounds, counts, ins_reopen, _ = emu_k10(st, tab, pend, rng, lanes=n_valid)
        run = k10_finish(c, fmin, n_open, n_sel, reopen + ins_reopen, fill, n_valid, rounds,
                         counts)
    return torch.tensor(c, dtype=torch.int64)


# each search widened by an upper bound ``loose`` above the engine's (still
# admissible) and kept in a table small enough for collisions: multi-round
# probes, claim races, reopens
@pytest.mark.parametrize("name,layout,batch,chunk,capacity,loose", [
    ("test.fasta", "packed", 16, 3, 1 << 12, 100000),  # N = 8: 8 passes of a warp
    ("test2.fasta", "packed", 32, 7, 1 << 11, 8000),
    ("test2.fasta", "unpacked", 32, 16, 1 << 11, 12000),
    ("near5x130", "packed", 64, 16, 1 << 12, 3000),
    ("degenerate", "unpacked", 16, 16, 1 << 10, 0)])
def test_chunks_equal_plain_loop(name, layout, batch, chunk, capacity, loose):
    seqs = {"near5x130": near_identical(), "degenerate": ("WYWY", "WYY", "YWW")}.get(
        name) or golden_seqs(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = TE.FrontierSearch(Problem(seqs), both_hpair(seqs)[1], device="cpu", batch=batch,
                                capacity=capacity, triples="off",
                                layout="auto" if name == "degenerate" else layout)
    st, ub = eng.st, eng.ub + loose
    assert eng.layout == layout
    a = eng._init_table()
    b = clone(a)
    ca = cb = torch.as_tensor(TE.fresh_counters())
    rng = np.random.default_rng(3)
    for _ in range(60):
        ca = TE._run_chunk_plain(st, a, ca, chunk, ub, eng.fill_target, layout)
        cb = emu_chunk(st, b, cb, chunk, ub, eng.fill_target, rng)
        assert ca.tolist() == cb.tolist()
        assert same_table(a, b, st.C)
        if ca[1] >= ca[0] or ca[6] > 0:
            break
    assert ca[1] >= ca[0] and int(ca[6]) == 0
    assert int(ca[11]) > 0 and int(ca[12]) > 0  # lanes probed past round 1
    if name in GOLD:
        assert int(ca[0]) == GOLD[name]["optimal_g"]


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_content_tags_leave_the_plain_tables_as_lane_indices(layout, monkeypatch):
    # the plain loop with the content tag and with lane-index tags (the
    # tag argument dropped): the same tables and counters, and claim words
    # at the same slots
    seqs = golden_seqs("test2.fasta")
    eng = TE.FrontierSearch(Problem(seqs), both_hpair(seqs)[1], device="cpu", batch=32,
                            capacity=1 << 11, triples="off", layout=layout)
    st, ub = eng.st, eng.ub + 12000

    def run():
        tab = eng._init_table()
        ctr = TE._run_chunk_plain(st, tab, torch.as_tensor(TE.fresh_counters()), 400, ub,
                                  eng.fill_target, layout)
        return tab, ctr

    a, ca = run()
    fns = TE._LAYOUT_FNS[layout]
    monkeypatch.setitem(TE._LAYOUT_FNS, layout, fns._replace(
        candidates=lambda *args: fns.candidates(*args[:5])))
    b, cb = run()
    assert ca.tolist() == cb.tolist() and int(ca[11]) > 0 and int(ca[0]) == 45037
    for name, x in vars(a).items():
        y = getattr(b, name)
        if name == "claim":
            assert torch.equal(x[:st.C] == INFP, y[:st.C] == INFP)
            assert not torch.equal(x[:st.C], y[:st.C])
        else:
            assert torch.equal(x[:st.C], y[:st.C]), name


# ----------------------------------------- constants, refusals, the graph

def test_keyrow_constants_match_source():
    k3 = open(os.path.join(CSRC, "select_best.cu")).read()
    for name, value in (("kThreads", K3_THREADS), ("kItems", K3_ITEMS)):
        assert f"constexpr int {name} = {value};" in k3
    assert "constexpr uint32_t kBias = 0x80000000u;" in k3
    assert "constexpr long long kInf = 1 << 30;" in open(os.path.join(CSRC, "step_state.cuh")).read()
    assert INF == 1 << 30
    k9 = open(os.path.join(CSRC, "keyrow_expand.cu")).read()
    assert "constexpr int kMaxW = 8;" in k9 and TS.K9_MAX_N == 16
    assert "const int PW = W + (kUnpacked ? 5 : 4);" in k9
    assert f"constexpr int kMaxThreads = {TS.K9_MAX_THREADS};" in k9
    k10 = open(os.path.join(CSRC, "keyrow_insert.cu")).read()
    assert f"constexpr int kThreads = {K10_THREADS};" in k10
    assert f"constexpr int kLanes = {K10_LANES};" in k10
    assert "constexpr int kCap = kThreads * kLanes;" in k10
    assert TS.K10_CAP == K10_THREADS * K10_LANES
    assert "launch<true, 1>(t, pend, W + 5," in k10
    for vec in (1, 4):  # packed key rows a word at a time, or in int4 where aligned
        assert f"launch<false, {vec}>(t, pend, W + 4," in k10
    st = statics(golden_seqs("PF08184.fasta"), 64, 1 << 12)[1]
    for layout, words in (("packed", st.W + 4), ("unpacked", st.W + 5)):
        bufs = TS.StepBuffers.for_step(st, torch.device("cpu"), layout)
        assert bufs.pend.shape == (st.B * st.M, words) and bufs.lane_word is None
        assert bufs.tail.shape == (TS.K10_CAP,)


@pytest.mark.parametrize("B,M,blocks,threads,passes", [
    (8192, 31, 132 * 16, 32, 1),     # kinase unpacked: a warp a row
    (1024, 63, 1024, 64, 1),         # globin6: two warps a row
    (4096, 127, 132 * 8, 128, 1),    # synth7
    (512, 1023, 512, 256, 4),        # synth10: 4 passes of 256 threads
    (1024, 1023, 132 * 4, 256, 4),
    (16, 65535, 16, 256, 256),       # N = 16
    (16, 3, 16, 32, 1)])
def test_k9_launch_shape(B, M, blocks, threads, passes):
    assert TS.k9_launch_shape(B, M) == (blocks, threads, passes)
    # every mask has a thread, and no pass is idle
    assert threads * (passes - 1) < M <= threads * passes
    assert threads % 32 == 0 and threads <= TS.K9_MAX_THREADS
    # the grid is resident at once: 1024 threads (64 registers each) and
    # at most 16 blocks a multiprocessor
    assert blocks * threads <= 132 * 1024 and blocks <= 132 * TS.K9_BLOCKS_AN_SM
    assert TS.k9_launch_shape(B, M, sms=114)[0] == min(B, 114 * min(16, 1024 // threads))


def test_keyrow_wrappers_refuse():
    seqs = golden_seqs("PF08184.fasta")
    jst, st = statics(seqs, 64, 1 << 12)
    ctr = torch.as_tensor(TE.fresh_counters())
    for layout in ("packed", "unpacked"):
        tab = keyrow_table(jst, st, np.random.RandomState(0), layout, 0)[0]
        with pytest.raises(ValueError):  # CPU tensors
            TS.run_chunk_keyrow_cuda(st, tab, ctr, 1, 10**6, 32)
    with pytest.raises(ValueError, match="PackedTable or an UnpackedTable"):
        sig = TE.SigTable(*(torch.full((st.C + TE.TRASH,), -1, dtype=torch.int32)
                            for _ in range(3)))
        TS.run_chunk_keyrow_cuda(st, sig, ctr, 1, 10**6, 32)
    with pytest.raises(ValueError):
        TS.run_chunk_sig_cuda(st, tab, ctr, 1, 10**6, 32)
    with pytest.raises(ValueError):
        TS.select_open_cuda(st, tab.t_state, tab.t_fpar, 10, 0)
    # statics the kernels do not take (checked before any tensor): N = 17,
    # more sequences than K9's key words hold; B x M at 2^31 (the tags)
    for n, B, match in ((17, 16, "at most 16 sequences"), (16, 1 << 16, "below 2")):
        odd = types.SimpleNamespace(n=n, B=B, M=(1 << n) - 1, C=1 << 20, W=(n + 1) // 2,
                                    KW=(n + 3) // 2)
        with pytest.raises(ValueError, match=match):
            TS.run_chunk_keyrow_cuda(odd, tab, ctr, 1, 10**6, 32)
    # the dispatch: a CPU table runs the plain select
    tab = open_table(st, np.random.RandomState(4))
    a, b = clone(tab), clone(tab)
    got = TE._select_open(st, a.t_state, a.t_fpar, torch.tensor(INF), torch.tensor(40))
    want = TE._select_open_plain(st, b.t_state, b.t_fpar, torch.tensor(INF), torch.tensor(40))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


KEYROW_KERNELS = ("select_best", "select_best_unpacked", "keyrow_expand", "keyrow_insert")


class StubKernels:
    """The step kernels' C entries as Python functions on CPU memory (the
    pointers of CPU tensors are host addresses), as in
    tests/test_torch_step.py.  Each records its arguments; while
    ``run_kernels`` is False (a capture) that is all, else K10 runs
    ``step`` (default: a search whose f-min is 10 a step, steps += 1,
    f-min = 10 x steps) when the run flag reads 1, then writes the flag.
    ``dead`` counts the inserts that found the flag at 0."""

    def __init__(self):
        self.calls = {name: [] for name in KEYROW_KERNELS}
        self.run_kernels = True
        self.step = self.ten_a_step
        self.dead = 0

    @staticmethod
    def ten_a_step(ctr):
        ctr[2] += 1
        ctr[1] = 10 * ctr[2]

    def lib(self, name):
        def entry(*cargs):
            self.run(name, tuple(a.value for a in cargs))
            return 0
        return type("Lib", (), {name: staticmethod(entry)})

    def run(self, name, vals):
        self.calls[name].append(vals)
        if not self.run_kernels or name != "keyrow_insert":
            return
        run = ctypes.c_int32.from_address(vals[15])
        if not run.value:
            self.dead += 1
            return
        ctr = (ctypes.c_longlong * TE.N_COUNTERS).from_address(vals[16])
        self.step(ctr)
        run.value = int(ctr[1] < ctr[0] and ctr[6] == 0)


class FakeGraph:
    """torch.cuda.CUDAGraph on the CPU (as in tests/test_torch_step.py):
    the capture records one step's launches with the stubs running none; a
    replay runs the recorded launches, counted nowhere."""

    def __init__(self, fn, stubs):
        self.stubs = stubs
        n0 = {k: len(v) for k, v in stubs.calls.items()}
        stubs.run_kernels = False
        try:
            fn()
        finally:
            stubs.run_kernels = True
        self.recorded = [(k, c) for k, v in stubs.calls.items() for c in v[n0[k]:]]
        self.replays = 0

    def replay(self):
        self.replays += 1
        for name, vals in self.recorded:
            self.stubs.run(name, vals)


@pytest.fixture
def stubbed(monkeypatch):
    stubs, graphs = StubKernels(), []

    def capture(fn):
        graphs.append(FakeGraph(fn, stubs))
        return graphs[-1]

    monkeypatch.setattr(_kernels, "load", stubs.lib)
    monkeypatch.setattr(TS, "_stream", lambda dev: 0)
    monkeypatch.setattr(TS, "_capture", capture)
    saved = dict(_kernels.launches)
    _kernels.reset_counts()
    yield stubs, graphs
    _kernels.launches.update(saved)


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_keyrow_chunk_graph_binds_static_buffers(stubbed, layout):
    stubs, graphs = stubbed
    jst, st = statics(golden_seqs("PF08184.fasta"), 64, 1 << 12)
    tab = keyrow_table(jst, st, np.random.RandomState(0), layout, 0)[0]
    bufs = TS.StepBuffers.for_step(st, torch.device("cpu"), layout)
    ctr = torch.as_tensor(TE.fresh_counters())
    ctr[0] = 95  # the stub search stops at step 10 (f-min 100)
    outs = []
    for _ in range(4):
        ctr = TS._drive_chunk(st, tab, bufs, ctr, 4, 10**6, 32, 0, 0, True)
        outs.append(ctr.tolist())
    assert len(graphs) == 1 and bufs.captures == 1 and graphs[0].replays == 16
    assert [o[2] for o in outs] == [4, 8, 10, 11] and outs[-1][0] == 95
    # the replays after the stop (2, then 3) and the warm-up found the
    # flag at 0
    assert stubs.dead == 1 + 2 + 3
    select = "select_best" if layout == "packed" else "select_best_unpacked"
    names = (select, "keyrow_expand", "keyrow_insert")
    ptr = bufs.counters.data_ptr()
    k10 = stubs.calls["keyrow_insert"]
    k9 = stubs.calls["keyrow_expand"]
    assert {c[16] for c in k10} == {ptr} and {c[25] for c in k9} == {ptr}
    # K9's launch shape (k9_launch_shape on 132 multiprocessors) and, on
    # the packed layout, the t_best its round-0 match writes
    assert {(c[22], c[23]) for c in k9} == {TS.k9_launch_shape(st.B, st.M)[:2]}
    assert {c[4] for c in k9} == {None if layout == "unpacked" else tab.t_best.data_ptr()}
    goal_at = 6 if layout == "packed" else 5  # K3's goal and threshold: views of the counters
    assert {(c[goal_at], c[goal_at + 1]) for c in stubs.calls[select]} == {(ptr, ptr + 56)}
    assert all(c[0] == tab.t_key.data_ptr() and c[4] == tab.claim.data_ptr() for c in k10)
    assert {c[9] for c in k10} == {int(layout == "unpacked")}
    assert bufs.graph.tally == {name: 1 for name in names}
    for name in KEYROW_KERNELS:
        assert _kernels.launches[name] == (1 + 4 * 4 if name in names else 0)
    # a new table of the layout: a new capture; the eager chunk captures
    # nothing and counts each launch
    other = clone(tab)
    TS._drive_chunk(st, other, bufs, ctr, 4, 10**6, 32, 0, 0, True)
    assert bufs.captures == 2 and len(graphs) == 2
    n = _kernels.launches["keyrow_insert"]
    TS._drive_chunk(st, other, bufs, ctr, 3, 10**6, 32, 0, 0, False)
    assert bufs.captures == 2 and _kernels.launches["keyrow_insert"] == n + 3


@pytest.mark.parametrize("layout,chunk", [("packed", 1), ("packed", 7), ("unpacked", 7)])
def test_keyrow_chunk_loop_stops_mid_chunk_as_the_plain_loop(stubbed, layout, chunk):
    # the chunk loop (set-up, then the step graph replayed) over a real
    # search, K10's stand-in one plain step on the table: chunk by chunk to
    # the goal, every table tensor (claim included) and the 14 counters
    # equal the plain loop's, and the replays after the stop change nothing
    stubs, graphs = stubbed
    seqs = golden_seqs("test2.fasta")
    eng = TE.FrontierSearch(Problem(seqs), both_hpair(seqs)[1], device="cpu", batch=32,
                            capacity=1 << 11, triples="off", layout=layout)
    st, ub, fill = eng.st, eng.ub, eng.fill_target
    a = eng._init_table()
    b = clone(a)
    bufs = TS.StepBuffers.for_step(st, torch.device("cpu"), layout)

    def one_plain_step(ctr):
        c = TE._run_chunk_plain(st, b, torch.tensor(list(ctr), dtype=torch.int64), 1, ub,
                                fill, layout)
        for i, v in enumerate(c.tolist()):
            ctr[i] = v

    stubs.step = one_plain_step
    ca = cb = torch.as_tensor(TE.fresh_counters())
    for chunks in range(1, 400):
        ca = TE._run_chunk_plain(st, a, ca, chunk, ub, fill, layout)
        cb = TS._drive_chunk(st, b, bufs, cb, chunk, ub, fill, 0, 0, True)
        assert ca.tolist() == cb.tolist()
        assert same_table(a, b, st.C)
        if ca[1] >= ca[0]:
            break
    assert int(ca[0]) == GOLD["test2.fasta"]["optimal_g"]
    steps = int(ca[2])
    assert graphs[0].replays == chunk * chunks
    assert stubs.dead == 1 + chunk * chunks - steps  # the warm-up's and the stop's
    if chunk == 7:
        assert steps % chunk != 0  # the goal in the middle of a chunk
    assert _kernels.launches["keyrow_insert"] == 1 + chunk * chunks
