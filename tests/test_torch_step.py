"""The sig search step of the port on the CPU: the plain step functions
against the JAX engine, and NumPy emulations of the step kernels K3
(csrc/select_best.cu), K4 (csrc/sig_expand.cu) and K5 (csrc/sig_probe.cu)
against the plain step (all values exact integers: zero tolerance).

- ``_insert_sig`` against JAX ``_insert_sig`` on a table about 40% full,
  with duplicate keys and colliding homes (the stored key -> t_best maps:
  XLA keeps an unspecified racing writer, so slots may differ);
- a random permutation of the lanes leaves the insert's table, overflow
  and counters bit-identical (the kernels collect their lanes with
  atomics, in no fixed order);
- K5's schedule: every call's reads, then its writes, lanes visited in a
  random order within each phase, unsigned min on the words, gives the
  plain insert's table and counters, also on an overflowing table;
- K4's schedule (warps over K3's compact list in a random order, masks in
  passes of 32 lanes) with its per-pair cost, the goal found before the
  prune and the round-0 row match, against the plain
  _expand -> prune -> _candidates_sig -> round 0 and against JAX
  _expand / _sig_encode, at N = 3 to 6;
- K3's schedule (lanes, warps and blocks of the read pass, per-block
  partials, the last block's cut and compact list) against
  _select_best_plain and JAX _select_sig, at G = 1 to 1024 slots a group;
- the step loop with its run flag on the device (K6) against
  _run_chunk_plain, chunk by chunk to the goal; the chunk graph's host
  logic with stub C entries and a fake CUDA graph (one captured step
  replayed chunk_steps times, the stop in the middle of a chunk against
  the plain loop) and the chunk's set-up;
- every word _sig_encode can store at kinase's and PF08184's widths is
  below 2^31;
- the wrappers refuse CPU tensors and non-sig tables.
"""
import ctypes
import functools
import json
import os

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
from mpi_pastar_msa_tpu_torch.core.problem import Problem, problem_from_fasta
from mpi_pastar_msa_tpu_torch.heuristic import triples as TT
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.search import engine as TE
from mpi_pastar_msa_tpu_torch.search import step as TS

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))
M32 = 0xFFFFFFFF
INFP = TE.INFP


def golden_seqs(name):
    return tuple(r.replace("-", "") for r in GOLD[name]["alignment"])


@functools.lru_cache(maxsize=None)
def both_hpair(seqs):
    jh = JHPair.build(JProblem(seqs), backend="host")
    th = HPairHeuristic.from_numpy(Problem(seqs), jh.tables, jh.weight_f,
                                   jh.weight_i)
    return jh, th


@functools.lru_cache(maxsize=None)
def both_cubes(seqs):
    jh, th = both_hpair(seqs)
    jh3 = JT.HTriples.build(jh)
    th3 = TT.HTriples.from_numpy(th, jh3.triangles, jh3.tri_weights,
                                 np.asarray(jh3.tri_tabs), jh3.cost_scale)
    return jh3, th3


def statics(seqs, batch, capacity, triples="off"):
    jh, th = both_cubes(seqs) if triples == "auto" else both_hpair(seqs)
    return (JE._Static(JProblem(seqs), jh, batch, capacity),
            TE._Static(Problem(seqs), th, batch, capacity, "cpu"))


def random_coords(rs, final, k):
    return np.stack([rs.randint(0, int(v) + 1, size=k) for v in final],
                    axis=1).astype(np.int64)


def empty_table(st):
    size = st.C + TE.TRASH
    return TE.SigTable(torch.full((size,), -1, dtype=torch.int32),
                       torch.full((size,), INFP, dtype=torch.int32),
                       torch.full((size,), INFP, dtype=torch.int32))


def clone(tab):
    return TE.SigTable(tab.t_sig.clone(), tab.t_best.clone(), tab.t_closed.clone())


def same_table(a, b, C):
    return all(torch.equal(getattr(a, k)[:C], getattr(b, k)[:C])
               for k in ("t_sig", "t_best", "t_closed"))


def lanes_for(st, coords, rs):
    """(home, sig base, packed) of coordinates with random packed words."""
    home, sigb = TE._sig_encode(st, torch.from_numpy(coords))
    packed = torch.from_numpy((rs.randint(0, 4000, size=len(coords)) << st.nb)
                              | rs.randint(1, st.M + 1, size=len(coords)))
    return home, sigb, packed


def prefilled(st, rs, n_keys):
    """A sig table holding about n_keys random keys, inserted by the plain
    insert in batches, and the coordinates it holds."""
    tab = empty_table(st)
    coords = np.unique(random_coords(rs, st.final_np, n_keys), axis=0)
    for part in np.array_split(coords, 4):
        ovf, _, _ = TE._insert_sig(st, tab, *lanes_for(st, part, rs))
        assert int(ovf) == 0
    return tab, coords


def insert_batch(st, rs, old, n_new=300):
    """Lane coordinates of an insert batch: stored keys, new keys (among
    them groups that share one home bucket) and duplicates of both, in
    random order."""
    stored = {tuple(c) for c in old.tolist()}
    pool = np.unique(random_coords(rs, st.final_np, 20000), axis=0)
    pool = pool[[tuple(c) not in stored for c in pool.tolist()]]
    home = TE._sig_encode(st, torch.from_numpy(pool))[0].numpy()
    homes, counts = np.unique(home, return_counts=True)
    # 12 keys each from 5 crowded homes: more than a bucket's 8 ways
    crowded = rs.permutation(homes[counts >= 12])[:5]
    colliding = np.concatenate([pool[home == h][:12] for h in crowded])
    fresh = pool[rs.choice(len(pool), n_new, replace=False)]
    distinct = np.concatenate([old[rs.choice(len(old), 150, replace=False)],
                               colliding, fresh])
    lanes = np.repeat(distinct, rs.randint(1, 4, size=len(distinct)), axis=0)
    return lanes[rs.permutation(len(lanes))]


def key_map(st, tab):
    """{coordinate: t_best word} over the occupied ways of a sig table."""
    C = st.C
    occ = torch.nonzero(tab.t_sig[:C] != -1)[:, 0]
    dec = TE._sig_decode(st, occ, tab.t_sig[occ])
    return {tuple(c): int(w) for c, w in zip(dec.tolist(), tab.t_best[occ].tolist())}


# ------------------------------------------------------ plain against JAX

def test_insert_sig_matches_jax():
    jst, tst = statics(golden_seqs("test2.fasta"), 64, 1 << 12)
    rs = np.random.RandomState(21)
    tab, old = prefilled(tst, rs, 1700)
    full = int((tab.t_sig[: tst.C] != -1).sum()) / tst.C
    assert 0.35 < full < 0.45
    lanes = insert_batch(tst, rs, old)
    home, sigb, packed = lanes_for(tst, lanes, rs)
    L = len(lanes)
    jtab = (jnp.asarray(tab.t_sig[: tst.C].numpy().view(np.uint32).reshape(-1, 8)),
            jnp.asarray(tab.t_best[: tst.C].numpy()),
            jnp.asarray(tab.t_closed[: tst.C].numpy()))
    (jsig, jbest, _), jovf, _, jacct = JE._insert_sig(
        jst, jtab, jnp.asarray(home.numpy().astype(np.uint32)),
        jnp.asarray(sigb.numpy().astype(np.uint32)), jnp.zeros(L, jnp.int32),
        jnp.asarray(packed.numpy().astype(np.int32)), jnp.ones(L, dtype=bool))
    ovf, reopen, acct = TE._insert_sig(tst, tab, home, sigb, packed)
    assert int(ovf) == int(jovf) == 0 and int(reopen) == 0
    # true lanes and round-0 unmatched lanes: the same counts
    assert int(acct[0]) == int(jacct[0]) == L
    assert int(acct[3]) == int(jacct[3]) > 0
    want = key_map(tst, TE.SigTable(
        torch.from_numpy(np.array(jsig).reshape(-1).view(np.int32)),
        torch.from_numpy(np.array(jbest)), tab.t_closed[: tst.C]))
    got = key_map(tst, tab)
    assert got == want
    assert set(got) == {tuple(c) for c in lanes.tolist()} | {
        tuple(c) for c in old.tolist()}
    # and each key's word is the min of its lanes' and its stored word
    for c, w in zip(map(tuple, lanes.tolist()), packed.tolist()):
        assert got[c] <= w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_sig_independent_of_lane_order(seed):
    _, st = statics(golden_seqs("test2.fasta"), 64, 1 << 11)
    rs = np.random.RandomState(30 + seed)
    tab, old = prefilled(st, rs, 800)
    lanes = insert_batch(st, rs, old)
    home, sigb, packed = lanes_for(st, lanes, rs)
    a, b = clone(tab), clone(tab)
    ra = TE._insert_sig(st, a, home, sigb, packed)
    perm = torch.from_numpy(rs.permutation(len(lanes)))
    rb = TE._insert_sig(st, b, home[perm], sigb[perm], packed[perm])
    assert same_table(a, b, st.C)  # the trash slots past C hold no data
    assert int(ra[0]) == int(rb[0]) and torch.equal(ra[2], rb[2])
    assert int(ra[2][3]) > 0 and int(ra[2][2]) > 0  # the probe ran


# ----------------------------------------- NumPy emulations of the kernels

def mix32(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


# csrc/select_best.cu's kThreads, kVec and kItems, and the read pass's
# lanes a group (test_k3_constants_match_source checks them)
K3_THREADS, K3_VEC, K3_ITEMS = 512, 8, 16
K3_WARPS = K3_THREADS // 32


def k3_lanes(G, aligned=True):
    """(vec, L): the vector path (a warp a group, int4 loads) or L lanes a
    group and 32 / L groups a warp, as select_best's C entry picks them."""
    vec = G % 128 == 0 and aligned
    return vec, 32 if G >= 32 else 1 << (G.bit_length() - 1)


def emu_select(st, sig, best, closed, goal, thr, blocks=132, aligned=True, rng=None):
    """csrc/select_best.cu's schedule, warp by warp and block by block.
    Read pass: each lane's (min word, first index) over its slots (a warp a
    group with 4 slots a lane per int4, or L lanes a group), merged as
    (word << 32 | index) keys, the warp's groups strided over ``blocks``
    blocks of K3_WARPS warps, one (min, open count) partial a block.
    Finish: a random block is last; it reduces the partials, forms the cut
    and flags the groups in rounds of K3_ITEMS a thread, scans the (item,
    warp) counts into list positions and closes the active slots in
    ``closed`` (a NumPy int32 array).  Returns (slots, vmin, active, fmin,
    n_open, n_sel, reopen, sel), sel the compact list (n_sel, 2) of (slot,
    word) in list order."""
    rng = rng or np.random.default_rng(0)
    C, B, nb = st.C, st.B, st.nb
    G = C // B
    w = best[:C].astype(np.int64)
    is_open = (w < closed[:C]) & ((w >> nb) < goal - st.f0)
    v = np.where(is_open, w, INFP).reshape(B, G)
    vec, L = k3_lanes(G, aligned)
    j = np.arange(G)
    lane = (j // 4) % 32 if vec else j % L
    # a lane starts from (INFP, 0) and takes a slot on a strictly smaller
    # word, visiting its slots in index order
    key = np.where(v < INFP, (v.astype(np.uint64) << np.uint64(32)) | j.astype(np.uint64),
                   np.uint64(INFP) << np.uint64(32))
    lanes = 32 if vec else L
    lane_key = np.stack([key[:, lane == k].min(axis=1) for k in range(lanes)], 1)
    kmin = lane_key.min(axis=1)  # the shuffle merge of the lanes' keys
    vmin = (kmin >> np.uint64(32)).astype(np.int64)
    slots = np.arange(B, dtype=np.int64) * G + (kmin & np.uint64(M32)).astype(np.int64)
    opens = is_open.reshape(B, G).sum(axis=1)
    # groups -> warps -> blocks: warp gw takes tasks gw, gw + nw, ...
    gpw = 1 if vec else 32 // L
    nw = blocks * K3_WARPS
    block_of = (np.arange(B) // gpw % nw) // K3_WARPS
    p_min = np.full(blocks, INFP, dtype=np.int64)
    p_cnt = np.zeros(blocks, dtype=np.int64)
    np.minimum.at(p_min, block_of, vmin)
    np.add.at(p_cnt, block_of, opens)
    # the finish, by whichever block takes the last ticket
    order = rng.permutation(blocks)
    gmin, n_open = int(p_min[order].min()), int(p_cnt[order].sum())
    fmin_r = gmin >> nb
    cut = (min(fmin_r + thr + 1, INFP >> nb) << nb) - 1
    active = np.zeros(B, dtype=bool)
    sel = np.zeros((B, 2), dtype=np.int64)
    base = reopen = 0
    t = np.arange(K3_THREADS)
    for r0 in range(0, B, K3_ITEMS * K3_THREADS):
        b = r0 + np.arange(K3_ITEMS)[:, None] * K3_THREADS + t  # (item, thread)
        inside = b < B
        act = inside & (np.where(inside, vmin[np.minimum(b, B - 1)], INFP) <= cut)
        by_warp = act.reshape(K3_ITEMS, K3_WARPS, 32)
        counts = by_warp.sum(axis=2).reshape(-1)  # (item, warp) runs, item-major
        off = base + np.cumsum(counts) - counts
        below = np.cumsum(by_warp, axis=2) - by_warp  # active lanes below
        pos = off.reshape(K3_ITEMS, K3_WARPS, 1) + below
        for bb, at in zip(b[act], pos.reshape(K3_ITEMS, K3_THREADS)[act]):
            active[bb] = True
            s_ = slots[bb]
            reopen += int(closed[s_] < INFP)
            closed[s_] = vmin[bb]
            sel[at] = (s_, vmin[bb])
        base += int(counts.sum())
    vmin = np.where(active, vmin, INFP)
    return (slots, vmin, active, fmin_r + st.f0, n_open, base, reopen, sel[:base])


class KernelStatics:
    """The constants csrc/sig_expand.cu stages, as Python ints."""

    def __init__(self, st):
        self.st = st
        self.xs = [x for x, _ in st.pairs]
        self.ys = [y for _, y in st.pairs]
        self.w = st.d_w.tolist()
        self.wh = st.d_w_h.tolist()
        self.tri = st.d_tri_xyz.tolist() if st.T3 else []
        self.final = st.final_np.tolist()
        self.shift = np.concatenate([[0], np.cumsum(st.bitw)[:-1]]).tolist()
        self.t4 = st.d_tables4.numpy()
        self.cubes = st.d_cubes.numpy() if st.T3 else None


def emu_expand(ks, sig, best, sel, goal, ub, rng):
    """csrc/sig_expand.cu: warps over K3's compact list ``sel`` of (slot,
    word) rows, visited in a random order; a warp decodes its row, stages
    its T8 rows and cube corners, then runs the masks in passes of 32 lanes
    (lanes in a random order within a pass): cost per pair, goal before the
    prune, sig encoding, round-0 match (min into ``best``); a pass's
    unmatched lanes take consecutive places of the pending list, in lane
    order, at one atomic.  Returns (goal, pending lanes [(home, sig base,
    packed)], lanes that survive the prune, per-lane records {(group,
    m): (f, valid, home, sig base)})."""
    st = ks.st
    S, N, nb, f0 = st.S, st.n, st.nb, st.f0
    E, GG, gap_oe = GAP_EXTENSION, GAP_GAP, st.gap_oe
    G = st.C // st.B
    bmask = st.nbuck - 1
    pend, n_valid, lanes = [], 0, {}
    for i in rng.permutation(len(sel)):
        slot, v = int(sel[i][0]), int(sel[i][1])
        word = int(sig[slot]) & M32
        r, khi = word & 63, word >> 6
        home = ((slot >> 3) - r) & bmask
        klo = (((home ^ (mix32(khi) & bmask)) * 0x0E8B2F51) & M32) & bmask
        key = klo | (khi << st.bbits)
        coord = [(key >> ks.shift[k]) & ((1 << st.bitw[k]) - 1) for k in range(N)]
        t8 = []
        for p in range(st.P):
            cx = min(max(coord[ks.xs[p]], 0), S - 2)
            cy = min(max(coord[ks.ys[p]], 0), S - 2)
            t8.append(ks.t4[p * S * S + cx * S + cy, :5].tolist())
        cube = []
        for t, (x, y, z) in enumerate(ks.tri):
            cx, cy, cz = (min(max(coord[a], 0), S - 2) for a in (x, y, z))
            cube.append([int(ks.cubes[t * S ** 3 + ((cx + (q >> 2 & 1)) * S
                                                     + cy + (q >> 1 & 1)) * S
                                       + cz + (q & 1)]) for q in range(8)])
        h_par = sum(t8[p][0] * ks.wh[p] for p in range(st.P)) + sum(c[0] for c in cube)
        par = v & ((1 << nb) - 1)
        g = (v >> nb) + f0 - h_par
        for m0 in range(1, st.M + 1, 32):
            pass_pend = {}
            for lane in rng.permutation(32).tolist():
                m = m0 + lane
                if m > st.M:
                    continue
                cost = h = 0
                for p in range(st.P):
                    bx, by = m >> ks.xs[p] & 1, m >> ks.ys[p] & 1
                    w = ks.w[p]
                    cost += w * (GG + (E - GG) * (bx + by)
                                 + (bx & by) * (t8[p][4] + GG - 2 * E))
                    cost += gap_oe * w * (bx * (1 - by) * (par >> ks.ys[p] & 1)
                                          + (1 - bx) * by * (par >> ks.xs[p] & 1))
                    h += t8[p][2 * bx + by] * ks.wh[p]
                for t, (x, y, z) in enumerate(ks.tri):
                    h += cube[t][4 * (m >> x & 1) + 2 * (m >> y & 1) + (m >> z & 1)]
                child = [coord[k] + (m >> k & 1) for k in range(N)]
                valid = all(c <= f for c, f in zip(child, ks.final))
                is_goal = child == ks.final
                gc = g + cost
                fc = gc + h
                if is_goal:
                    goal = min(goal, gc)  # before the prune
                valid = valid and fc <= ub
                hm = sb = None
                if valid:
                    n_valid += 1
                    ck = sum(c << s for c, s in zip(child, ks.shift))
                    clo, chi = ck & bmask, (ck >> st.bbits) & M32
                    hm = ((clo * 0x9E3779B1) & bmask) ^ (mix32(chi) & bmask)
                    sb = (chi << 6) & M32
                    packed = ((fc - f0) << nb) | m
                    row = [int(x) & M32 for x in sig[hm * 8: hm * 8 + 8]]
                    if sb in row:
                        at = hm * 8 + row.index(sb)
                        best[at] = min(int(best[at]), packed)
                    else:
                        pass_pend[lane] = (hm, sb, packed)
                lanes[(slot // G, m)] = (fc, valid, hm, sb)
            pend += [pass_pend[k] for k in sorted(pass_pend)]
    return goal, pend, n_valid, lanes


K5_THREADS, K5_LANES = 512, 4  # csrc/sig_probe.cu: kThreads, kLanes


def emu_read_row(st, sig, best, lane, cur):
    """sig_probe.cu's read_row: one read of a live lane's bucket row.
    Returns (unsettled, cur, way, word); way is None when the lane writes
    nothing this call, cur -1 once it settled."""
    home, sigb, packed = lane
    r = (cur - home) & (st.nbuck - 1)
    if r >= st.max_bprobes:
        return 1, cur, None, None  # stuck
    word = sigb | r
    row = sig[cur * 8: cur * 8 + 8].tolist()
    if word in row:
        at = cur * 8 + row.index(word)
        best[at] = min(int(best[at]), packed)
        return 0, -1, None, None
    empty = [w for w in range(8) if row[w] == M32]
    if not empty:
        return 1, (cur + 1) & (st.nbuck - 1), None, None
    return 1, cur, empty[mix32(word) % len(empty)], word


def emu_probe(st, sig, best, pend, rng, cap=TS.K5_CAP, blocks=132, max_calls=128,
              scratch=None):
    """csrc/sig_probe.cu on the pending list ``pend`` [(home, sig base,
    packed)], ``sig`` a NumPy uint32 array.  n <= cap: the block path
    (block 0 alone; thread t holds lanes t + k kThreads in registers and
    rebuilds a writing lane's word from the list).  Else the grid path:
    ``blocks`` blocks whose threads stride over the lanes, call 0 taking
    each home from the list, lane state in ``scratch`` = (lane_cur,
    lane_dest, lane_word) arrays that hold a previous step's values.  Each
    call's read phase visits the threads (of every block) in a random
    order, matches min into ``best`` at once, and ends the loop when
    nothing is left unsettled; its write phase then visits them in another
    random order, unsigned min on ``sig``.  Returns (calls, unsettled
    after each call)."""
    n = len(pend)
    counts, calls, undone = [], 0, n
    if n <= cap:
        T = K5_THREADS
        cur = [[pend[t + k * T][0] if t + k * T < n else -1 for k in range(K5_LANES)]
               for t in range(T)]
        while undone > 0 and calls < max_calls:
            ways, left = {}, 0
            for t in rng.permutation(T).tolist():
                for k in range(K5_LANES):
                    if cur[t][k] >= 0:
                        u, cur[t][k], way, _ = emu_read_row(st, sig, best, pend[t + k * T],
                                                            cur[t][k])
                        left += u
                        if way is not None:
                            ways[(t, k)] = way
            counts.append(left)
            calls += 1
            undone = left
            if undone == 0:
                break
            items = list(ways.items())
            for j in rng.permutation(len(items)).tolist():
                (t, k), way = items[j]
                home, sigb, _ = pend[t + k * T]
                word = sigb | ((cur[t][k] - home) & (st.nbuck - 1))
                d = cur[t][k] * 8 + way
                sig[d] = min(int(sig[d]), word)
        return calls, counts
    lane_cur, lane_dest, lane_word = scratch if scratch is not None else (
        [rng.integers(-1, 99) for _ in range(n)] for _ in range(3))
    stride = blocks * K5_THREADS
    owners = range(min(n, stride))
    while undone > 0 and calls < max_calls:
        left = 0
        for g in rng.permutation(len(owners)).tolist():
            for i in range(g, n, stride):
                cur = pend[i][0] if calls == 0 else lane_cur[i]
                if cur < 0:
                    continue  # settled in an earlier call: its dest is -1
                u, cur, way, word = emu_read_row(st, sig, best, pend[i], cur)
                left += u
                lane_cur[i] = cur
                lane_dest[i] = -1 if way is None else cur * 8 + way
                if way is not None:
                    lane_word[i] = word
        counts.append(left)
        calls += 1
        undone = left
        if undone == 0:
            break
        for g in rng.permutation(len(owners)).tolist():
            for i in range(g, n, stride):
                d = lane_dest[i]
                if d >= 0:
                    sig[d] = min(int(sig[d]), lane_word[i])
    return calls, counts


def emu_insert(st, tab, home, sigb, packed, rng, **k5):
    """K4's round 0 and K5 (``k5``: emu_probe's cap and blocks) on given
    lanes (the plain _insert_sig's arguments); returns the plain insert's
    (overflow, acct)."""
    sig = tab.t_sig.numpy().view(np.uint32)
    best = tab.t_best.numpy()
    pend = []
    for i in rng.permutation(len(home)).tolist():
        h, s, p = int(home[i]), int(sigb[i]), int(packed[i])
        row = sig[h * 8: h * 8 + 8].tolist()
        if s in row:
            best[h * 8 + row.index(s)] = min(int(best[h * 8 + row.index(s)]), p)
        else:
            pend.append((h, s, p))
    calls, counts = emu_probe(st, sig, best, pend, rng, **k5)
    L = len(home)
    tail = counts[1] if calls >= 2 else 0
    return counts[-1] if calls else 0, [L, L, calls * L, len(pend), tail]


@pytest.mark.parametrize("seed", [0, 1])
def test_k5_schedule_equals_plain_insert(seed):
    _, st = statics(golden_seqs("test2.fasta"), 64, 1 << 11)
    rs = np.random.RandomState(40 + seed)
    tab, old = prefilled(st, rs, 800)
    home, sigb, packed = lanes_for(st, insert_batch(st, rs, old), rs)
    a, b = clone(tab), clone(tab)
    ovf, _, acct = TE._insert_sig(st, a, home, sigb, packed)
    eovf, eacct = emu_insert(st, b, home, sigb, packed, np.random.default_rng(seed))
    assert same_table(a, b, st.C)
    assert int(ovf) == eovf == 0 and acct.tolist() == eacct
    assert eacct[2] > 0 and eacct[4] >= 0


def test_k5_schedule_equals_plain_insert_on_overflow():
    # a 2^8-slot table (32 buckets of 8 ways) given more keys than it holds:
    # the probe runs its 128 calls and the rest overflows
    _, st = statics(golden_seqs("PF08184.fasta"), 16, 1 << 8)
    assert st.sig_ok
    rs = np.random.RandomState(5)
    coords = np.unique(random_coords(rs, st.final_np, 400), axis=0)
    home, sigb, packed = lanes_for(st, coords, rs)
    a, b = empty_table(st), empty_table(st)
    ovf, _, acct = TE._insert_sig(st, a, home, sigb, packed)
    eovf, eacct = emu_insert(st, b, home, sigb, packed, np.random.default_rng(9))
    assert same_table(a, b, st.C)
    assert int(ovf) == eovf == len(coords) - st.C
    assert acct.tolist() == eacct and eacct[2] == 128 * len(coords)


def pending_lanes(st, rs, old, n):
    """Coordinates of n lanes of new keys (none stored, so none settles in
    round 0: all n are K5's pending lanes), about a third of them
    duplicates, in a random order."""
    stored = {tuple(c) for c in old.tolist()}
    pool = np.unique(random_coords(rs, st.final_np, 2 * n + 100), axis=0)
    pool = pool[[tuple(c) not in stored for c in pool.tolist()]]
    distinct = pool[rs.choice(len(pool), (2 * n + 2) // 3, replace=False)]
    return distinct[rs.randint(0, len(distinct), size=n)]


def jax_insert(jst, tab, C, home, sigb, packed):
    """JAX _insert_sig on a copy of a port table: (key map, overflow, acct)."""
    L = len(home)
    jtab = (jnp.asarray(tab.t_sig[:C].numpy().view(np.uint32).reshape(-1, 8)),
            jnp.asarray(tab.t_best[:C].numpy()), jnp.asarray(tab.t_closed[:C].numpy()))
    (jsig, jbest, _), jovf, _, jacct = JE._insert_sig(
        jst, jtab, jnp.asarray(home.numpy().astype(np.uint32)),
        jnp.asarray(sigb.numpy().astype(np.uint32)), jnp.zeros(L, jnp.int32),
        jnp.asarray(packed.numpy().astype(np.int32)), jnp.ones(L, dtype=bool))
    jt = TE.SigTable(torch.from_numpy(np.array(jsig).reshape(-1).view(np.int32)),
                     torch.from_numpy(np.array(jbest)), tab.t_closed[:C])
    return jt, int(jovf), [int(v) for v in np.array(jacct)]


@pytest.mark.parametrize("n,blocks", [
    (0, 132), (1, 132), (TS.K5_CAP - 1, 132), (TS.K5_CAP, 132), (TS.K5_CAP + 1, 132),
    # the grid path on 3 blocks: up to 14 lanes a thread, in every block
    (20000, 3)])
def test_k5_paths_equal_plain_and_jax(n, blocks):
    # n pending lanes into a 2^15-slot table about 40% full: K5 with its
    # cap (the block path up to K5_CAP lanes, the grid path above) and with
    # cap 0 (the grid path at every n) against the plain insert, and the
    # plain insert against JAX
    jst, st = statics(golden_seqs("test2.fasta"), 64, 1 << 15)
    rs = np.random.RandomState(50)
    tab, old = prefilled(st, rs, 13500)
    home, sigb, packed = lanes_for(st, pending_lanes(st, rs, old, n), rs)
    want = clone(tab)
    ovf, _, acct = TE._insert_sig(st, want, home, sigb, packed)
    assert int(ovf) == 0 and int(acct[3]) == n
    assert n == 0 or int(acct[2]) >= 2 * n  # two calls at least
    for cap in (TS.K5_CAP, 0):
        got = clone(tab)
        eovf, eacct = emu_insert(st, got, home, sigb, packed,
                                 np.random.default_rng(n + cap), cap=cap, blocks=blocks)
        assert same_table(got, want, st.C), cap
        assert eovf == int(ovf) and eacct == acct.tolist(), cap
    if n == 0:
        assert same_table(want, tab, st.C) and acct.tolist() == [0] * 5
        return
    jt, jovf, jacct = jax_insert(jst, tab, st.C, home, sigb, packed)
    assert jovf == int(ovf)
    assert key_map(st, jt) == key_map(st, want)
    # the key -> t_best map, the overflow and the lane counts agree; the
    # calls (slot 2, calls x L on JAX's full-width path, wideA, JAX
    # engine.py:1431) need not: XLA keeps an unspecified one of the writers
    # racing for a way, the port the smallest, so a chain can take another
    # call; JAX counts the tail (slot 4) on its 3L/8 tier alone, 0 here
    a = acct.tolist()
    assert [jacct[k] for k in (0, 1, 3)] == [a[k] for k in (0, 1, 3)] and jacct[4] == 0
    assert jacct[2] % n == 0 and jacct[2] >= 2 * n


def test_k5_constants_match_source():
    src = open(os.path.join(HERE, "..", "mpi_pastar_msa_tpu_torch", "csrc",
                            "sig_probe.cu")).read()
    assert f"constexpr int kThreads = {K5_THREADS};" in src
    assert f"constexpr int kLanes = {K5_LANES};" in src
    assert TS.K5_CAP == K5_THREADS * K5_LANES


def mid_search(seqs, triples, batch, capacity, steps, rs_seed=0):
    """A port engine on the CPU ``steps`` steps into its search."""
    p = Problem(seqs)
    th = (both_cubes(seqs) if triples == "auto" else both_hpair(seqs))[1]
    eng = TE.FrontierSearch(p, th, device="cpu", batch=batch, capacity=capacity,
                            triples=triples)
    assert eng.layout == "sig"
    tab = eng._init_table()
    ctr = TE._run_chunk(eng.st, tab, torch.as_tensor(TE.fresh_counters()), steps,
                        eng.ub, eng.fill_target, "sig")
    return eng, tab, ctr


def family(name):
    """A golden input by name, a tests/data input ("synth6": N = 6, 63
    masks, two passes of a warp), or "randN": N random sequences of 14-22
    residues (N = 4: 15 masks, half a warp)."""
    if name in GOLD:
        return golden_seqs(name)
    if name.startswith("rand"):
        n = int(name[4:])
        rs = np.random.RandomState(n)
        return tuple("".join(rs.choice(list("ACDEFGHIKLMNPQRSTVWY"), size=rs.randint(14, 23)))
                     for _ in range(n))
    return problem_from_fasta(os.path.join(HERE, "data", f"{name}.fasta")).seqs


@pytest.mark.parametrize("name,triples,gap_oe", [
    ("PF08184.fasta", "auto", 0), ("test2.fasta", "off", 0),
    # the gap-open term, 0 with the reference's costs, computed all the same
    ("test2.fasta", "off", 7),
    # N = 4 (15 masks) and N = 6 (63 masks: two passes of a warp)
    ("rand4", "auto", 0), ("rand6", "auto", 0), ("synth6", "off", 0)])
def test_k4_lanes_equal_plain_and_jax(name, triples, gap_oe):
    seqs = family(name)
    # synth6's 42 key bits need 2^20 slots for the sig layout
    capacity = 1 << 20 if name == "synth6" else 1 << 14
    eng, tab, ctr = mid_search(seqs, triples, 64, capacity, 6)
    st = eng.st
    st.gap_oe = gap_oe
    goal, thr = int(ctr[0]), int(ctr[7])
    # the plain select, then the plain expand on its rows
    ptab = clone(tab)
    coords, f, par, _, active, _, _, _, _ = TE._select_sig(st, ptab, goal, thr)
    assert int(active.sum()) > 0
    g_c, f_c, m_c, valid, is_goal, child = TE._expand(st, coords, f, par, active,
                                                      g_is_f=True)
    want_goal = min(goal, int(torch.where(is_goal, g_c, TE.INF).min()))
    keep = valid & (f_c <= eng.ub)
    home, sigb, packed = TE._candidates_sig(st, child[keep], g_c[keep], f_c[keep],
                                            m_c[keep])
    # the kernels' view: K3 then K4 on a copy
    etab = clone(tab)
    closed = etab.t_closed.numpy()
    k3 = emu_select(st, etab.t_sig.numpy(), etab.t_best.numpy(), closed, goal, thr)
    eact, sel = k3[2], k3[7]
    assert np.array_equal(eact, active.numpy())
    sig = etab.t_sig.numpy().view(np.uint32)
    best = etab.t_best.numpy()
    egoal, pend, n_valid, lanes = emu_expand(
        KernelStatics(st), sig, best, sel, goal, eng.ub, np.random.default_rng(1))
    assert egoal == want_goal and n_valid == int(keep.sum()) > 0
    # lane (row b, mask m) of the kernel is lane b * M + m - 1 of _expand
    B, M = st.B, st.M
    f_np, keep_np = f_c.numpy(), keep.numpy()
    for (b, m), (fc, ok, hm, sb) in lanes.items():
        k = b * M + m - 1
        assert ok == keep_np[k]
        if valid.numpy()[k]:
            assert fc == f_np[k]
    # the round-0 match and the pending lanes: the plain insert's round 0
    row = tab.t_sig[(home * 8)[:, None] + torch.arange(8)]
    matched = (row == sigb[:, None]).any(1)
    assert sorted(pend) == sorted(zip(home[~matched].tolist(), sigb[~matched].tolist(),
                                      packed[~matched].tolist()))
    r0 = clone(tab)
    slot0 = home * 8 + torch.argmax((row == sigb[:, None]).to(torch.uint8), dim=1)
    r0.t_best.scatter_reduce_(0, torch.where(matched, slot0, st.C), packed.to(torch.int32),
                              "amin")
    assert torch.equal(torch.from_numpy(best)[: st.C], r0.t_best[: st.C])
    # and JAX: _expand on the decoded rows, _sig_encode on the children
    if gap_oe == 0:
        jst, _ = statics(seqs, 64, capacity, triples)
        _, jg, jf, jm, jv, jgoal, jchild, _ = JE._expand(
            jst, jnp.asarray(coords.numpy().astype(np.int32)),
            jnp.asarray(f.numpy().astype(np.int32)), jnp.asarray(par.numpy().astype(np.int32)),
            jnp.asarray(active.numpy()), g_is_f=True)
        jv = np.asarray(jv)
        jh, js = JE._sig_encode(jst, jnp.asarray(np.asarray(jchild)[jv]))
        got = {k: v for k, v in lanes.items() if valid.numpy()[k[0] * M + k[1] - 1]}
        idx = np.nonzero(jv)[0]
        jf = np.asarray(jf)
        for n, k in enumerate(idx):
            fc, ok, hm, sb = got[(k // M, k % M + 1)]
            assert fc == int(jf[k])
            if ok:
                assert (hm, sb) == (int(np.asarray(jh)[n]), int(np.asarray(js)[n]))


def k3_table(st, rs, empty):
    """best, closed (C + TRASH,) int32 for a select: half the slots used,
    whole groups empty with probability ``empty``, few distinct words (ties
    inside groups: the first index wins), some closed, some reopened."""
    C = st.C
    best = np.full(C + TE.TRASH, INFP, dtype=np.int32)
    closed = np.full(C + TE.TRASH, INFP, dtype=np.int32)
    used = rs.rand(C) < 0.5
    used &= np.repeat(rs.rand(st.B) >= empty, C // st.B)  # whole groups empty
    words = (rs.randint(0, 30, size=C) << st.nb) | rs.randint(1, st.M + 1, size=C)
    best[:C][used] = words[used]
    u = rs.rand(C)
    closed[:C][used & (u < 0.3)] = best[:C][used & (u < 0.3)]
    reo = used & (u >= 0.3) & (u < 0.5)
    closed[:C][reo] = best[:C][reo] + (5 << st.nb)
    return best, closed


def check_k3(jst, st, best, closed, goal, thr, **schedule):
    """K3's schedule against _select_best_plain (every output and the
    closed table) and JAX _select_sig; its compact list is the active rows
    in group order.  Returns the emulation's outputs."""
    C, nb = st.C, st.nb
    a_closed = closed.copy()
    got = emu_select(st, None, best, a_closed, goal, thr, **schedule)
    t_closed = torch.from_numpy(closed.copy())
    want = TE._select_best_plain(st, torch.from_numpy(best), t_closed, goal, thr)
    for x, y in zip(got, want):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert np.array_equal(a_closed[:C], t_closed[:C].numpy())
    rows = np.nonzero(got[2])[0]
    assert np.array_equal(got[7], np.stack([got[0][rows], got[1][rows]], 1))
    jtab = (jnp.zeros((C // 8, 8), jnp.uint32), jnp.asarray(best[:C]),
            jnp.asarray(closed[:C]))
    (_, _, jclosed), _, jf, jpar, jact, jfmin, jopen, jsel, jre = JE._select_sig(
        jst, jtab, goal, thr)
    assert np.array_equal(np.asarray(jact), got[2])
    assert np.array_equal(np.asarray(jf), (got[1] >> nb) + st.f0)
    assert np.array_equal(np.asarray(jpar), got[1] & ((1 << nb) - 1))
    assert (int(jfmin), int(jopen), int(jsel), int(jre)) == tuple(got[3:7])
    assert np.array_equal(np.asarray(jclosed), a_closed[:C])
    return got


@pytest.mark.parametrize("thr,goal_off,empty", [(0, 10**9, 0.0), (2**20, 10**9, 0.3),
                                                (40, 900, 0.5)])
def test_k3_keys_equal_plain_select(thr, goal_off, empty):
    jst, st = statics(golden_seqs("PF08184.fasta"), 64, 1 << 12)
    rs = np.random.RandomState(int(thr) % 97)
    best, closed = k3_table(st, rs, empty)
    goal = st.f0 + goal_off
    got = check_k3(jst, st, best, closed, goal, thr)
    assert got[5] > 0 and (empty == 0 or (got[1] == INFP).any())
    # the dispatch on a CPU table is the plain select
    t_closed = torch.from_numpy(closed.copy())
    want = TE._select_best_plain(st, torch.from_numpy(best), t_closed, goal, thr)
    t2 = torch.from_numpy(closed.copy())
    again = TE._select_best(st, torch.from_numpy(best), t2, goal, thr)
    assert all(torch.equal(x, y) for x, y in zip(again, want))


@pytest.mark.parametrize("G,aligned,blocks", [
    (1, True, 132), (2, True, 3), (32, True, 132), (128, True, 3), (512, True, 132),
    (1024, True, 1),
    # G a multiple of 128 on unaligned tables: the scalar path
    (128, False, 132)])
def test_k3_schedule_any_group_size(G, aligned, blocks):
    # 2^14 slots: G = 1 is B = 16384 groups, two rounds of the last block
    C = 1 << 14
    jst, st = statics(golden_seqs("PF08184.fasta"), C // G, C)
    assert st.C // st.B == G
    rs = np.random.RandomState(G)
    best, closed = k3_table(st, rs, 0.2)
    got = check_k3(jst, st, best, closed, st.f0 + 10**9, 40, blocks=blocks,
                   aligned=aligned, rng=np.random.default_rng(G))
    assert 0 < got[5] < st.B


def test_k3_constants_match_source():
    src = open(os.path.join(HERE, "..", "mpi_pastar_msa_tpu_torch", "csrc",
                            "select_best.cu")).read()
    for name, value in (("kThreads", K3_THREADS), ("kVec", K3_VEC), ("kItems", K3_ITEMS)):
        assert f"constexpr int {name} = {value};" in src


def emu_chunk(st, tab, counters, chunk_steps, ub, fill, rng, cap=TS.K5_CAP, blocks=132,
              scratch=None):
    """search/step.py::run_chunk_sig_cuda with the kernels emulated: the run
    flag of a chunk starts from f-min 0, K5's last thread writes the
    counters and the flag, every kernel skips while it reads 0.  K5 runs
    with ``cap`` and ``blocks`` and keeps its lane arrays ``scratch`` from
    step to step."""
    c = counters.tolist()
    c[1] = 0
    run = c[0] > 0 and c[6] == 0
    ks = KernelStatics(st)
    sig = tab.t_sig.numpy().view(np.uint32)
    best, closed = tab.t_best.numpy(), tab.t_closed.numpy()
    for _ in range(chunk_steps):
        if not run:
            continue
        _, _, _, fmin, n_open, n_sel, reopen, sel = emu_select(
            st, sig, best, closed, c[0], c[7], rng=rng)
        c[0], pend, n_valid, _ = emu_expand(ks, sig, best, sel, c[0], ub, rng)
        calls, counts = emu_probe(st, sig, best, pend, rng, cap=cap, blocks=blocks,
                                  scratch=scratch)
        c[1] = fmin
        c[2] += 1
        c[3] += n_sel
        c[4] += reopen
        c[5] = n_open
        c[6] += counts[-1] if calls else 0
        thr = c[7]
        nt = thr * 2 + 32 if n_sel < fill // 2 else (
            thr // 2 if n_sel >= fill - fill // 8 else thr)
        c[7] = min(nt, 1 << 20)
        c[8] += n_sel
        c[9] += n_valid
        c[10] += n_valid
        c[11] += calls * n_valid
        c[12] += len(pend)
        c[13] += counts[1] if calls >= 2 else 0
        run = c[1] < c[0] and c[6] == 0
    return torch.tensor(c, dtype=torch.int64)


@pytest.mark.parametrize("name,triples,batch,chunk,capacity,loose", [
    ("test2.fasta", "off", 32, 7, 1 << 14, 0),
    ("PF08184.fasta", "auto", 64, 16, 1 << 14, 0),
    # an upper bound 20000 too high fills a 2^8-slot table: both loops stop
    # on the same overflow
    ("test2.fasta", "off", 16, 16, 1 << 8, 20000)])
def test_k6_chunks_equal_plain_loop(name, triples, batch, chunk, capacity, loose):
    seqs = golden_seqs(name)
    p = Problem(seqs)
    th = (both_cubes(seqs) if triples == "auto" else both_hpair(seqs))[1]
    eng = TE.FrontierSearch(p, th, device="cpu", batch=batch, capacity=capacity,
                            triples=triples)
    st, ub = eng.st, eng.ub + loose
    a = eng._init_table()
    b = clone(a)
    ca = cb = torch.as_tensor(TE.fresh_counters())
    rng = np.random.default_rng(3)
    for _ in range(40):
        ca = TE._run_chunk_plain(st, a, ca, chunk, ub, eng.fill_target, "sig")
        cb = emu_chunk(st, b, cb, chunk, ub, eng.fill_target, rng)
        assert ca.tolist() == cb.tolist()
        assert same_table(a, b, st.C)
        if ca[1] >= ca[0] or ca[6] > 0:
            break
    if loose:
        assert int(ca[6]) > 0
    else:
        assert int(ca[0]) == GOLD[name]["optimal_g"] and ca[1] >= ca[0]
    assert int(ca[11]) > 0  # the probe ran


@pytest.mark.parametrize("blocks", [1, 3])
def test_k6_chunks_with_k5_grid_path_equal_plain_loop(blocks):
    # K5 on its grid path every step (cap 0), its lane arrays carried from
    # step to step: chunk by chunk to the goal, as the plain loop
    seqs = golden_seqs("PF08184.fasta")
    p = Problem(seqs)
    eng = TE.FrontierSearch(p, both_cubes(seqs)[1], device="cpu", batch=64,
                            capacity=1 << 14, triples="auto")
    st, ub = eng.st, eng.ub
    a = eng._init_table()
    b = clone(a)
    ca = cb = torch.as_tensor(TE.fresh_counters())
    rng = np.random.default_rng(11)
    cap_lanes = st.B * st.M
    scratch = tuple([int(v) for v in rng.integers(-1, 1 << 20, cap_lanes)] for _ in range(3))
    for _ in range(40):
        ca = TE._run_chunk_plain(st, a, ca, 16, ub, eng.fill_target, "sig")
        cb = emu_chunk(st, b, cb, 16, ub, eng.fill_target, rng, cap=0, blocks=blocks,
                       scratch=scratch)
        assert ca.tolist() == cb.tolist()
        assert same_table(a, b, st.C)
        if ca[1] >= ca[0]:
            break
    assert int(ca[0]) == GOLD["PF08184.fasta"]["optimal_g"]


# ------------------------------- the chunk graph's host logic (K6), stubbed

STEP_KERNELS = ("select_best", "sig_expand", "sig_probe")


class StubKernels:
    """The step kernels' C entries as Python functions on CPU memory (the
    pointers of CPU tensors are host addresses).  Each records its
    arguments; while ``run_kernels`` is False (a capture) that is all, else
    K5 runs ``step`` (default: a search whose f-min is 10 a step: steps +=
    1, f-min = 10 x steps) when the run flag reads 1, then writes the flag
    (f-min < goal and no overflow).  ``dead`` counts the inserts that found
    the flag at 0."""

    def __init__(self, step=None, insert="sig_probe", run_at=11, ctr_at=12):
        self.calls = {name: [] for name in STEP_KERNELS + (insert,)}
        self.insert, self.at = insert, (run_at, ctr_at)
        self.step = step or self.ten_a_step
        self.run_kernels = True
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
        if not self.run_kernels or name != self.insert:
            return
        run_at, ctr_at = self.at
        run = ctypes.c_int32.from_address(vals[run_at])
        if not run.value:
            self.dead += 1
            return
        ctr = (ctypes.c_longlong * TE.N_COUNTERS).from_address(vals[ctr_at])
        self.step(ctr)
        run.value = int(ctr[1] < ctr[0] and ctr[6] == 0)


class FakeGraph:
    """torch.cuda.CUDAGraph on the CPU.  The capture runs the step's host
    code once, the stubs recording its launches and running none.  A
    replay runs the recorded launches (the stubs run them), counted
    nowhere (the chunk loop counts the replays): a real graph replays the
    arguments of its capture."""

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
    """The chunk loop on the CPU: stub C entries, fake graphs, stream 0.
    Yields (stubs, graphs); ``stubs.step`` may be replaced."""
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


def test_k6_chunk_graph_binds_static_buffers_and_counts_replays(stubbed):
    stubs, graphs = stubbed
    _, st = statics(golden_seqs("PF08184.fasta"), 64, 1 << 12)
    tab = empty_table(st)
    bufs = TS.StepBuffers.for_step(st, torch.device("cpu"))
    ctr = torch.as_tensor(TE.fresh_counters())
    ctr[0] = 95  # the stub search stops at step 10 (f-min 100)
    outs = []
    for _ in range(4):
        ctr = TS._drive_chunk(st, tab, bufs, ctr, 4, 10**6, 32, 0, TS.K5_CAP, True)
        outs.append(ctr.tolist())
    # one capture of one step, four replays a chunk; the counters went
    # through the static buffer: 4, 8, then 10 steps (the stop at f-min
    # 100; the chunk's last two replays no-ops); a chunk starts from f-min
    # 0, so the fourth runs one step more, as the plain loop's would
    assert len(graphs) == 1 and bufs.captures == 1 and graphs[0].replays == 16
    assert [o[2] for o in outs] == [4, 8, 10, 11] and [o[1] for o in outs] == [40, 80, 100, 110]
    assert outs[-1][0] == 95
    # the replays after the stop found the flag at 0 (and the warm-up's
    # insert): 2 in the third chunk, 3 in the fourth
    assert stubs.dead == 1 + 2 + 3
    # every pointer the kernels got is a static buffer: the counters of K4
    # and K5 (and K3's goal and threshold, views of them) are
    # bufs.counters, never the caller's tensor
    ptr = bufs.counters.data_ptr()
    k5 = stubs.calls["sig_probe"]
    assert {c[12] for c in k5} == {ptr}
    assert {c[19] for c in stubs.calls["sig_expand"]} == {ptr}
    assert {(c[6], c[7]) for c in stubs.calls["select_best"]} == {(ptr, ptr + 8 * 7)}
    assert all(c[0] == tab.t_sig.data_ptr() for c in k5)
    # launches: the warm-up (each kernel once, run flag 0) and the one
    # captured step times the replays; the capture itself ran nothing
    assert len(k5) == 1 + 1 + 4 * 4 and graphs[0].recorded == [
        (name, stubs.calls[name][1]) for name in STEP_KERNELS]
    assert bufs.graph.tally == {name: 1 for name in STEP_KERNELS}
    for name in STEP_KERNELS:
        assert _kernels.launches[name] == 1 + 4 * 4
    assert set(bufs.capture_parts) == {"warm_s", "host_s", "instantiate_s"}
    assert bufs.capture_s == pytest.approx(sum(bufs.capture_parts.values()))


def test_k6_chunk_graph_recaptures_for_a_new_table_or_statics(stubbed):
    _, graphs = stubbed
    seqs = golden_seqs("PF08184.fasta")
    _, st = statics(seqs, 64, 1 << 12)
    bufs = TS.StepBuffers.for_step(st, torch.device("cpu"))
    ctr = torch.as_tensor(TE.fresh_counters())
    a, b = empty_table(st), empty_table(st)
    TS._drive_chunk(st, a, bufs, ctr, 2, 10**6, 32, 0, TS.K5_CAP, True)
    TS._drive_chunk(st, a, bufs, ctr, 2, 10**6, 32, 0, TS.K5_CAP, True)
    assert bufs.captures == 1
    # another table (new pointers), K5 grid or cap: each a new capture, the
    # old graph released; another chunk length replays the same step
    TS._drive_chunk(st, b, bufs, ctr, 2, 10**6, 32, 0, TS.K5_CAP, True)
    TS._drive_chunk(st, b, bufs, ctr, 3, 10**6, 32, 0, TS.K5_CAP, True)
    assert bufs.captures == 2
    TS._drive_chunk(st, b, bufs, ctr, 3, 10**6, 32, 1, TS.K5_CAP, True)
    TS._drive_chunk(st, b, bufs, ctr, 3, 10**6, 32, 1, 0, True)
    assert bufs.captures == 4 and len(graphs) == 4 and bufs.graph.graph is graphs[-1]
    # a regrow: new statics at twice the capacity, so new buffers and a new
    # table, and a capture on them
    _, st2 = statics(seqs, 64, 1 << 13)
    bufs2 = TS.StepBuffers.for_step(st2, torch.device("cpu"))
    TS._drive_chunk(st2, empty_table(st2), bufs2, ctr, 3, 10**6, 32, 0, TS.K5_CAP, True)
    assert bufs2.captures == 1 and len(graphs) == 5
    # the eager chunk captures nothing and counts each launch
    n = _kernels.launches["sig_probe"]
    TS._drive_chunk(st2, empty_table(st2), bufs2, ctr, 3, 10**6, 32, 0, TS.K5_CAP, False)
    assert bufs2.captures == 1 and _kernels.launches["sig_probe"] == n + 3


@pytest.mark.parametrize("chunk", [1, 7])
def test_k6_chunk_loop_stops_mid_chunk_as_the_plain_loop(stubbed, chunk):
    # the chunk loop (set-up, then the step graph replayed) over a real
    # search: K5's stand-in runs one plain step on the table.  Chunk by
    # chunk to the goal, every table tensor and the 14 counters equal the
    # plain loop's; the last chunk stops in its middle (chunk 7) and its
    # replays after the stop change nothing
    stubs, graphs = stubbed
    seqs = golden_seqs("PF08184.fasta")
    eng = TE.FrontierSearch(Problem(seqs), both_cubes(seqs)[1], device="cpu", batch=64,
                            capacity=1 << 14, triples="auto")
    st, ub, fill = eng.st, eng.ub, eng.fill_target
    a = eng._init_table()
    b = clone(a)
    bufs = TS.StepBuffers.for_step(st, torch.device("cpu"))

    def one_plain_step(ctr):
        c = torch.tensor(list(ctr), dtype=torch.int64)
        c = TE._run_chunk_plain(st, b, c, 1, ub, fill, "sig")
        for i, v in enumerate(c.tolist()):
            ctr[i] = v

    stubs.step = one_plain_step
    ca = cb = torch.as_tensor(TE.fresh_counters())
    for chunks in range(1, 400):
        ca = TE._run_chunk_plain(st, a, ca, chunk, ub, fill, "sig")
        cb = TS._drive_chunk(st, b, bufs, cb, chunk, ub, fill, 0, TS.K5_CAP, True)
        assert ca.tolist() == cb.tolist()
        assert same_table(a, b, st.C)
        if ca[1] >= ca[0]:
            break
    assert int(ca[0]) == GOLD["PF08184.fasta"]["optimal_g"]
    steps = int(ca[2])
    assert graphs[0].replays == chunk * chunks
    assert stubs.dead == 1 + chunk * chunks - steps  # the warm-up's and the stop's
    if chunk == 7:
        assert steps % chunk != 0  # the goal in the middle of a chunk
    assert _kernels.launches["sig_probe"] == 1 + chunk * chunks


def test_k6_launch_arguments_match_signatures():
    # every launch of the step and K5 over the received rows has its C
    # entry's arity, the stream last
    seqs = golden_seqs("PF08184.fasta")
    _, st = statics(seqs, 64, 1 << 12)
    tab = empty_table(st)
    bufs = TS.StepBuffers.for_step(st, torch.device("cpu"))
    ctr = bufs.counters
    for a in TS._step_args(st, tab, bufs, ctr, 10**6, 32, 0, TS.K5_CAP, "s"):
        assert len(a) - 1 == len(_kernels.SIGNATURES[a[0]]) and a[-1] == "s", a[0]
    recv = torch.zeros(1, dtype=torch.int32)
    k5r = TS._probe_args(st, tab, bufs, ctr, 32, 0, TS.K5_CAP, "s", pend_at=3, recv=recv)
    assert len(k5r) - 1 == len(_kernels.SIGNATURES["sig_probe"])
    assert k5r[-2] == recv.data_ptr()


def test_k6_chunk_setup():
    # a chunk's set-up (chunk_setup_plain, and _setup on CPU buffers): f-min
    # 0 and the run flag from goal and overflow, so its first step runs as
    # the plain loop's does; chunk_setup's C entry takes counters, flag and
    # stream
    _, st = statics(golden_seqs("PF08184.fasta"), 64, 1 << 12)
    bufs = TS.StepBuffers.for_step(st, torch.device("cpu"))
    ctr = bufs.counters
    ctr.copy_(torch.as_tensor(TE.fresh_counters()))
    ctr[1] = 77
    bufs.run.fill_(5)
    TS._setup(bufs, 0)
    assert int(ctr[1]) == 0 and bufs.run.tolist() == [1]
    for goal, ovf in ((0, 0), (10, 1), (-3, 0)):
        ctr[0], ctr[1], ctr[6] = goal, 9, ovf
        TS.chunk_setup_plain(ctr, bufs.run)
        assert bufs.run.tolist() == [0] and int(ctr[1]) == 0, (goal, ovf)
    assert len(_kernels.SIGNATURES["chunk_setup"]) == 3


@pytest.mark.parametrize("name,capacity", [("kinase.fasta", 1 << 23),
                                           ("PF08184.fasta", 1 << 16)])
def test_sig_words_below_2_31(name, capacity):
    _, st = statics(golden_seqs(name), 64, capacity)
    assert st.sig_ok and st.sig_bits - st.bbits <= 25
    rs = np.random.RandomState(8)
    # the largest value of every coordinate field, beside random ones
    top = np.array([(1 << w) - 1 for w in st.bitw], dtype=np.int64)
    coords = np.concatenate([top[None], random_coords(rs, top, 4096)])
    home, sigb = TE._sig_encode(st, torch.from_numpy(coords))
    words = sigb | (st.max_bprobes - 1)
    assert int(words.max()) < 2**31 and int(home.max()) < st.nbuck
    assert int(words[0]) == ((1 << (st.sig_bits - st.bbits)) - 1) << 6 | 63


def test_step_wrappers_refuse_cpu_and_other_tables():
    _, st = statics(golden_seqs("PF08184.fasta"), 64, 1 << 12)
    tab = empty_table(st)
    ctr = torch.as_tensor(TE.fresh_counters())
    with pytest.raises(ValueError):
        TS.select_best_cuda(st, tab.t_best, tab.t_closed, 10, 0)
    with pytest.raises(ValueError):
        TS.run_chunk_sig_cuda(st, tab, ctr, 1, 10**6, 32)
    packed = TE.PackedTable(torch.full((st.C + TE.TRASH, st.KW), -1, dtype=torch.int32),
                            tab.t_best, tab.t_closed, tab.t_closed.clone())
    with pytest.raises(ValueError):
        TS.run_chunk_sig_cuda(st, packed, ctr, 1, 10**6, 32)
    assert TS.STATE_WORDS == TS.STATE_CNT + st.max_probes
