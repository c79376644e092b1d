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
- K4's lane -> (row, mask) mapping with its per-pair cost, the goal found
  before the prune and the round-0 row match, against the plain
  _expand -> prune -> _candidates_sig -> round 0 and against JAX
  _expand / _sig_encode;
- K3's 64-bit (word, index) keys against _select_best_plain;
- the step loop with its run flag on the device (K6) against
  _run_chunk_plain, chunk by chunk to the goal;
- every word _sig_encode can store at kinase's and PF08184's widths is
  below 2^31;
- the wrappers refuse CPU tensors and non-sig tables.
"""
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
from mpi_pastar_msa_tpu_torch.core.cost import GAP_EXTENSION, GAP_GAP
from mpi_pastar_msa_tpu_torch.core.problem import Problem
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


def emu_select(st, sig, best, closed, goal, thr):
    """csrc/select_best.cu: the (word << 32 | index) key of every open slot,
    min per group, the global min as INFP - max(INFP - group min), then
    the cut; closes the active slots in ``closed`` (a NumPy int32 array).
    Returns (slots, vmin, active, fmin, n_open, n_sel, reopen)."""
    C, B, nb = st.C, st.B, st.nb
    G = C // B
    w = best[:C].astype(np.int64)
    is_open = (w < closed[:C]) & ((w >> nb) < goal - st.f0)
    key = ((np.where(is_open, w, INFP).astype(np.uint64) << np.uint64(32))
           | np.tile(np.arange(G, dtype=np.uint64), B))
    kmin = key.reshape(B, G).min(axis=1)
    vmin = (kmin >> np.uint64(32)).astype(np.int64)
    slots = np.arange(B, dtype=np.int64) * G + (kmin & np.uint64(M32)).astype(np.int64)
    gmin = INFP - (INFP - vmin).max()
    fmin_r = gmin >> nb
    cut = (min(fmin_r + thr + 1, INFP >> nb) << nb) - 1
    active = vmin <= cut
    reopen = int((active & (closed[slots] < INFP)).sum())
    closed[slots[active]] = vmin[active]
    vmin = np.where(active, vmin, INFP)
    return (slots, vmin, active, fmin_r + st.f0, int(is_open.sum()),
            int(active.sum()), reopen)


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


def emu_expand(ks, sig, best, slots, vmin, active, goal, ub, rng):
    """csrc/sig_expand.cu, block by block and mask by mask in a random
    order: decode, stage, cost per pair, goal before the prune, sig
    encoding, round-0 match (min into ``best``).  Returns (goal, pending
    lanes [(home, sig base, packed)], lanes that survive the prune,
    per-lane records {(row, m): (f, valid, home, sig base)})."""
    st = ks.st
    S, N, nb, f0 = st.S, st.n, st.nb, st.f0
    E, GG, gap_oe = GAP_EXTENSION, GAP_GAP, st.gap_oe
    bmask = st.nbuck - 1
    pend, n_valid, lanes = [], 0, {}
    for b in rng.permutation(st.B):
        if not active[b]:
            continue
        slot = int(slots[b])
        word = int(sig[slot]) & M32
        r, khi = word & 63, word >> 6
        home = ((slot >> 3) - r) & bmask
        klo = (((home ^ (mix32(khi) & bmask)) * 0x0E8B2F51) & M32) & bmask
        key = klo | (khi << st.bbits)
        coord = [(key >> ks.shift[i]) & ((1 << st.bitw[i]) - 1) for i in range(N)]
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
        v = int(vmin[b])
        par = v & ((1 << nb) - 1)
        g = (v >> nb) + f0 - h_par
        for m in rng.permutation(np.arange(1, st.M + 1)).tolist():
            cost = h = 0
            for p in range(st.P):
                bx, by = m >> ks.xs[p] & 1, m >> ks.ys[p] & 1
                w = ks.w[p]
                cost += w * (GG + (E - GG) * (bx + by) + (bx & by) * (t8[p][4] + GG - 2 * E))
                cost += gap_oe * w * (bx * (1 - by) * (par >> ks.ys[p] & 1)
                                      + (1 - bx) * by * (par >> ks.xs[p] & 1))
                h += t8[p][2 * bx + by] * ks.wh[p]
            for t, (x, y, z) in enumerate(ks.tri):
                h += cube[t][4 * (m >> x & 1) + 2 * (m >> y & 1) + (m >> z & 1)]
            child = [coord[i] + (m >> i & 1) for i in range(N)]
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
                    pend.append((hm, sb, packed))
            lanes[(int(b), m)] = (fc, valid, hm, sb)
    return goal, pend, n_valid, lanes


def emu_probe(st, sig, best, pend, rng, max_calls=128):
    """csrc/sig_probe.cu: each call's read phase over the lanes in a random
    order (matches min into ``best`` at once), then its write phase in
    another random order, unsigned min on ``sig`` (a NumPy uint32 array).
    Returns (calls, unsettled after each call)."""
    bmask = st.nbuck - 1
    n = len(pend)
    home = [h for h, _, _ in pend]
    cur = list(home)  # -1 once settled
    counts, calls, undone = [], 0, n
    while undone > 0 and calls < max_calls:
        writes, left = [], 0
        for i in rng.permutation(n).tolist():
            if cur[i] < 0:
                continue
            left += 1
            r = (cur[i] - home[i]) & bmask
            if r >= st.max_bprobes:
                continue
            word = pend[i][1] | r
            row = sig[cur[i] * 8: cur[i] * 8 + 8].tolist()
            if word in row:
                at = cur[i] * 8 + row.index(word)
                best[at] = min(int(best[at]), pend[i][2])
                cur[i] = -1
                left -= 1
                continue
            empty = [w for w in range(8) if row[w] == M32]
            if not empty:
                cur[i] = (cur[i] + 1) & bmask
                continue
            writes.append((cur[i] * 8 + empty[mix32(word) % len(empty)], word))
        counts.append(left)
        undone = left
        for k in rng.permutation(len(writes)).tolist():
            d, word = writes[k]
            sig[d] = min(int(sig[d]), word)
        calls += 1
    return calls, counts


def emu_insert(st, tab, home, sigb, packed, rng):
    """K4's round 0 and K5 on given lanes (the plain _insert_sig's
    arguments); returns the plain insert's (overflow, acct)."""
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
    calls, counts = emu_probe(st, sig, best, pend, rng)
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


@pytest.mark.parametrize("name,triples,gap_oe", [
    ("PF08184.fasta", "auto", 0), ("test2.fasta", "off", 0),
    # the gap-open term, 0 with the reference's costs, computed all the same
    ("test2.fasta", "off", 7)])
def test_k4_lanes_equal_plain_and_jax(name, triples, gap_oe):
    seqs = golden_seqs(name)
    eng, tab, ctr = mid_search(seqs, triples, 64, 1 << 14, 6)
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
    slots, vmin, eact, *_ = emu_select(st, etab.t_sig.numpy(), etab.t_best.numpy(),
                                       closed, goal, thr)
    assert np.array_equal(eact, active.numpy())
    sig = etab.t_sig.numpy().view(np.uint32)
    best = etab.t_best.numpy()
    egoal, pend, n_valid, lanes = emu_expand(
        KernelStatics(st), sig, best, slots, vmin, eact, goal, eng.ub,
        np.random.default_rng(1))
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
        jst, _ = statics(seqs, 64, 1 << 14, triples)
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


@pytest.mark.parametrize("thr,goal_off,empty", [(0, 10**9, 0.0), (2**20, 10**9, 0.3),
                                                (40, 900, 0.5)])
def test_k3_keys_equal_plain_select(thr, goal_off, empty):
    _, st = statics(golden_seqs("PF08184.fasta"), 64, 1 << 12)
    rs = np.random.RandomState(int(thr) % 97)
    C = st.C
    best = np.full(C + TE.TRASH, INFP, dtype=np.int32)
    closed = np.full(C + TE.TRASH, INFP, dtype=np.int32)
    used = rs.rand(C) < 0.5
    used &= np.repeat(rs.rand(st.B) >= empty, C // st.B)  # whole groups empty
    # few distinct words: ties inside groups, first index wins
    words = (rs.randint(0, 30, size=C) << st.nb) | rs.randint(1, st.M + 1, size=C)
    best[:C][used] = words[used]
    u = rs.rand(C)
    closed[:C][used & (u < 0.3)] = best[:C][used & (u < 0.3)]
    reo = used & (u >= 0.3) & (u < 0.5)
    closed[:C][reo] = best[:C][reo] + (5 << st.nb)
    goal = st.f0 + goal_off
    a_closed = closed.copy()
    got = emu_select(st, None, best, a_closed, goal, thr)
    t_closed = torch.from_numpy(closed.copy())
    want = TE._select_best_plain(st, torch.from_numpy(best), t_closed, goal, thr)
    for x, y in zip(got, want):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert np.array_equal(a_closed[:C], t_closed[:C].numpy())
    assert got[5] > 0 and (empty == 0 or (got[1] == INFP).any())
    # the dispatch on a CPU table is the plain select
    t2 = torch.from_numpy(closed.copy())
    again = TE._select_best(st, torch.from_numpy(best), t2, goal, thr)
    assert all(torch.equal(x, y) for x, y in zip(again, want))


def emu_chunk(st, tab, counters, chunk_steps, ub, fill, rng):
    """search/step.py::run_chunk_sig_cuda with the kernels emulated: the run
    flag of a chunk starts from f-min 0, K5's last thread writes the
    counters and the flag, every kernel skips while it reads 0."""
    c = counters.tolist()
    c[1] = 0
    run = c[0] > 0 and c[6] == 0
    ks = KernelStatics(st)
    sig = tab.t_sig.numpy().view(np.uint32)
    best, closed = tab.t_best.numpy(), tab.t_closed.numpy()
    for _ in range(chunk_steps):
        if not run:
            continue
        slots, vmin, active, fmin, n_open, n_sel, reopen = emu_select(
            st, sig, best, closed, c[0], c[7])
        c[0], pend, n_valid, _ = emu_expand(ks, sig, best, slots, vmin, active, c[0],
                                            ub, rng)
        calls, counts = emu_probe(st, sig, best, pend, rng)
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
