"""The packed and unpacked table layouts of the port's frontier engine
against the JAX engine, on the CPU (all values int32 or exact integers:
zero tolerance).

Units, against the JAX functions on identical inputs:
- the key words: _pack_keys, _hash_keys, _probe_slot at N = 3 ... 16;
- _select_packed and _select on synthesized tables;
- _insert_core_packed and the unpacked _insert_core on a 2^10-slot table
  about 40% full, with duplicate keys and colliding hashes in the batch;
  the claim rule (smallest tag, no reset between calls);
- _expand with g given (packed) and with pathmax (unpacked, JAX's
  flat-table route), without and with cubes.

End to end: each layout pinned on test / test2 / PF08184 against
tests/goldens.json (JAX's path), random families against SerialAStar, the
layout JAX's ``auto`` picks on larger inputs (a near-identical 5 x 130
family, N = 10 and N = 16 families), degenerate weights, regrow, and the
ValueError of an ineligible pin.
"""
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
from mpi_pastar_msa_tpu.search import bounds as JB
from mpi_pastar_msa_tpu.search import engine as JE
from mpi_pastar_msa_tpu.search.serial import SerialAStar
from mpi_pastar_msa_tpu_torch.core.problem import Problem, problem_from_fasta
from mpi_pastar_msa_tpu_torch.heuristic import triples as TT
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.search import engine as TE
from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))
AMINO = "ACDEFGHIKLMNPQRSTVWY"
EMPTY = np.uint32(0xFFFFFFFF)


def golden_seqs(name):
    return tuple(r.replace("-", "") for r in GOLD[name]["alignment"])


def random_seqs(seed, n=4, lo=5, hi=12):
    rs = np.random.RandomState(seed)
    return tuple("".join(rs.choice(list(AMINO), size=rs.randint(lo, hi + 1)))
                 for _ in range(n))


def family(rng, n, L, sub=0.3, indel=0.08):
    """The family generator of tests/test_large_n.py."""
    aa = "ARNDCQEGHILKMFPSTWYV"
    anc = "".join(aa[i] for i in rng.integers(0, 20, L))
    seqs = []
    for _ in range(n):
        out = []
        for ch in anc:
            r = rng.random()
            if r < indel:
                continue
            out.append(aa[rng.integers(0, 20)] if r < indel + sub else ch)
        if not out:
            out.append(aa[rng.integers(0, 20)])
        seqs.append("".join(out))
    return tuple(seqs)


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
                    axis=1).astype(np.int32)


def pad(a, fill):
    """A table tensor with the port's trash rows appended."""
    tail = np.full((TE.TRASH,) + a.shape[1:], fill, dtype=a.dtype)
    return torch.from_numpy(np.concatenate([a, tail]))


# ---------------------------------------------------------------- key words

@pytest.mark.parametrize("n", [3, 5, 6, 7, 10, 16])
def test_key_words_match_jax(n):
    rs = np.random.RandomState(n)
    final = rs.randint(1, 1500, size=n)
    coords = random_coords(rs, final, 2048)
    coords[0] = 0
    coords[1] = final
    coords[2] = 0xFFFF  # the largest coordinate a key word holds
    W = (n + 1) // 2
    jkeys = np.asarray(JE._pack_keys(jnp.asarray(coords), W))
    tkeys = TE._pack_keys(torch.from_numpy(coords), W)
    assert np.array_equal(tkeys.numpy(), jkeys.astype(np.int64))
    assert np.array_equal(TE._as_i32(tkeys).numpy(), jkeys.view(np.int32))
    st = types.SimpleNamespace(n=n)
    assert np.array_equal(TE._unpack_keys(st, TE._as_i32(tkeys)).numpy(), coords)
    jh0 = np.asarray(JE._hash_keys(jnp.asarray(jkeys)))
    th0 = TE._hash_keys(tkeys)
    assert np.array_equal(th0.numpy(), jh0.astype(np.int64))
    r = rs.randint(0, 128, size=len(coords))
    r[:128] = np.arange(128)
    for C in (1 << 5, 1 << 10, 1 << 23):
        want = np.asarray(JE._probe_slot(jnp.asarray(jh0),
                                         jnp.asarray(r.astype(np.int32)),
                                         np.uint32(C - 1)))
        got = TE._probe_slot(th0, torch.from_numpy(r.astype(np.int64)), C - 1)
        assert np.array_equal(got.numpy(), want.astype(np.int64))


# ------------------------------------------------------------------ select

def synth_rows(jst, rs, n_keys, cols):
    """Random distinct keys at random slots of a (C, cols) key-row table."""
    coords = np.unique(random_coords(rs, jst.final_np, n_keys), axis=0)
    slots = rs.choice(jst.C, size=len(coords), replace=False)
    t_key = np.full((jst.C, cols), EMPTY, dtype=np.uint32)
    t_key[slots, : jst.W] = np.asarray(JE._pack_keys(jnp.asarray(coords), jst.W))
    return t_key, slots


@pytest.mark.parametrize("thr,goal_off", [(0, 10**9), (40, 10**9), (500, 1500)])
def test_select_packed_matches_jax(thr, goal_off):
    B, C = 64, 1 << 14
    jst, tst = statics(golden_seqs("PF08184.fasta"), B, C)
    rs = np.random.RandomState(5)
    t_key, slots = synth_rows(jst, rs, 3000, jst.KW)
    t_key[slots, jst.W] = rs.randint(0, 5000, size=len(slots))  # h
    t_best = np.full(C, JE.INFP, dtype=np.int32)
    t_closed = np.full(C, JE.INFP, dtype=np.int32)
    best = (rs.randint(0, 3000, size=len(slots)) << jst.nb) | rs.randint(
        1, jst.M + 1, size=len(slots))
    t_best[slots] = best
    u = rs.rand(len(slots))
    t_closed[slots[u < 0.3]] = best[u < 0.3]  # closed
    reo = (u >= 0.3) & (u < 0.45)  # reopened: improved since closed
    t_closed[slots[reo]] = best[reo] + (rs.randint(1, 50, size=reo.sum()) << jst.nb)
    goal_g = min(jst.f0 + goal_off, 2**30)
    jtab, jc, jg, jpar, jact, jfmin, jnopen, jnsel, jre = JE._select_packed(
        jst, (jnp.asarray(t_key), jnp.asarray(t_best), jnp.asarray(t_closed)),
        jnp.int32(goal_g), jnp.int32(thr))
    tab = TE.PackedTable(pad(t_key.view(np.int32), -1), pad(t_best, JE.INFP),
                         pad(t_closed, JE.INFP), fresh_claim(C))
    tc, tg, tpar, tfpar, tact, tfmin, tnopen, tnsel, tre = TE._select_packed(
        tst, tab, torch.tensor(goal_g), torch.tensor(thr))
    act = np.asarray(jact)
    assert act.sum() > 0 and tfpar is None
    assert np.array_equal(tact.numpy(), act)
    for got, want in ((tc, jc), (tg, jg), (tpar, jpar)):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert (int(tfmin), int(tnopen), int(tnsel), int(tre)) == (
        int(jfmin), int(jnopen), int(jnsel), int(jre))
    assert np.array_equal(tab.t_closed[:C].numpy(), np.asarray(jtab[2]))
    assert np.array_equal(tab.t_best[:C].numpy(), t_best)


@pytest.mark.parametrize("thr,goal_off", [(0, 10**9), (40, 10**9), (500, 1500)])
def test_select_unpacked_matches_jax(thr, goal_off):
    B, C = 64, 1 << 14
    jst, tst = statics(golden_seqs("PF08184.fasta"), B, C)
    rs = np.random.RandomState(6)
    t_key, slots = synth_rows(jst, rs, 3000, jst.W)
    k = len(slots)
    t_g = np.full(C, JE.INF, dtype=np.int32)
    t_f = np.full(C, JE.INF, dtype=np.int32)
    t_par = np.zeros(C, dtype=np.int32)
    t_state = np.zeros(C, dtype=np.int32)
    t_g[slots] = rs.randint(0, 20000, size=k)
    t_f[slots] = t_g[slots] + jst.f0 + rs.randint(0, 3000, size=k)
    t_f[slots[:40]] = JE.INF  # open entries at INF
    t_par[slots] = rs.randint(1, jst.M + 1, size=k)
    t_state[slots] = np.where(rs.rand(k) < 0.6, 1, 2)
    goal_g = min(jst.f0 + goal_off, 2**30)
    jtab, jc, jg, jpar, jfpar, jact, jfmin, jnopen, jnsel = JE._select(
        jst, tuple(jnp.asarray(a) for a in (t_key, t_g, t_f, t_par, t_state)),
        jnp.int32(goal_g), jnp.int32(thr))
    tab = TE.UnpackedTable(
        pad(t_key.view(np.int32), -1), pad(t_g, JE.INF),
        pad(t_f.astype(np.int64) * (1 << tst.nb) + t_par, JE.INF << tst.nb),
        pad(t_state, 0), fresh_claim(C))
    tc, tg, tpar, tfpar, tact, tfmin, tnopen, tnsel, tre = TE._select(
        tst, tab, torch.tensor(goal_g), torch.tensor(thr))
    act = np.asarray(jact)
    assert act.sum() > 0 and int(tre) == 0
    assert np.array_equal(tact.numpy(), act)
    for got, want in ((tc, jc), (tg, jg), (tpar, jpar), (tfpar, jfpar)):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert (int(tfmin), int(tnopen), int(tnsel)) == (int(jfmin), int(jnopen),
                                                     int(jnsel))
    assert np.array_equal(tab.t_state[:C].numpy(), np.asarray(jtab[4]))


# ------------------------------------------------------------------ insert

def prefill(jst, rs, n_keys, cols):
    """A (C, cols) key-row table holding n_keys random keys, each at the
    first empty slot of its probe sequence (as sequential inserts leave
    them).  Returns (t_key, coords, slots)."""
    C, W = jst.C, jst.W
    coords = np.unique(random_coords(rs, jst.final_np, n_keys), axis=0)
    keys = np.asarray(JE._pack_keys(jnp.asarray(coords), W))
    h0 = np.asarray(JE._hash_keys(jnp.asarray(keys))).astype(np.int64)
    t_key = np.full((C, cols), EMPTY, dtype=np.uint32)
    slots = []
    for key, h in zip(keys, h0):
        for r in range(jst.max_probes):
            s = (h + r * (r + 1) // 2) & (C - 1)
            if t_key[s, 0] == EMPTY:
                t_key[s, :W] = key
                slots.append(s)
                break
    return t_key, coords, np.array(slots)


def insert_batch(jst, rs, old):
    """Lane coordinates of an insert batch: stored keys, new keys (among
    them groups of distinct keys with one home slot) and duplicates of
    both in random order."""
    C = jst.C
    stored = {tuple(c) for c in old.tolist()}
    pool = np.unique(random_coords(rs, jst.final_np, 20000), axis=0)
    pool = pool[[tuple(c) not in stored for c in pool.tolist()]]
    home = np.asarray(JE._hash_keys(JE._pack_keys(jnp.asarray(pool), jst.W))) & (C - 1)
    # homes shared by at least 3 new keys: 3 keys each from 20 of them
    homes, counts = np.unique(home, return_counts=True)
    shared = rs.permutation(homes[counts >= 3])[:20]
    colliding = np.concatenate([pool[home == h][:3] for h in shared])
    fresh = pool[rs.choice(len(pool), 100, replace=False)]
    distinct = np.concatenate([old[rs.choice(len(old), 150, replace=False)],
                               colliding, fresh])
    lanes = np.repeat(distinct, rs.randint(1, 4, size=len(distinct)), axis=0)
    return lanes[rs.permutation(len(lanes))]


def key_map(t_key, W, cols):
    """{key words: the row's other columns, then cols at the row's slot}
    over the occupied rows of an int32 key-row table."""
    return {tuple(t_key[s, :W].tolist()): tuple(t_key[s, W:].tolist())
            + tuple(int(c[s]) for c in cols)
            for s in np.nonzero(t_key[:, 0] != -1)[0]}


def fresh_claim(C):
    return pad(np.full(C, JE.INFP, dtype=np.int32), JE.INFP)


def kinase_statics():
    return statics(golden_seqs("kinase.fasta"), 64, 1 << 10)


def test_insert_packed_matches_jax():
    jst, tst = kinase_statics()
    C, W = jst.C, jst.W
    rs = np.random.RandomState(11)
    t_key, old, slots = prefill(jst, rs, 410, jst.KW)
    t_key[slots, W] = old.sum(1) * 7  # h is a function of the coordinate
    t_best = np.full(C, JE.INFP, dtype=np.int32)
    t_best[slots] = (rs.randint(0, 4000, size=len(slots)) << jst.nb) | 1
    t_closed = np.full(C, JE.INFP, dtype=np.int32)
    t_closed[slots[::3]] = t_best[slots[::3]]
    assert 0.35 < len(slots) / C < 0.45
    lanes = insert_batch(jst, rs, old)
    L = len(lanes)
    keys = np.asarray(JE._pack_keys(jnp.asarray(lanes), W))
    h = (lanes.sum(1) * 7).astype(np.int32)
    packed = ((rs.randint(0, 4000, size=L) << jst.nb)
              | rs.randint(1, jst.M + 1, size=L)).astype(np.int32)
    jtab, jovf, _, _ = JE._insert_core_packed(
        jst, (jnp.asarray(t_key), jnp.asarray(t_best), jnp.asarray(t_closed)),
        jnp.full((C,), EMPTY, dtype=jnp.uint32), jnp.asarray(keys),
        jnp.asarray(h), jnp.asarray(packed), jnp.ones(L, dtype=bool),
        jnp.uint32(0))
    tab = TE.PackedTable(pad(t_key.view(np.int32), -1), pad(t_best, JE.INFP),
                         pad(t_closed, JE.INFP), fresh_claim(C))
    tovf, tre, acct = TE._insert_core_packed(
        tst, tab, torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(h),
        torch.from_numpy(packed.astype(np.int64)))
    assert int(tovf) == int(jovf) and int(tre) == 0 and int(acct[0]) == L
    jkey = np.asarray(jtab[0]).view(np.int32)
    want = key_map(jkey, W, [np.asarray(jtab[1])])
    got = key_map(tab.t_key[:C].numpy(), W, [tab.t_best[:C].numpy()])
    assert got == want
    assert len(got) == len({tuple(c) for c in lanes.tolist()}
                           | {tuple(c) for c in old.tolist()})
    assert np.array_equal(tab.t_closed[:C].numpy(), t_closed)


def test_insert_unpacked_matches_jax():
    jst, tst = kinase_statics()
    C, W, nb = jst.C, jst.W, jst.nb
    rs = np.random.RandomState(12)
    t_key, old, slots = prefill(jst, rs, 410, W)
    k = len(slots)
    t_g = np.full(C, JE.INF, dtype=np.int32)
    t_f = np.full(C, JE.INF, dtype=np.int32)
    t_par = np.zeros(C, dtype=np.int32)
    t_state = np.zeros(C, dtype=np.int32)
    t_g[slots] = rs.randint(1000, 1100, size=k)
    t_f[slots] = t_g[slots] + 500
    t_par[slots] = rs.randint(1, jst.M + 1, size=k)
    t_state[slots] = rs.randint(1, 3, size=k)
    lanes = insert_batch(jst, rs, old)
    L = len(lanes)
    keys = np.asarray(JE._pack_keys(jnp.asarray(lanes), W))
    # g in a narrow band around the stored ones: many improvements, and
    # ties among a key's lanes at its new minimum; f above every stored f,
    # so an improved slot must drop its old (f, parent) word
    g = rs.randint(1000, 1100, size=L).astype(np.int32)
    f = (g + 1000 + rs.randint(0, 3, size=L)).astype(np.int32)
    par = rs.randint(1, jst.M + 1, size=L).astype(np.int32)
    jtab, jre, jovf, _ = JE._insert_core(
        jst, tuple(jnp.asarray(a) for a in (t_key, t_g, t_f, t_par, t_state)),
        jnp.full((C,), EMPTY, dtype=jnp.uint32), jnp.asarray(keys),
        jnp.asarray(g), jnp.asarray(f), jnp.asarray(par), jnp.ones(L, dtype=bool),
        JE._hash_keys(jnp.asarray(keys)), jnp.arange(L, dtype=jnp.uint32),
        jnp.uint32(0))
    tab = TE.UnpackedTable(
        pad(t_key.view(np.int32), -1), pad(t_g, JE.INF),
        pad(t_f.astype(np.int64) * (1 << nb) + t_par, JE.INF << nb),
        pad(t_state, 0), fresh_claim(C))
    tovf, tre, _ = TE._insert_core(
        tst, tab, torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(g),
        torch.from_numpy(f), torch.from_numpy(par))
    assert int(tovf) == int(jovf) == 0
    assert int(tre) == int(jre) > 0
    jkey = np.asarray(jtab[0]).view(np.int32)
    want = key_map(jkey, W, [np.asarray(a) for a in jtab[1:]])  # g f par state
    fpar = tab.t_fpar[:C].numpy()
    got = key_map(tab.t_key[:C].numpy(), W,
                  [tab.t_g[:C].numpy(), fpar >> nb, fpar & ((1 << nb) - 1),
                   tab.t_state[:C].numpy()])
    assert {k: (v[0], v[3]) for k, v in got.items()} == {
        k: (v[0], v[3]) for k, v in want.items()}
    # (f, parent): JAX's where its g-winner is unique, else the smallest
    # f * 2^n + mask among the lanes that brought the new minimum
    stored = key_map(t_key.view(np.int32), W, [t_g])
    writers = {}
    for key, gi, fi, pi in zip(map(tuple, keys.view(np.int32).tolist()), g, f, par):
        if gi < stored.get(key, (JE.INF,))[0] and gi == got[key][0]:
            writers.setdefault(key, []).append(int(fi) * (1 << nb) + int(pi))
    ties = 0
    for key, v in got.items():
        ws = writers.get(key, [])
        if len(ws) > 1:
            ties += 1
            assert v[1] * (1 << nb) + v[2] == min(ws)
        else:
            assert v[1:3] == want[key][1:3]
    assert ties > 0


def test_claims_smallest_tag_wins_and_need_no_reset():
    jst, tst = kinase_statics()
    C, W = jst.C, jst.W
    rs = np.random.RandomState(13)
    t_key, old, slots = prefill(jst, rs, 410, jst.KW)
    lanes = insert_batch(jst, rs, old)
    keys = torch.from_numpy(np.asarray(JE._pack_keys(jnp.asarray(lanes), W))
                            .astype(np.int64))
    h = torch.from_numpy(lanes.sum(1) * 7)
    packed = torch.from_numpy(rs.randint(0, 1 << 20, size=len(lanes)) << 5 | 1)

    def table(claim):
        return TE.PackedTable(pad(t_key.view(np.int32), -1),
                              pad(np.full(C, JE.INFP, np.int32), JE.INFP),
                              pad(np.full(C, JE.INFP, np.int32), JE.INFP),
                              claim)

    fresh = table(fresh_claim(C))
    # a claim array full of old tags, some below every tag of this call
    stale = table(torch.from_numpy(rs.randint(-2**31, 2**31 - 1, size=C + TE.TRASH,
                                              dtype=np.int64).astype(np.int32)))
    for tab in (fresh, stale):
        TE._insert_core_packed(tst, tab, keys, h, packed)
    assert torch.equal(fresh.t_key, stale.t_key)
    assert torch.equal(fresh.t_best, stale.t_best)
    # a second batch on the claim words the first call left, and on a
    # fresh claim array: the same table
    lanes = insert_batch(jst, rs, old)
    keys = TE._pack_keys(torch.from_numpy(lanes), W)
    again = TE.PackedTable(fresh.t_key.clone(), fresh.t_best.clone(),
                           fresh.t_closed.clone(), fresh_claim(C))
    for tab in (fresh, again):
        ovf, _, _ = TE._insert_core_packed(tst, tab, keys,
                                           torch.from_numpy(lanes.sum(1) * 7),
                                           torch.arange(len(lanes)) << 5 | 3)
        assert int(ovf) == 0
    assert torch.equal(fresh.t_key, again.t_key)
    assert torch.equal(fresh.t_best, again.t_best)
    # two new keys with one empty home slot: lane 0 (the smaller tag) takes
    # it, whichever of the two keys it carries
    pool = np.unique(random_coords(rs, jst.final_np, 4000), axis=0)
    pk = TE._pack_keys(torch.from_numpy(pool), W)
    ph = TE._probe_slot(TE._hash_keys(pk), 0, C - 1).numpy()
    free = t_key[ph, 0] == EMPTY
    homes, counts = np.unique(ph[free], return_counts=True)
    i, j = np.nonzero(ph == homes[counts >= 2][0])[0][:2]
    for a, b in ((i, j), (j, i)):
        tab = table(fresh_claim(C))
        TE._insert_core_packed(tst, tab, pk[[a, b]], torch.zeros(2, dtype=torch.int64),
                               torch.ones(2, dtype=torch.int64))
        assert torch.equal(tab.t_key[ph[a], :W], TE._as_i32(pk[a]))
        assert (tab.t_key[:C, :W] == TE._as_i32(pk[b])).all(1).sum() == 1


# ------------------------------------------------------------------ expand

# (inputs, triples): PF08184 with its one cube; kinase without cubes; with
# 4 cubes, as kinase's cover, a random 5-sequence input (kinase's own cubes
# would cost JAX's _Static 2.7 GB of corner rows and ~20 s here)
EXPAND_CASES = [(golden_seqs("PF08184.fasta"), "off"),
                (golden_seqs("PF08184.fasta"), "auto"),
                (golden_seqs("kinase.fasta"), "off"),
                (random_seqs(34, 5, 5, 11), "auto")]


@pytest.mark.parametrize("seqs,triples", EXPAND_CASES,
                         ids=["PF08184-off", "PF08184-auto", "kinase-off",
                              "random5-auto"])
@pytest.mark.parametrize("route", ["packed", "unpacked"])
def test_expand_matches_jax(seqs, triples, route):
    B = 64
    jst, tst = statics(seqs, B, 1 << 16, triples)
    assert jst.T3 == tst.T3 == {"off": 0, "auto": 1 if len(seqs) == 3 else 4}[triples]
    rs = np.random.RandomState(3)
    coords = random_coords(rs, jst.final_np, B)
    coords[0] = 0
    coords[1] = jst.final_np - 1
    g = rs.randint(0, 200000, size=B).astype(np.int32)
    par = rs.randint(1, jst.M + 1, size=B).astype(np.int32)
    active = rs.rand(B) < 0.8
    args = [jnp.asarray(a) for a in (coords, g, par, active)]
    targs = [torch.from_numpy(a) for a in (coords, g, par, active)]
    if route == "packed":
        # the packed run loop: g given, T8 rows
        _, jg, jf, jm, jv, jgoal, jchild, jh = JE._expand(
            jst, *args, None, jst.d_tables4, jst.d_enc)
        tg, tf, tm, tv, tgoal, tchild = TE._expand(tst, *targs)
        # the packed insert stores h = f - g
        assert np.array_equal((tf - tg).numpy()[tv.numpy()],
                              np.asarray(jh)[np.asarray(jv)])
    else:
        # the unpacked run loop: pathmax on the parent's f, flat tables
        f_par = g + rs.randint(0, 400000, size=B).astype(np.int32)
        _, jg, jf, jm, jv, jgoal, jchild, _ = JE._expand(
            jst, *args, jnp.asarray(f_par))
        tg, tf, tm, tv, tgoal, tchild = TE._expand(
            tst, *targs, f_parent=torch.from_numpy(f_par))
        v = tv.numpy()
        raised = tf.numpy()[v] == np.repeat(f_par, jst.M)[v]
        assert 0 < raised.sum() < v.sum()  # pathmax binds on some lanes
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().sum() > 0 and tgoal.numpy().sum() == 1
    for got, want in ((tgoal, jgoal), (tm, jm), (tchild, jchild), (tg, jg),
                      (tf, jf)):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype))


# -------------------------------------------------------------- end to end

@functools.lru_cache(maxsize=None)
def port_hpair(name):
    p = Problem(golden_seqs(name))
    return p, HPairHeuristic.build(p, "cpu")


@pytest.mark.parametrize("name", ["test.fasta", "test2.fasta", "PF08184.fasta"])
@pytest.mark.parametrize("triples", ["off", "auto"])
@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_pinned_layout_goldens(layout, triples, name):
    gold = GOLD[name]
    p, h = port_hpair(name)
    eng = TE.FrontierSearch(p, h, device="cpu", triples=triples, layout=layout)
    assert eng.layout == layout
    res = eng.run()
    assert res.g == gold["optimal_g"]
    assert build_alignment(p, res.closed) == gold["alignment"]
    assert res.closed[tuple(int(v) for v in p.final_coord)][0] == res.g
    assert eng.last_phase_walls["walk"] > 0


@functools.lru_cache(maxsize=None)
def serial_g(seed):
    seqs = random_seqs(seed)
    return SerialAStar(JProblem(seqs), both_hpair(seqs)[0]).run().g


@pytest.mark.parametrize("seed", [7, 8, 9])
@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_random_matches_serial(layout, seed):
    seqs = random_seqs(seed)
    eng = TE.FrontierSearch(Problem(seqs), both_hpair(seqs)[1], device="cpu",
                            batch=64, capacity=1 << 14, layout=layout)
    assert eng.run().g == serial_g(seed)


def test_near_identical_family_auto_is_packed():
    seqs = family(np.random.default_rng(5), 5, 130, sub=0.05, indel=0.0)
    jh, th = both_hpair(seqs)
    jeng = JE.TpuFrontierSearch(JProblem(seqs), jh, capacity=1 << 14)
    teng = TE.FrontierSearch(Problem(seqs), th, device="cpu", capacity=1 << 14)
    assert teng.st.sig_bits == jeng.st.sig_bits == 40
    assert teng.layout == jeng.layout == "packed"
    assert (teng.ub, teng.st.f0, teng.st.B) == (jeng.ub, jeng.st.f0, jeng.st.B)
    tres = teng.run()
    assert tres.g == jeng.run().g
    assert tres.closed[tuple(len(s) for s in seqs)][0] == tres.g


@pytest.mark.parametrize("name,bits", [("globin6", 48), ("synth7", 49),
                                       ("synth10", 60)])
def test_large_inputs_are_not_sig(name, bits):
    p = problem_from_fasta(os.path.join(HERE, "data", f"{name}.fasta"))
    jst, tst = statics(p.seqs, 64, 1 << 23)
    assert tst.sig_bits == jst.sig_bits == bits
    assert not tst.sig_ok and not jst.sig_ok
    assert (tst.W, tst.KW) == (jst.W, jst.KW) == ((p.n_seq + 1) // 2,
                                                 (p.n_seq + 1) // 2 + 1)


def test_n10_family_matches_jax():
    # tests/test_large_n.py::TestN10 (JAX's auto picks sig here)
    seqs = family(np.random.default_rng(100), 10, 7)
    jh, th = both_hpair(seqs)
    jeng = JE.TpuFrontierSearch(JProblem(seqs), jh, capacity=1 << 16)
    teng = TE.FrontierSearch(Problem(seqs), th, device="cpu", capacity=1 << 16)
    assert teng.layout == jeng.layout
    tres = teng.run()
    assert tres.g == jeng.run().g
    # and pinned packed, whose keys take 5 words here
    res = TE.FrontierSearch(Problem(seqs), th, device="cpu", capacity=1 << 16,
                            layout="packed").run()
    assert res.g == tres.g


def test_n16_packed_eligibility(monkeypatch):
    # tests/test_large_n.py::test_n16_packed_eligibility.  Both packages get
    # a beam-1 upper bound (their beam-32 default costs ~37 s a package on
    # a CPU at N = 16; beam 1 gives the same bound here)
    for mod in (JB, TE):
        ub = mod.greedy_upper_bound
        monkeypatch.setattr(mod, "greedy_upper_bound",
                            lambda p, h, beam, ub=ub: ub(p, h, beam=1))
    seqs = family(np.random.default_rng(163), 16, 5, sub=0.25, indel=0.05)
    jh, th = both_hpair(seqs)
    jeng = JE.TpuFrontierSearch(JProblem(seqs), jh, capacity=1 << 14, batch=16)
    teng = TE.FrontierSearch(Problem(seqs), th, device="cpu", capacity=1 << 14,
                             batch=16)
    assert teng.st.f0 == jeng.st.f0 > (1 << 15)
    assert teng.ub == jeng.ub
    assert teng.packed and jeng.packed
    assert teng.layout == jeng.layout


def test_degenerate_weights_warn_and_complete():
    # tests/test_tpu_engine.py::TestDegenerateWeights
    seqs = ("WYWY", "WYY", "YWW")
    jh, th = both_hpair(seqs)
    wi = th.weight_i
    assert (wi[~np.eye(3, dtype=bool)] <= 0).any()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jres = JE.TpuFrontierSearch(JProblem(seqs), jh, batch=16,
                                    capacity=1 << 12).run()
        eng = TE.FrontierSearch(Problem(seqs), th, device="cpu", batch=16,
                                capacity=1 << 12)
        assert eng.ub == TE.INF and eng.layout == "unpacked"
        res = eng.run()
    assert sum("optimality is undefined" in str(x.message) for x in w) == 2
    assert res.closed and res.g == jres.g


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_overflow_regrow_keeps_pinned_layout(layout):
    p, h = port_hpair("PF08184.fasta")
    eng = TE.FrontierSearch(p, h, device="cpu", batch=64, capacity=1 << 5,
                            layout=layout)
    res = eng.run()
    assert res.g == 24450
    assert eng.regrown and eng.st.C > (1 << 5) and eng.layout == layout


def test_ineligible_layouts_raise():
    p, h = port_hpair("PF08184.fasta")
    with pytest.raises(ValueError):
        TE.FrontierSearch(p, h, device="cpu", layout="bucketed")
    # 8 x 60 residues: 48 sig bits, more than a 2^16 table's 38
    seqs = random_seqs(31, n=8, lo=40, hi=60)
    th = both_hpair(seqs)[1]
    eng = TE.FrontierSearch(Problem(seqs), th, device="cpu", capacity=1 << 16,
                            triples="off")
    assert not eng.st.sig_ok and eng.layout == "packed"
    with pytest.raises(ValueError, match="sig layout"):
        TE.FrontierSearch(Problem(seqs), th, device="cpu", capacity=1 << 16,
                          triples="off", layout="sig")
    # degenerate weights: no finite upper bound, so no packed word
    th = both_hpair(("WYWY", "WYY", "YWW"))[1]
    with pytest.raises(ValueError, match="packed layout"):
        TE.FrontierSearch(Problem(("WYWY", "WYY", "YWW")), th, device="cpu",
                          layout="packed")
