"""Port frontier engine, unit by unit, against the JAX engine's functions on
identical inputs (all values int32 or exact integers: zero tolerance).

- sig encoding: _sig_encode / _sig_decode bit for bit, and round trips;
- _expand (g, f, valid, mask, goal) on random parents;
- _select_sig and _adapt_thr on a synthesized table.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu.core.problem import Problem as JProblem
from mpi_pastar_msa_tpu.heuristic.hpair import HPairHeuristic as JHPair
from mpi_pastar_msa_tpu.search import engine as JE
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.search import engine as TE

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def golden_seqs(name):
    gold = json.load(open(os.path.join(HERE, "goldens.json")))[name]
    return tuple(r.replace("-", "") for r in gold["alignment"])


def statics(name, batch, capacity):
    seqs = golden_seqs(name)
    jh = JHPair.build(JProblem(seqs), backend="host")
    th = HPairHeuristic.from_numpy(Problem(seqs), jh.tables, jh.weight_f,
                                   jh.weight_i)
    jst = JE._Static(JProblem(seqs), jh, batch, capacity)
    tst = TE._Static(Problem(seqs), th, batch, capacity, "cpu")
    return jst, tst, jh


def random_coords(rs, final, k):
    return np.stack([rs.randint(0, int(v) + 1, size=k) for v in final],
                    axis=1).astype(np.int32)


@pytest.mark.parametrize("name,capacity", [("PF08184.fasta", 1 << 16),
                                           ("kinase.fasta", 1 << 23),
                                           ("kinase.fasta", 1 << 24)])
def test_sig_encode_decode_bit_exact(name, capacity):
    jst, tst, _ = statics(name, 64, capacity)
    assert tst.sig_bits == jst.sig_bits and tst.bbits == jst.bbits
    assert tst.sig_ok and jst.sig_ok
    rs = np.random.RandomState(7)
    coords = random_coords(rs, jst.final_np, 4096)
    coords[0] = 0
    coords[1] = jst.final_np
    jhome, jsig = JE._sig_encode(jst, jnp.asarray(coords))
    thome, tsig = TE._sig_encode(tst, torch.from_numpy(coords))
    assert np.array_equal(thome.numpy(), np.asarray(jhome).astype(np.int64))
    assert np.array_equal(tsig.numpy(), np.asarray(jsig).astype(np.int64))
    # decode at every probe round r of the bucket walk
    r = rs.randint(0, 64, size=len(coords))
    slots = ((thome.numpy() + r) & (jst.nbuck - 1)) * 8 + rs.randint(0, 8, size=len(coords))
    words = tsig.numpy() | r
    jdec = JE._sig_decode(jst, jnp.asarray(slots.astype(np.int32)),
                          jnp.asarray(words.astype(np.uint32)))
    tdec = TE._sig_decode(tst, torch.from_numpy(slots),
                          torch.from_numpy(words.astype(np.int32)))
    assert np.array_equal(tdec.numpy(), np.asarray(jdec).astype(np.int64))
    assert np.array_equal(tdec.numpy(), coords)
    assert (tsig.numpy() | 63).max() < 2**31  # fits the int32 table


def test_mix32_matches_jax():
    x = np.random.RandomState(2).randint(0, 2**32, size=10000, dtype=np.uint64)
    x[:3] = [0, 2**32 - 1, 0x9E3779B1]
    want = np.asarray(JE._mix32(jnp.asarray(x.astype(np.uint32))))
    got = TE._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("name", ["test.fasta", "PF08184.fasta"])
def test_expand_matches_jax(name):
    B = 64
    jst, tst, jh = statics(name, B, 1 << 16)
    rs = np.random.RandomState(3)
    coords = random_coords(rs, jst.final_np, B)
    coords[0] = 0
    coords[1] = jst.final_np - 1
    fpar = rs.randint(0, 200000, size=B).astype(np.int32)
    par = rs.randint(1, jst.M + 1, size=B).astype(np.int32)
    active = rs.rand(B) < 0.8
    _, jg, jf, jm, jv, jgoal, jchild, _ = JE._expand(
        jst, jnp.asarray(coords), jnp.asarray(fpar), jnp.asarray(par),
        jnp.asarray(active), g_is_f=True)
    tg, tf, tm, tv, tgoal, tchild = TE._expand(
        tst, torch.from_numpy(coords), torch.from_numpy(fpar),
        torch.from_numpy(par), torch.from_numpy(active), g_is_f=True)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().sum() > 0 and tgoal.numpy().sum() == 1
    assert np.array_equal(tgoal.numpy(), np.asarray(jgoal))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(tchild.numpy(), np.asarray(jchild))
    assert np.array_equal(tg.numpy(), np.asarray(jg).astype(np.int64))
    assert np.array_equal(tf.numpy(), np.asarray(jf).astype(np.int64))
    # on valid lanes, the JAX (g, f) equal the heuristic's own f = g + h
    v = tv.numpy()
    h_child = np.array([jh.calculate_h(c) for c in tchild.numpy()[v]])
    assert np.array_equal(tf.numpy()[v] - tg.numpy()[v], h_child)


def synth_table(jst, rs, n_keys):
    """A sig table holding n_keys random coordinates in their home buckets,
    random packed words, and a mix of open, closed and reopened slots."""
    C = jst.C
    coords = np.unique(random_coords(rs, jst.final_np, n_keys), axis=0)
    home, sig = JE._sig_encode(jst, jnp.asarray(coords))
    home, sig = np.asarray(home), np.asarray(sig)
    t_sig = np.full((jst.nbuck, 8), 0xFFFFFFFF, dtype=np.uint32)
    t_best = np.full(C, JE.INFP, dtype=np.int32)
    t_closed = np.full(C, JE.INFP, dtype=np.int32)
    fill = {}
    for hb, s in zip(home, sig):
        way = fill.get(int(hb), 0)
        if way == 8:
            continue
        fill[int(hb)] = way + 1
        slot = int(hb) * 8 + way
        t_sig[hb, way] = s
        best = (rs.randint(0, 3000) << jst.nb) | rs.randint(1, jst.M + 1)
        t_best[slot] = best
        u = rs.rand()
        if u < 0.3:
            t_closed[slot] = best  # closed
        elif u < 0.45:
            t_closed[slot] = best + (rs.randint(1, 50) << jst.nb)  # reopened
    return t_sig, t_best, t_closed


@pytest.mark.parametrize("thr,goal_off", [(0, 10**9), (40, 10**9), (500, 1500)])
def test_select_matches_jax(thr, goal_off):
    B, C = 64, 1 << 14
    jst, tst, _ = statics("PF08184.fasta", B, C)
    t_sig, t_best, t_closed = synth_table(jst, np.random.RandomState(5), 3000)
    goal_g = jst.f0 + goal_off
    jtab, jc, jf, jpar, jact, jfmin, jnopen, jnsel, jre = JE._select_sig(
        jst, (jnp.asarray(t_sig), jnp.asarray(t_best), jnp.asarray(t_closed)),
        jnp.int32(min(goal_g, 2**30)), jnp.int32(thr))
    pad = np.full(TE.TRASH, JE.INFP, np.int32)
    tab = TE.SigTable(
        torch.from_numpy(np.concatenate([t_sig.reshape(-1).view(np.int32),
                                         np.full(TE.TRASH, -1, np.int32)])),
        torch.from_numpy(np.concatenate([t_best, pad])),
        torch.from_numpy(np.concatenate([t_closed, pad])))
    tc, tf, tpar, tfpar, tact, tfmin, tnopen, tnsel, tre = TE._select_sig(
        tst, tab, torch.tensor(min(goal_g, 2**30)), torch.tensor(thr))
    act = np.asarray(jact)
    assert act.sum() > 0 and tfpar is None
    assert np.array_equal(tact.numpy(), act)
    assert np.array_equal(tc.numpy()[act], np.asarray(jc)[act])
    assert np.array_equal(tf.numpy()[act], np.asarray(jf)[act])
    assert np.array_equal(tpar.numpy()[act], np.asarray(jpar)[act])
    assert int(tfmin) == int(jfmin)
    assert int(tnopen) == int(jnopen) and int(tnsel) == int(jnsel)
    assert int(tre) == int(jre)
    assert np.array_equal(tab.t_closed[:C].numpy(), np.asarray(jtab[2]))
    assert np.array_equal(tab.t_best[:C].numpy(), np.asarray(jtab[1]))


def test_adapt_thr_matches_jax():
    for B in (64, 1024, 16384):
        for thr in (0, 1, 31, 1000, (1 << 20) - 5, 1 << 20):
            for n_sel in sorted({0, 1, B // 2 - 1, B // 2, B - B // 8 - 1,
                                 B - B // 8, B}):
                want = int(JE._adapt_thr(jnp.int32(thr), jnp.int32(n_sel), B))
                got = int(TE._adapt_thr(torch.tensor(thr), torch.tensor(n_sel), B))
                assert got == want, (B, thr, n_sel)
