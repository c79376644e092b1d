"""Port triple cubes (heuristic/triples.py, kernel K2's plain version) and the
cube-aware engine against the JAX package, on the CPU (int32, zero
tolerance):

- the covers (pick_triangles, pick_cover, pick_fractional_cover) on random
  symmetric weight matrices;
- the plain cube fill against JAX's ``triple_tables_device`` cell for cell
  (INF3 included) and the NumPy host oracle inside each box;
- ``HTriples.build`` (cherry and fractional covers, the fallback warning)
  and ``HTriples.from_numpy`` against JAX's ``HTriples``;
- ``_expand`` with cubes against JAX's ``_expand(..., g_is_f=True)``;
- end to end: g and the path (``closed``) against ``TpuFrontierSearch`` with
  the same ``triples``; the fractional cover's g and degapped rows.

Inputs are rebuilt from tests/goldens.json or drawn with numpy from a seed.
"""
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
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic import triples as TT
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.search import engine as TE
from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

AMINO = "ACDEFGHIKLMNPQRSTVWY"
HERE = os.path.dirname(os.path.abspath(__file__))
PF08184 = tuple(r.replace("-", "") for r in json.load(open(
    os.path.join(HERE, "goldens.json")))["PF08184.fasta"]["alignment"])


def random_seqs(seed, n, lo, hi):
    rs = np.random.RandomState(seed)
    return tuple("".join(rs.choice(list(AMINO), size=rs.randint(lo, hi + 1)))
                 for _ in range(n))


def seqs_of_lengths(seed, lens):
    rs = np.random.RandomState(seed)
    return tuple("".join(rs.choice(list(AMINO), size=L)) for L in lens)


def fractional_seqs(n, seed):
    """The random inputs of tests/test_triples.py::TestFractional."""
    rng = np.random.default_rng(seed)
    return tuple("".join(rng.choice(list(AMINO), size=rng.integers(4, 8)))
                 for _ in range(n))


def both_hpair(seqs):
    jh = JHPair.build(JProblem(seqs), backend="host")
    th = HPairHeuristic.from_numpy(Problem(seqs), jh.tables, jh.weight_f,
                                   jh.weight_i)
    return jh, th


def carried(jht, th):
    """The JAX HTriples' cubes carried over onto the port's HPair."""
    return TT.HTriples.from_numpy(th, jht.triangles, jht.tri_weights,
                                  np.asarray(jht.tri_tabs), jht.cost_scale)


def random_coords(rs, final, k):
    return np.stack([rs.randint(0, int(v) + 1, size=k) for v in final],
                    axis=1).astype(np.int32)


@pytest.mark.parametrize("n", [3, 4, 5, 6, 7, 8])
def test_covers_match_jax(n):
    rs = np.random.RandomState(100 + n)
    for hi in (4, 40):  # few distinct weights: many ties in the tie order
        w = rs.randint(1, hi, size=(n, n)).astype(np.int32)
        w = np.triu(w, 1) + np.triu(w, 1).T
        for cap in (None, 1, 2, 3):
            assert TT.pick_triangles(w, n, cap) == JT.pick_triangles(w, n, cap)
            assert TT.pick_cover(w, n, cap) == JT.pick_cover(w, n, cap)
        assert TT.pick_fractional_cover(w, n) == JT.pick_fractional_cover(w, n)


@pytest.mark.parametrize("lens,tris", [
    ((1, 1, 1), [(0, 1, 2)]),
    ((1, 6, 11), [(0, 1, 2)]),
    ((9, 4, 1, 7, 5), [(0, 1, 2), (1, 3, 4), (0, 2, 3)]),
], ids=["T1-ones", "T1-ragged", "T3-ragged"])
def test_plain_fill_matches_jax_and_oracle(lens, tris):
    seqs = seqs_of_lengths(7, lens)
    jh, _ = both_hpair(seqs)
    wi = jh.weight_i
    tws = [(int(wi[x, y]), int(wi[x, z]), int(wi[y, z])) for x, y, z in tris]
    want, want_org = JT.triple_tables_device(JProblem(seqs), tris, wi,
                                             tri_weights=tws)
    got, got_org = TT.triple_tables(**TT.triple_inputs(Problem(seqs), tris,
                                                       tws, "cpu"))
    S = max(lens) + 2
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(tris), S, S, S)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_org.numpy(), np.asarray(want_org))
    for t, (x, y, z) in enumerate(tris):
        host = TT.triple_suffix_table_host(seqs[x], seqs[y], seqs[z], *tws[t])
        box = got.numpy()[t, : lens[x] + 1, : lens[y] + 1, : lens[z] + 1]
        assert np.array_equal(box.astype(np.int64), host)
        assert (got.numpy()[t] == TT.INF3).sum() == S**3 - box.size


def assert_same_htriples(th3, jh3, seqs, n_coords=30):
    assert th3.triangles == [tuple(t) for t in jh3.triangles]
    assert th3.tri_weights == [tuple(w) for w in jh3.tri_weights]
    assert th3.cost_scale == jh3.cost_scale
    assert th3.covered_pairs == jh3.covered_pairs
    assert np.array_equal(th3.weight_i, jh3.weight_i)
    assert np.array_equal(th3.pair_weights_i(), jh3.pair_weights_i())
    assert np.array_equal(th3.pair_weights_h_i(), jh3.pair_weights_h_i())
    assert np.array_equal(th3.tri_tabs.numpy(), np.asarray(jh3.tri_tabs))
    final = np.array([len(s) for s in seqs], dtype=np.int32)
    rs = np.random.RandomState(4)
    coords = [np.zeros_like(final), final] + list(random_coords(rs, final, n_coords))
    for c in coords:
        assert th3.calculate_h(c) == jh3.calculate_h(c)


@pytest.mark.parametrize("seqs,fractional", [
    (PF08184, False),
    (random_seqs(31, 5, 4, 10), False),
    (random_seqs(32, 6, 3, 8), False),
    (fractional_seqs(4, 11), True),
    (fractional_seqs(5, 13), True),
], ids=["PF08184", "random5", "random6", "frac4", "frac5"])
def test_build_matches_jax(seqs, fractional):
    jh, th = both_hpair(seqs)
    kw = dict(fractional=True, budget_bytes=10 << 30) if fractional else {}
    jh3 = JT.HTriples.build(jh, **kw)
    th3 = TT.HTriples.build(th, device="cpu", **kw)
    assert th3.cost_scale == (len(seqs) - 2 if fractional else 1)
    assert_same_htriples(th3, jh3, seqs)


def test_fractional_fallback_warns_like_jax():
    seqs = fractional_seqs(5, 14)
    jh, th = both_hpair(seqs)
    with pytest.warns(RuntimeWarning, match="fractional"):
        jh3 = JT.HTriples.build(jh, fractional=True, max_triangles=3)
    with pytest.warns(RuntimeWarning, match="fractional"):
        th3 = TT.HTriples.build(th, fractional=True, max_triangles=3,
                                device="cpu")
    assert th3.cost_scale == 1 and len(th3.triangles) == 3
    assert_same_htriples(th3, jh3, seqs)


def test_not_applicable_returns_none():
    _, th = both_hpair(random_seqs(3, 2, 5, 9))  # N = 2: no triangle
    assert TT.HTriples.build(th, device="cpu") is None
    _, th = both_hpair(random_seqs(3, 4, 5, 9))
    assert TT.HTriples.build(th, device="cpu", budget_bytes=1) is None


def test_from_numpy_round_trip():
    seqs = random_seqs(33, 5, 4, 10)
    jh, th = both_hpair(seqs)
    jh3 = JT.HTriples.build(jh)
    th3 = carried(jh3, th)
    assert th3.tri_tabs.dtype == torch.int32
    assert_same_htriples(th3, jh3, seqs)
    back = TT.HTriples.from_numpy(th3.base, th3.triangles, th3.tri_weights,
                                  th3.tri_tabs.numpy(), th3.cost_scale)
    assert_same_htriples(back, jh3, seqs, n_coords=5)


@pytest.mark.parametrize("seqs,T", [(PF08184, 1),
                                    (random_seqs(34, 5, 5, 11), 4)],
                         ids=["PF08184", "random5"])
def test_expand_with_cubes_matches_jax(seqs, T):
    B = 64
    jh, th = both_hpair(seqs)
    jh3 = JT.HTriples.build(jh)
    th3 = carried(jh3, th)
    assert len(th3.triangles) == T
    jst = JE._Static(JProblem(seqs), jh3, B, 1 << 16)
    tst = TE._Static(Problem(seqs), th3, B, 1 << 16, "cpu")
    assert tst.T3 == jst.T3 == T and tst.f0 == jst.f0
    assert np.array_equal(tst.tri_corner, jst.tri_corner)
    rs = np.random.RandomState(5)
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
        torch.from_numpy(par), torch.from_numpy(active))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().sum() > 0 and tgoal.numpy().sum() == 1
    assert np.array_equal(tgoal.numpy(), np.asarray(jgoal))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(tchild.numpy(), np.asarray(jchild))
    assert np.array_equal(tg.numpy(), np.asarray(jg).astype(np.int64))
    assert np.array_equal(tf.numpy(), np.asarray(jf).astype(np.int64))
    # on valid lanes f - g is the cube heuristic of the child
    v = tv.numpy()
    h_child = np.array([th3.calculate_h(c) for c in tchild.numpy()[v]])
    assert np.array_equal(tf.numpy()[v] - tg.numpy()[v], h_child)


@pytest.mark.parametrize("seqs,triples", [
    (PF08184, "auto"), (PF08184, "on"),
    (random_seqs(21, 4, 5, 12), "auto"), (random_seqs(21, 4, 5, 12), "on"),
    (random_seqs(22, 5, 4, 10), "auto"), (random_seqs(22, 5, 4, 10), "on"),
], ids=["PF08184-auto", "PF08184-on", "random21-auto", "random21-on",
        "random22-auto", "random22-on"])
def test_engine_matches_jax(seqs, triples):
    jh, th = both_hpair(seqs)
    jeng = JE.TpuFrontierSearch(JProblem(seqs), jh, triples=triples)
    jres = jeng.run()
    teng = TE.FrontierSearch(Problem(seqs), th, device="cpu", triples=triples)
    assert teng.heuristic.triangles == jeng.heuristic.triangles
    assert (teng.st.B, teng.fill_target, teng.ub, teng.st.f0) == (
        jeng.st.B, jeng.fill_target, jeng.ub, jeng.st.f0)
    tres = teng.run()
    assert tres.g == jres.g
    assert tres.closed == jres.closed  # same path, same g at every node
    assert tres.h == jres.h == 0


def test_default_is_auto():
    seqs = random_seqs(23, 4, 5, 9)
    _, th = both_hpair(seqs)
    eng = TE.FrontierSearch(Problem(seqs), th, device="cpu")
    assert eng.triples == "auto"
    assert eng.st.T3 == len(eng.heuristic.triangles) > 0
    assert eng.fill_target == max(64, eng.st.B // 2)
    eng.run()
    assert eng.last_phase_walls["cubes"] > 0


@pytest.mark.parametrize("n,seed", [(4, 11), (5, 13)])
def test_fractional_engine_matches_jax(n, seed):
    seqs = fractional_seqs(n, seed)
    jh, th = both_hpair(seqs)
    jres = JE.TpuFrontierSearch(JProblem(seqs), jh, triples="fractional").run()
    eng = TE.FrontierSearch(Problem(seqs), th, device="cpu",
                            triples="fractional")
    assert eng.heuristic.cost_scale == n - 2
    res = eng.run()
    assert res.g == jres.g
    al = build_alignment(Problem(seqs), res.closed)
    assert all(len(r) == len(al[0]) for r in al)
    assert [r.replace("-", "") for r in al] == list(seqs)
    goal = tuple(len(s) for s in seqs)
    assert res.closed[goal][0] == res.g


def test_on_without_cubes_raises():
    _, th = both_hpair(random_seqs(24, 2, 5, 9))
    for triples in ("on", "fractional"):
        with pytest.raises(ValueError, match="not applicable"):
            TE.FrontierSearch(Problem(th.problem.seqs), th, device="cpu",
                              triples=triples)
    with pytest.raises(ValueError):
        TE.FrontierSearch(Problem(th.problem.seqs), th, device="cpu",
                          triples="maybe")
    # auto quietly keeps the pairwise h
    eng = TE.FrontierSearch(Problem(th.problem.seqs), th, device="cpu")
    assert eng.st.T3 == 0 and eng.fill_target == max(64, eng.st.B // 16)


def test_overflow_regrow_keeps_cubes():
    # a table too small for the search regrows; the new statics carry the
    # cubes and the same f0, and the optimum is unchanged
    _, th = both_hpair(PF08184)
    eng = TE.FrontierSearch(Problem(PF08184), th, device="cpu", batch=64,
                            capacity=1 << 5)
    f0 = eng.st.f0
    res = eng.run()
    assert res.g == 24450
    assert eng.regrown and eng.st.C > (1 << 5)
    assert eng.st.T3 == 1 and eng.st.f0 == f0
