"""Port triple cubes (heuristic/triples.py, kernel K2's plain version) and the
cube-aware engine against the JAX package, on the CPU (int32, zero
tolerance):

- the covers (pick_triangles, pick_cover, pick_fractional_cover) on random
  symmetric weight matrices;
- the plain cube fill against JAX's ``triple_tables_device`` cell for cell
  (INF3 included) and the NumPy host oracle inside each box;
- a NumPy emulation of the K2 kernel's loop nest (tile diagonals over
  ``k2_launch_shape``'s grid, halo, local planes) at small tiles against the
  plain fill and JAX, with every child it reads final; ``k2_launch_shape`` at
  kinase and its grid against every tile;
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
from mpi_pastar_msa_tpu_torch.core.cost import GAP_EXTENSION, GAP_GAP
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic import triples as TT
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.heuristic.weights import altschul_rationale2
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


def emulate_k2(cxy, cxz, cyz, lens, ws, tile):
    """NumPy emulation of ``csrc/triple_wavefront.cu``'s loop nest with
    tiles of ``tile`` cells: the INF3 fill, then tile diagonals descending
    over the rectangles of ``k2_launch_shape(...).grid``, and in each block
    the halo read from the stack, the costs, the local planes descending
    over the (v, w) threads and the store.  Asserts that every child it reads
    is final (a halo cell a finished launch stored, or a cell of the tile an
    earlier local plane wrote) and that every in-box cell is stored exactly
    once.  Returns the (T, S, S, S) int32 stack and its origins."""
    cxy, cxz, cyz, L, W = (np.asarray(x, dtype=np.int64)
                           for x in (cxy, cxz, cyz, lens, ws))
    T, S = cxy.shape[0], cxy.shape[-1]
    shape = TT.k2_launch_shape(L, S, tile)
    bi, bj, bk = shape.tile
    E, GG = GAP_EXTENSION, GAP_GAP
    H = np.full((T, S, S, S), TT.INF3, dtype=np.int64)
    ii, jj, kk = np.meshgrid(*(np.arange(S),) * 3, indexing="ij")
    final = np.stack([(ii > lx) | (jj > ly) | (kk > lz) for lx, ly, lz in L])
    v, w = np.divmod(np.arange(shape.threads), bk)  # thread (v, w)
    # the halo cells in the kernel's order: face u = bi, v = bj, w = bk
    fu = [(bi, y, z) for y in range(bj + 1) for z in range(bk + 1)]
    fv = [(x, bj, z) for x in range(bi) for z in range(bk + 1)]
    fw = [(x, y, bk) for x in range(bi) for y in range(bj)]
    hu, hv, hw = np.array(fu + fv + fw).T
    tu, tv, tw = (x.ravel() for x in np.meshgrid(
        np.arange(bi), np.arange(bj), np.arange(bk), indexing="ij"))
    for D in range(shape.diagonals - 1, -1, -1):
        a_lo, b_lo, rows, cols = (int(x) for x in shape.grid[D])
        for t in range(T):
            Lx, Ly, Lz = L[t]
            for a in range(a_lo, a_lo + rows):
                for b in range(b_lo, b_lo + cols):
                    c = D - a - b
                    i0, j0, k0 = a * bi, b * bj, c * bk
                    if c < 0 or i0 > Lx or j0 > Ly or k0 > Lz:
                        continue
                    sm = np.zeros((bi + 1, bj + 1, bk + 1), dtype=np.int64)
                    written = np.zeros(sm.shape, dtype=bool)
                    gi, gj, gk = i0 + hu, j0 + hv, k0 + hw
                    ok = (gi <= Lx) & (gj <= Ly) & (gk <= Lz)
                    assert final[t, gi[ok], gj[ok], gk[ok]].all()
                    sm[hu, hv, hw] = TT.INF3
                    sm[hu[ok], hv[ok], hw[ok]] = H[t, gi[ok], gj[ok], gk[ok]]
                    written[hu, hv, hw] = True
                    sxy = np.zeros((bi, bj), dtype=np.int64)
                    sxz = np.zeros((bi, bk), dtype=np.int64)
                    for u in range(bi):
                        for y in range(bj):
                            i, j = i0 + u, j0 + y
                            if i <= Lx and j <= Ly:
                                sxy[u, y] = cxy[t, i, j]
                        for z in range(bk):
                            i, k = i0 + u, k0 + z
                            if i <= Lx and k <= Lz:
                                sxz[u, z] = cxz[t, i, k]
                    j, k = j0 + v, k0 + w
                    jk_in = (j <= Ly) & (k <= Lz)
                    cost_yz = np.where(jk_in, cyz[t, np.minimum(j, S - 1),
                                                  np.minimum(k, S - 1)], 0)
                    wxy, wxz, wyz = W[t]
                    for p in range(bi + bj + bk - 3, -1, -1):
                        u = p - v - w
                        act = (u >= 0) & (u < bi)
                        u, vv, ww = u[act], v[act], w[act]
                        i, jt, kt = i0 + u, j[act], k[act]
                        assert not written[u, vv, ww].any()
                        inb = (i <= Lx) & jk_in[act]
                        goal = (i == Lx) & (jt == Ly) & (kt == Lz)
                        gxy, gxz = sxy[u, vv], sxz[u, ww]
                        best = np.full(len(u), TT.INF3, dtype=np.int64)
                        for m in range(1, 8):
                            bx, by, bz = m & 1, (m >> 1) & 1, m >> 2
                            mv = ((i + bx <= Lx) & (jt + by <= Ly)
                                  & (kt + bz <= Lz) & inb & ~goal)
                            cu, cv, cw = u + bx, vv + by, ww + bz
                            assert written[cu[mv], cv[mv], cw[mv]].all()
                            child = sm[cu, cv, cw]
                            mc = (wxy * (gxy if bx and by else (E if bx or by else GG))
                                  + wxz * (gxz if bx and bz else (E if bx or bz else GG))
                                  + wyz * (cost_yz[act] if by and bz
                                           else (E if by or bz else GG)))
                            take = mv & (child < TT.INF3) & (child + mc < best)
                            best = np.where(take, child + mc, best)
                        sm[u, vv, ww] = np.where(inb, np.where(goal, 0, best), TT.INF3)
                        written[u, vv, ww] = True
                    gi, gj, gk = i0 + tu, j0 + tv, k0 + tw
                    ok = (gi <= Lx) & (gj <= Ly) & (gk <= Lz)
                    assert not final[t, gi[ok], gj[ok], gk[ok]].any()
                    H[t, gi[ok], gj[ok], gk[ok]] = sm[tu[ok], tv[ok], tw[ok]]
                    final[t, gi[ok], gj[ok], gk[ok]] = True
    assert final.all()
    H = H.astype(np.int32)
    return H, H[:, 0, 0, 0]


# tile 2 x 3 x 4: box sides (L + 1) one below, at and one above a multiple of
# each tile side, a length-0 and length-1 side (a cube one tile thick), and
# covers of T = 2 and 3 cubes whose tile grids differ
@pytest.mark.parametrize("lens,tris", [
    ((1, 1, 1), [(0, 1, 2)]),
    ((0, 2, 3), [(0, 1, 2)]),
    ((2, 5, 7), [(0, 1, 2)]),
    ((3, 4, 8), [(0, 1, 2)]),
    ((1, 6, 6, 9), [(0, 1, 2), (1, 2, 3)]),
    ((5, 3, 11, 0, 7), [(0, 1, 2), (2, 3, 4), (0, 1, 4)]),
], ids=["ones", "zero", "ragged-a", "ragged-b", "T2", "T3-zero"])
def test_k2_tile_schedule_matches_plain_and_jax(lens, tris):
    seqs = seqs_of_lengths(11, lens)
    rs = np.random.RandomState(sum(lens))
    tws = [tuple(int(v) for v in rs.randint(0, 60, size=3)) for _ in tris]
    args = TT.triple_inputs(Problem(seqs), tris, tws, "cpu")
    got, got_org = emulate_k2(**{k: v.numpy() for k, v in args.items()},
                              tile=(2, 3, 4))
    want, want_org = TT.triple_tables_plain(**args)
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(got_org, want_org.numpy())
    jwant, jorg = JT.triple_tables_device(JProblem(seqs), tris, None,
                                          tri_weights=tws)
    assert np.array_equal(got, np.asarray(jwant))
    assert np.array_equal(got_org, np.asarray(jorg))


def test_k2_launch_shape_at_kinase():
    gold = json.load(open(os.path.join(HERE, "goldens.json")))["kinase.fasta"]
    p = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    _, wi = altschul_rationale2(p.seqs)
    tris = [t for t, _ in TT.pick_cover(wi, p.n_seq)]
    lens = [[len(p.seqs[x]) for x in t] for t in tris]
    S = p.max_length + 2
    shape = TT.k2_launch_shape(lens, S)
    assert shape.tile == TT.K2_TILE == (32, 16, 16) and shape.threads == 256
    assert shape.tiles.tolist() == [[9, 18, 17], [9, 18, 18], [9, 17, 18],
                                    [9, 17, 18]]
    assert shape.diagonals == 43  # against 813 planes of one cell each
    assert shape.grid.shape == (43, 4) and shape.grid.dtype == np.int32
    sizes = 4 * shape.grid[:, 2] * shape.grid[:, 3]
    assert shape.blocks == sizes.sum() == 15_888
    assert shape.max_blocks == sizes.max() == 648
    with pytest.raises(ValueError):
        TT.k2_launch_shape(lens, S, (0, 16, 16))
    with pytest.raises(ValueError):
        TT.k2_launch_shape([[0, 0, S - 1]], S)


# each diagonal's rectangle holds every tile of that diagonal in every cube,
# and each of its rows and columns holds one in a cube of the largest counts
@pytest.mark.parametrize("lens,tile", [
    ([[267, 276, 263], [267, 273, 272], [276, 263, 272], [276, 263, 273]],
     TT.K2_TILE),
    ([[1, 40, 300]], TT.K2_TILE),
    ([[0, 0, 0]], TT.K2_TILE),
    ([[5, 3, 11], [11, 0, 7], [5, 3, 7]], (2, 3, 4)),
], ids=["kinase", "ragged", "origin-only", "T3-small-tiles"])
def test_k2_launch_grid_covers_each_tile(lens, tile):
    S = max(max(l) for l in lens) + 2
    shape = TT.k2_launch_shape(lens, S, tile)
    na, nb, nc = shape.tiles.max(0)
    assert shape.diagonals == max(sum(t) for t in shape.tiles.tolist()) - 2
    for D, (a_lo, b_lo, rows, cols) in enumerate(shape.grid.tolist()):
        assert rows >= 1 and cols >= 1
        a_of = range(a_lo, a_lo + rows)
        assert all(any(0 <= D - a - b < nc for b in range(b_lo, b_lo + cols))
                   for a in a_of)
        assert all(any(0 <= D - a - b < nc for a in a_of)
                   for b in range(b_lo, b_lo + cols))
    for ta, tb, tc in shape.tiles.tolist():
        for a in range(ta):
            for b in range(tb):
                for c in range(tc):
                    a_lo, b_lo, rows, cols = shape.grid[a + b + c]
                    assert a_lo <= a < a_lo + rows and b_lo <= b < b_lo + cols


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
        torch.from_numpy(par), torch.from_numpy(active), g_is_f=True)
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
