"""The path walk of the port (kernel K7, csrc/path_walk.cu, and its plain
version engine._walk) on the CPU, against the JAX engine's walks (all
values exact integers: zero tolerance).

- engine._walk against JAX _make_backtrace_sig, _make_backtrace_packed and
  _make_backtrace, on the finished tables of the port's searches of test,
  test2 and PF08184 in each layout and of the degenerate input (unpacked),
  handed to the JAX walk as their first C entries;
- a NumPy emulation of K7's schedule (one warp a node: every probe
  position of the node, its encoding computed as sig_key.cuh and
  step_state.cuh compute it; the home row first, then, on a miss there,
  lane l owning rows l + 32k, the first hit by a ballot over each group of
  32 rows in turn, the way inside the winning lane) against _walk on
  those tables and on planted ones: a node whose
  first hit lies beyond r = 0, in the first or the second half of the rows
  or at their edge, behind colliding keys in both halves and before a
  later copy of itself with another parent mask; a node that is not
  stored, where the walk ends and the engine raises "backtrace did not
  reach the origin";
- the walk's dispatch (a CPU table runs _walk; walk_cuda refuses what K7
  does not take) and FrontierResult.open_size against the table's counts
  in each layout (tests/test_tpu_engine.py's checks of the JAX result).
"""
import functools
import json
import os
import warnings

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
from mpi_pastar_msa_tpu_torch.search import step as TS

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))
LAYOUTS = ("sig", "packed", "unpacked")
NAMES = ("test.fasta", "test2.fasta", "PF08184.fasta")
DEGENERATE = ("WYWY", "WYY", "YWW")
M32 = 0xFFFFFFFF
# csrc/path_walk.cu: one warp, rows a lane (sig bucket rows, probe rows);
# csrc/sig_key.cuh: kSigOdd
K7_LANES, K7_SIG_ROWS, K7_KEY_ROWS, SIG_ODD = 32, 2, 4, 0x9E3779B1


def golden_seqs(name):
    return tuple(r.replace("-", "") for r in GOLD[name]["alignment"])


@functools.lru_cache(maxsize=None)
def both_hpair(seqs):
    jh = JHPair.build(JProblem(seqs), backend="host")
    th = HPairHeuristic.from_numpy(Problem(seqs), jh.tables, jh.weight_f, jh.weight_i)
    return jh, th


@functools.lru_cache(maxsize=None)
def finished(name, layout):
    """The port's search of ``name`` pinned to ``layout`` (the degenerate
    input: ``auto``) run on the CPU to its end: (engine, result, the table
    its walk was given)."""
    seqs = DEGENERATE if name == "degenerate" else golden_seqs(name)
    kw = dict(batch=16, capacity=1 << 12) if name == "degenerate" else {}
    seen = {}
    real = TE.walk

    def spy(st, tab, lay):
        seen["tab"] = tab
        return real(st, tab, lay)

    TE.walk = spy
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng = TE.FrontierSearch(Problem(seqs), both_hpair(seqs)[1], device="cpu",
                                    layout=layout, **kw)
            res = eng.run()
    finally:
        TE.walk = real
    return eng, res, seen["tab"]


def jax_walk(eng, tab, layout):
    """JAX's walk of ``layout`` on the first C entries of the port's table:
    (masks it emitted, final coordinate)."""
    st = eng.st
    jst = JE._Static(JProblem(eng.problem.seqs), both_hpair(eng.problem.seqs)[0], st.B, st.C)
    C = st.C
    u32 = lambda t: jnp.asarray(t[:C].numpy().view(np.uint32))
    i32 = lambda t: jnp.asarray(t[:C].numpy())
    if layout == "sig":
        jt = (u32(tab.t_sig).reshape(jst.nbuck, jst.ways), i32(tab.t_best), i32(tab.t_closed))
        fn = JE._make_backtrace_sig(jst)
    elif layout == "packed":
        jt = (u32(tab.t_key), i32(tab.t_best), i32(tab.t_closed))
        fn = JE._make_backtrace_packed(jst)
    else:
        fpar = tab.t_fpar[:C]
        t_f = (fpar >> st.nb).to(torch.int32)
        t_par = (fpar & ((1 << st.nb) - 1)).to(torch.int32)
        jt = (u32(tab.t_key), i32(tab.t_g), i32(t_f), i32(t_par), i32(tab.t_state))
        fn = JE._make_backtrace(jst)
    masks, coord = fn(jt, jnp.asarray(jst.final_np))
    masks = np.asarray(masks).astype(np.int64)
    emitted = int(np.count_nonzero(masks))
    assert not masks[emitted:].any()  # every emitted mask is nonzero here
    return masks[:emitted], np.asarray(coord).astype(np.int64)


# --------------------------------------------------- K7's schedule in NumPy

def mix32(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def i32(x):
    return x - (1 << 32) if x >= 1 << 31 else x


def k7_probe(st, tab, layout, coord):
    """Every probe position of the node at ``coord`` that path_walk.cu's
    lookup() loads, in JAX's flat order (sig: r x 8 + way over 64 bucket
    rows; key rows: r over 128): (slot, hit, parent mask) a position."""
    parmask = (1 << st.n) - 1
    c = [int(v) for v in coord]
    if layout == "sig":
        # sig_key.cuh::encode on the packed key, fields at the bit widths
        ckey, sh = 0, 0
        for v, w in zip(c, st.bitw):
            ckey |= v << sh
            sh += w
        bm = (1 << st.bbits) - 1
        clo, chi = ckey & bm, (ckey >> st.bbits) & M32
        home = ((clo * SIG_ODD) & bm) ^ (mix32(chi) & bm)
        sigb = (chi << 6) & M32
        t = np.arange(K7_LANES * K7_SIG_ROWS * 8)
        r, way = t >> 3, t & 7
        slot = (((home + r) & bm) << 3) | way
        word = np.array([i32(sigb | int(k)) for k in r])
        hit = (r < st.max_bprobes) & (tab.t_sig.numpy()[slot] == word)
        par = tab.t_best.numpy()[slot] & parmask
        return slot, hit, par
    # step_state.cuh::key_word, hash_keys, probe_slot
    c += [0] * (2 * st.W - len(c))
    kw = [c[2 * i] | (c[2 * i + 1] << 16) for i in range(st.W)]
    h = 2166136261
    for w in kw:
        h = ((h ^ w) * 16777619) & M32
    h0 = mix32(h)
    t = np.arange(K7_LANES * K7_KEY_ROWS)
    slot = (h0 + ((t * (t + 1)) >> 1)) & (st.C - 1)
    rows = tab.t_key.numpy()[slot, :st.W]
    hit = ((t < st.max_probes) & (rows[:, 0] != -1)
           & (rows == np.array([i32(w) for w in kw])).all(1))
    words = (tab.t_best if layout == "packed" else tab.t_fpar).numpy()[slot]
    return slot, hit, (words & parmask).astype(np.int64)


def warp_first_hit(hit, layout, home_first=True):
    """K7's first hit from one warp's loads.  Stage 1 (``home_first``):
    the home row alone, a ballot of lanes 0-7 over its ways (sig) or one
    compare of the row every lane read (key rows).  Stage 2, on a miss
    there: lane l holds rows l + 32k (k < 2 on sig, 4 on key rows); for
    each k in turn, a ballot of the lanes whose row hits (sig: the first
    matching way inside the lane), and the lowest lane of the first
    nonzero ballot.  The flat position, or None."""
    rows = hit.reshape(-1, 8) if layout == "sig" else hit[:, None]
    if home_first and rows[0].any():
        return int(np.argmax(rows[0]))
    for k in range(len(rows) // K7_LANES):
        lanes = rows[K7_LANES * k:K7_LANES * (k + 1)]
        ballot = lanes.any(1)
        if ballot.any():
            lane = int(np.argmax(ballot))
            r = K7_LANES * k + lane
            return r * 8 + int(np.argmax(lanes[lane])) if layout == "sig" else r
    return None


def emu_k7(st, tab, layout):
    """csrc/path_walk.cu on the CPU: from the goal, per node the warp's
    loads of every probe position, the first hit (warp_first_hit) and its
    parent mask by a shuffle from that lane, then the parent; (emitted
    masks, final coordinate)."""
    coord = st.final_np.astype(np.int64).copy()
    masks = []
    for _ in range(int(st.final_np.sum())):
        if not coord.any():
            break
        _, hit, par = k7_probe(st, tab, layout, coord)
        first = warp_first_hit(hit, layout)
        if first is None:
            break
        mask = int(par[first])
        masks.append(mask)
        coord -= (mask >> np.arange(st.n)) & 1
    return np.array(masks, dtype=np.int64), coord


def first_slot(st, tab, layout, coord):
    """The slot of the first hit of a stored node."""
    slot, hit, _ = k7_probe(st, tab, layout, coord)
    return int(slot[int(np.argmax(hit))])


# ------------------------------------------------- against JAX and _walk

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_walk_equals_jax_and_k7_schedule(layout, name):
    eng, res, tab = finished(name, layout)
    st = eng.st
    masks, coord = TE._walk(st, tab, layout)
    assert not coord.any() and len(masks) == len(res.closed) > 0
    jm, jc = jax_walk(eng, tab, layout)
    assert np.array_equal(masks, jm) and np.array_equal(coord, jc)
    em, ec = emu_k7(st, tab, layout)
    assert np.array_equal(masks, em) and np.array_equal(coord, ec)


def test_degenerate_walk_equals_jax_and_k7_schedule():
    eng, res, tab = finished("degenerate", "auto")
    assert eng.layout == "unpacked" and res.closed
    masks, coord = TE._walk(eng.st, tab, "unpacked")
    assert not coord.any()
    jm, jc = jax_walk(eng, tab, "unpacked")
    assert np.array_equal(masks, jm) and np.array_equal(coord, jc)
    em, ec = emu_k7(eng.st, tab, "unpacked")
    assert np.array_equal(masks, em) and np.array_equal(coord, ec)


# ------------------------------------------------------- planted tables

def planted_path(final, rs):
    """(node, parent mask) pairs from ``final`` to the origin, each mask a
    random nonzero subset of the node's nonzero coordinates."""
    coord, path = final.astype(np.int64).copy(), []
    while coord.any():
        live = np.flatnonzero(coord)
        pick = live[rs.rand(len(live)) < 0.5]
        mask = int(sum(1 << int(d) for d in (pick if len(pick) else live[:1])))
        path.append((coord.copy(), mask))
        coord = coord - ((mask >> np.arange(len(coord))) & 1)
    return path


def empty_table(st, layout):
    size = st.C + TE.TRASH
    full = lambda v, *shape, dtype=torch.int32: torch.full((size,) + shape, v, dtype=dtype)
    if layout == "sig":
        return TE.SigTable(full(-1), full(TE.INFP), full(TE.INFP))
    if layout == "packed":
        return TE.PackedTable(full(-1, st.KW), full(TE.INFP), full(TE.INFP), full(TE.INFP))
    return TE.UnpackedTable(full(-1, st.W), full(TE.INF), full(TE.INF << st.nb, dtype=torch.int64),
                            torch.zeros(size, dtype=torch.int32), full(TE.INFP))


def plant(st, tab, layout, path, ats, rs):
    """Store each path node with its parent mask at its first free probe
    position from ``ats[k]`` on (sig: a bucket row with an empty way, a
    random one), and a copy of it with another mask at the first free
    position four or more after (a later hit is never taken); then fill
    free positions before each node with other keys (sig: other words of
    the row, at most 3 a row; key rows: the coordinate + 70000):
    collisions in front of every node."""
    nw = lambda m: ((rs.randint(0, 1000) << st.nb) | m)
    cmask, bm = st.C - 1, st.nbuck - 1
    seqs = []
    for coord, mask in path:
        c = torch.as_tensor(coord)[None, :]
        if layout == "sig":
            home, sigb = (int(v[0]) for v in TE._sig_encode(st, c))
            seqs.append([((home + r) & bm) * 8 for r in range(64)])
        else:
            h0 = int(TE._hash_keys(TE._pack_keys(c, st.W))[0])
            seqs.append([int(TE._probe_slot(h0, r, cmask)) for r in range(st.max_probes)])

    def free(pos):
        if layout == "sig":
            return [pos + w for w in range(8) if int(tab.t_sig[pos + w]) == -1]
        return [pos] if int(tab.t_key[pos, 0]) == -1 else []

    def put(k, r, mask):
        coord = path[k][0]
        while not free(seqs[k][r]):
            r += 1
        slot = free(seqs[k][r])[rs.randint(len(free(seqs[k][r])))]
        if layout == "sig":
            tab.t_sig[slot] = int(TE._sig_encode(st, torch.as_tensor(coord)[None, :])[1][0]) | r
            tab.t_best[slot] = nw(mask)
        else:
            tab.t_key[slot, :st.W] = TE._as_i32(TE._pack_keys(torch.as_tensor(coord)[None, :],
                                                              st.W)[0])
            (tab.t_best if layout == "packed" else tab.t_fpar)[slot] = nw(mask)
        return r

    for k, ((coord, mask), at) in enumerate(zip(path, ats)):
        r = put(k, int(at), mask)
        put(k, r + 4, (mask % ((1 << st.n) - 1)) + 1)
    for k, (coord, _) in enumerate(path):
        for r in range(int(ats[k])):
            slots = free(seqs[k][r])[:3]
            for slot in slots:
                if layout == "sig":
                    tab.t_sig[slot] = (rs.randint(1, 1 << 20) << 6) | r
                else:
                    tab.t_key[slot, :st.W] = TE._as_i32(TE._pack_keys(
                        torch.as_tensor(coord + 70000)[None, :], st.W)[0])


def planted_statics(n, seed):
    rs = np.random.RandomState(seed)
    seqs = tuple("".join(rs.choice(list("ACDEFGHIKLMNPQRSTVWY"), size=rs.randint(6, 14)))
                 for _ in range(n))
    return TE._Static(Problem(seqs), both_hpair(seqs)[1], 16, 1 << 14, "cpu")


@pytest.mark.parametrize("n,seed", [(3, 1), (5, 2), (8, 3)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_k7_schedule_first_hit_beyond_round_zero(layout, n, seed):
    st = planted_statics(n, seed)
    assert layout != "sig" or st.sig_ok
    rs = np.random.RandomState(seed)
    path = planted_path(st.final_np, rs)
    tab = empty_table(st, layout)
    ats = rs.randint(0, 4, size=len(path))
    ats[0] = 3  # the goal itself behind three colliding positions
    plant(st, tab, layout, path, ats, rs)
    want = np.array([m for _, m in path], dtype=np.int64)
    masks, coord = TE._walk(st, tab, layout)
    assert np.array_equal(masks, want) and not coord.any()
    em, ec = emu_k7(st, tab, layout)
    assert np.array_equal(em, want) and not ec.any()
    # the goal's first hit is at position 3, not at its later copy
    slot, hit, _ = k7_probe(st, tab, layout, st.final_np)
    flat = np.flatnonzero(hit)
    assert len(flat) == 2 and (flat[0] >> 3 if layout == "sig" else flat[0]) == 3


@pytest.mark.parametrize("where,lo,hi,goal_at", [
    # every node's first hit at rows 28-31 and its later copy in the second
    # half; every first hit in the second half (rows 32 on: the second
    # ballot on sig, the second quarter's on key rows), behind colliding
    # keys in both halves
    ("edge", 28, 32, 31), ("second", 32, 40, 37)])
@pytest.mark.parametrize("n,seed", [(3, 4), (5, 5)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_k7_schedule_first_hit_in_either_half(layout, n, seed, where, lo, hi, goal_at):
    st = planted_statics(n, seed)
    rs = np.random.RandomState(seed)
    path = planted_path(st.final_np, rs)
    tab = empty_table(st, layout)
    ats = rs.randint(lo, hi, size=len(path))
    ats[0] = goal_at
    plant(st, tab, layout, path, ats, rs)
    want = np.array([m for _, m in path], dtype=np.int64)
    masks, coord = TE._walk(st, tab, layout)
    assert np.array_equal(masks, want) and not coord.any()
    em, ec = emu_k7(st, tab, layout)
    assert np.array_equal(em, want) and not ec.any()
    # the goal: colliders in every row before its first hit, that hit at
    # goal_at (the ballot of its half) and its later copy behind it
    slot, hit, _ = k7_probe(st, tab, layout, st.final_np)
    rows = np.flatnonzero(hit) >> 3 if layout == "sig" else np.flatnonzero(hit)
    assert len(rows) == 2 and rows[0] == goal_at and rows[1] >= goal_at + 4
    first = np.flatnonzero(hit)[0]
    assert warp_first_hit(hit, layout) == warp_first_hit(hit, layout, False) == first
    if layout == "sig":
        words = tab.t_sig.numpy()[slot].reshape(64, 8)
        assert ((words != -1).sum(1)[:goal_at] > 0).all()
    else:
        assert (tab.t_key.numpy()[slot[:goal_at], 0] != -1).all()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_node_not_stored_ends_the_walk_and_the_engine_raises(layout):
    eng, res, tab = finished("PF08184.fasta", layout)
    st = eng.st
    masks, _ = TE._walk(st, tab, layout)
    # the node after 5 steps along the path loses its entry (another key)
    coord = st.final_np.astype(np.int64).copy()
    for m in masks[:5]:
        coord -= (int(m) >> np.arange(st.n)) & 1
    broken = type(tab)(*(t.clone() for t in vars(tab).values()))
    s = first_slot(st, broken, layout, coord)
    if layout == "sig":
        broken.t_sig[s] = int(broken.t_sig[s]) ^ (1 << 6)
    else:
        broken.t_key[s, 0] = int(broken.t_key[s, 0]) ^ 1
    got, end = TE._walk(st, broken, layout)
    assert np.array_equal(got, masks[:5]) and np.array_equal(end, coord)
    em, ec = emu_k7(st, broken, layout)
    assert np.array_equal(em, got) and np.array_equal(ec, end)
    with pytest.raises(RuntimeError, match="backtrace did not reach the origin"):
        eng._finish(broken, res.g, res.steps, res.nodes_expanded, res.nodes_reopened)


def test_k7_constants_match_source():
    # the emulation's warp against csrc/path_walk.cu and csrc/sig_key.cuh;
    # the warp's rows cover JAX's probe counts (64 bucket rows, 128 rounds)
    csrc = os.path.join(HERE, "..", "mpi_pastar_msa_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "path_walk.cu")).read()
    for name, value in (("kThreads", K7_LANES), ("kSigRows", K7_SIG_ROWS),
                        ("kKeyRows", K7_KEY_ROWS)):
        assert f"constexpr int {name} = {value};" in src
    assert f"kSigOdd = 0x{SIG_ODD:08X}u;" in open(os.path.join(csrc, "sig_key.cuh")).read()
    st = planted_statics(5, 2)
    assert (K7_LANES * K7_SIG_ROWS, K7_LANES * K7_KEY_ROWS) == (st.max_bprobes, st.max_probes)


# ------------------------------------------------ dispatch and open_size

def test_walk_dispatch(monkeypatch):
    eng, res, tab = finished("test.fasta", "packed")
    calls = []
    real = TE._walk
    monkeypatch.setattr(TE, "_walk", lambda *a: calls.append(a[2]) or real(*a))
    masks, coord = TE.walk(eng.st, tab, "packed")
    assert calls == ["packed"] and len(masks) == len(res.closed) and not coord.any()
    meta = TE.PackedTable(*(t.to("meta") for t in vars(tab).values()))
    with pytest.raises(ValueError, match="CUDA or a CPU table"):
        TE.walk(eng.st, meta, "packed")
    # K7's wrapper takes CUDA tables only, of the layout it is told
    with pytest.raises(ValueError, match="CUDA tensor"):
        TS.walk_cuda(eng.st, tab, "packed")
    with pytest.raises(ValueError, match="needs its table"):
        TS.walk_cuda(eng.st, tab, "sig")
    with pytest.raises(ValueError, match="needs its table"):
        TS.walk_cuda(eng.st, tab, "bucketed")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_open_size_and_table_counts(layout):
    # tests/test_tpu_engine.py's checks of the JAX result's counts
    eng, res, tab = finished("PF08184.fasta", layout)
    (exp, reopen, n_closed, n_open), = res.shard_stats
    assert n_closed >= len(res.closed)
    assert n_closed <= exp
    assert exp == res.nodes_expanded
    assert n_open == res.open_size
    assert n_closed > 0 and n_open >= 0
    C = eng.st.C
    if layout == "unpacked":
        assert res.open_size == int((tab.t_state[:C] == 1).sum())
    else:
        assert res.open_size == int((tab.t_best[:C] < tab.t_closed[:C]).sum())
