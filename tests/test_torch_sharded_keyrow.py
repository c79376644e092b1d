"""The port's sharded engine on the packed and unpacked layouts
(mpi_pastar_msa_tpu_torch/parallel/sharded.py) on the CPU: every layout
against the JAX package's ``ShardedFrontierSearch`` and ``SerialAStar``
on 4 of conftest's 8 CPU devices, PF08184 and test2 pinned to each key-row
layout byte-identical to the goldens, the key-row route's plain version
against JAX's ``_route_cap`` with key-row payloads, the unpacked carry
bound, the automatic capacity and layout against JAX's, the received rows'
claim tags of K10's plain version, one shard against FrontierSearch, and
the arguments of the new C entries against their signatures."""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mpi_pastar_msa_tpu.core.problem import Problem as JProblem
from mpi_pastar_msa_tpu.heuristic.hpair import HPairHeuristic as JHPair
from mpi_pastar_msa_tpu.parallel import sharded as JS
from mpi_pastar_msa_tpu.search.serial import SerialAStar as JSerial
from mpi_pastar_msa_tpu_torch import _kernels
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.parallel import sharded as S
from mpi_pastar_msa_tpu_torch.search import step as TS
from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
from mpi_pastar_msa_tpu_torch.search.bruteforce import optimal_cost
from mpi_pastar_msa_tpu_torch.search.engine import INF, INFP, FrontierSearch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))
AMINO = "ACDEFGHIKLMNPQRSTVWY"


def golden(name):
    return Problem(tuple(r.replace("-", "") for r in GOLD[name]["alignment"]))


def random_seqs(seed, n, lo, hi):
    rs = np.random.RandomState(seed)
    return tuple("".join(rs.choice(list(AMINO), size=rs.randint(lo, hi + 1)))
                 for _ in range(n))


# --- the engine against JAX's and against the goldens


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_layouts_equal_jax_and_serial(layout):
    """JAX tests/test_sharded.py::test_layouts_match_serial on the port:
    each layout pinned on 4 shards, batch 16, capacity 2^12; the g of JAX's
    ShardedFrontierSearch on 4 CPU devices and of SerialAStar."""
    seqs = ("ACDEFG", "ACDFG", "ACEFG")
    jp = JProblem(seqs)
    jh = JHPair.build(jp)
    want = JSerial(jp, jh).run().g
    jeng = JS.ShardedFrontierSearch(jp, jh, devices=jax.devices("cpu")[:4], batch=16,
                                    capacity=1 << 12, layout=layout)
    eng = S.ShardedFrontierSearch(Problem(seqs), devices=["cpu"] * 4, batch=16,
                                  capacity=1 << 12, layout=layout)
    assert eng.layout == jeng.layout == layout
    assert (eng.st.B, eng.st.C, eng.exchange_cap) == (jeng.st.B, jeng.st.C, jeng.exchange_cap)
    res = eng.run()
    assert res.g == jeng.run().g == want
    assert [r.replace("-", "") for r in build_alignment(Problem(seqs), res.closed)] == list(seqs)


@pytest.mark.parametrize("kw", [{"hash_type": "FSUM"},
                                {"hash_type": "PZORDER", "exchange": "ragged"},
                                {"hash_type": "FZORDER", "exchange_cap": 1}],
                         ids=["fsum", "pzorder_ragged", "fzorder_cap1"])
@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("name", ["PF08184.fasta", "test2.fasta"])
def test_keyrow_layouts_reach_golden(name, layout, ndev, kw):
    p = golden(name)
    eng = S.ShardedFrontierSearch(p, devices=["cpu"] * ndev, layout=layout, capacity=1 << 14,
                                  **kw)
    res = eng.run()
    assert eng.layout == layout
    assert eng.cubes_split == (layout == "packed")
    assert res.g == GOLD[name]["optimal_g"]
    assert build_alignment(p, res.closed) == GOLD[name]["alignment"]
    assert res.nodes_migrated == sum(r[4] for r in res.shard_stats) > 0
    # CPU shards run the chunked driver: one host read a chunk
    assert eng.last_stats["driver"] == "chunked"
    assert eng.last_stats["host_reads"] == -(-res.steps // eng.chunk_steps)


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_keyrow_one_shard_equals_frontier_search(layout):
    """One shard with the dense exchange is the single-table search of the
    same layout (JAX's ndev == 1 fast path)."""
    p = golden("PF08184.fasta")
    eng = S.ShardedFrontierSearch(p, devices=["cpu"], layout=layout)
    res = eng.run()
    ref = FrontierSearch(p, device="cpu", layout=layout).run()
    assert res.g == ref.g == GOLD["PF08184.fasta"]["optimal_g"]
    assert build_alignment(p, res.closed) == GOLD["PF08184.fasta"]["alignment"]
    assert eng.last_stats["exchange"] == "none"


def test_degenerate_auto_layout_equals_jax():
    """The degenerate input's automatic layout is unpacked, with no upper
    bound and no cubes, as JAX's (whose sharded run then stops at its own
    path-cost check, which JAX's single-table engine skips for degenerate
    weights; the port skips it in both: tests/test_torch_sharded.py runs
    this input against the single-table search)."""
    seqs = ("WYWY", "WYY", "YWW")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jeng = JS.ShardedFrontierSearch(JProblem(seqs), devices=jax.devices("cpu")[:2])
        eng = S.ShardedFrontierSearch(Problem(seqs), devices=["cpu"] * 2)
    assert eng.degenerate and jeng.degenerate
    assert eng.layout == jeng.layout == "unpacked"
    assert eng.ub == jeng.ub == INF and eng.st.T3 == jeng.st.T3 == 0
    assert (eng.st.B, eng.st.C, eng.exchange_cap) == (jeng.st.B, jeng.st.C, jeng.exchange_cap)


def test_auto_capacity_and_layout_equal_jax():
    """Eight sequences whose keys take 43 bits on 8 shards: JAX's automatic
    capacity is 2^20 a shard, too small for the sig word (43 > 20 - 3 +
    25), so it takes the packed layout; the port takes the same capacity,
    batch and layout (its former second capacity rule raised the capacity
    to 2^21 and ran sig)."""
    rs = np.random.RandomState(3)
    seqs = tuple("".join(rs.choice(list(AMINO), size=n))
                 for n in (16, 17, 18, 19, 20, 32, 33, 34))
    eng = S.ShardedFrontierSearch(Problem(seqs), devices=["cpu"] * 8)
    jeng = JS.ShardedFrontierSearch(JProblem(seqs), devices=jax.devices("cpu")[:8])
    assert eng.st.sig_bits == 43 and eng.packed
    assert (eng.layout, eng.st.C, eng.st.B) == (jeng.layout, jeng.st.C, jeng.st.B)
    assert (eng.layout, eng.st.C) == ("packed", 1 << 20)
    assert not eng.st.sig_ok


def test_multiprocess_mesh_refuses_unpacked():
    eng = S.ShardedFrontierSearch(golden("PF08184.fasta"), devices=["cpu"] * 2,
                                  layout="unpacked")
    eng.multiprocess = True
    with pytest.raises(NotImplementedError, match="multi-process"):
        eng.run()


# --- K11 on key rows: the plain route against JAX's _route_cap


def keyrow_route_inputs(seed, ndev, L, ccar, pw, f_range, fill, distinct):
    """Per shard: candidate rows (dest, fsort, pw payload words) with dest =
    ndev for a lane that stays, and a carry ring whose first rows are
    live, the rest ``fill``; distinct f values where ``distinct``."""
    rng = np.random.default_rng(seed)
    width = 2 + pw
    cand = rng.integers(-2**31, 2**31 - 1, (ndev, L, width)).astype(np.int32)
    carry = np.tile(np.array(fill, np.int32), (ndev, ccar, 1))
    f = rng.permutation(f_range)[: ndev * (L + ccar)].reshape(ndev, L + ccar) if distinct \
        else rng.integers(0, f_range, (ndev, L + ccar))
    for me in range(ndev):
        dest = rng.integers(0, ndev, L)
        dest[(dest == me) | (rng.random(L) > 0.7)] = ndev
        cand[me, :, 0] = dest
        cand[me, :, 1] = f[me, :L]
        live = rng.integers(0, ccar // 2)
        carry[me, :live, 0] = rng.integers(0, ndev, live)
        carry[me, :live, 1] = f[me, L:L + live]
        carry[me, :live, 2:] = rng.integers(-2**31, 2**31 - 1, (live, pw))
    return cand, carry


def jax_route_rows(ndev, cap, cand, carry, fills):
    mesh = Mesh(np.array(jax.devices("cpu")[:ndev]), (JS.AXIS,))
    pw = cand.shape[2] - 2

    def body(c, car):
        c, car = c[0], car[0]
        recv, nc, covf, cfm = JS._route_cap(ndev, cap, c[:, 0], c[:, 1],
                                            tuple(c[:, 2 + k] for k in range(pw)), car,
                                            fills=fills)
        return jnp.stack(recv, 1)[None], nc[None], covf[None], cfm[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(JS.AXIS), P(JS.AXIS)),
                               out_specs=(P(JS.AXIS),) * 4, check_vma=False))
    return [np.asarray(x) for x in fn(jnp.asarray(cand), jnp.asarray(carry))]


@pytest.mark.parametrize("distinct", [True, False], ids=["exact", "ties"])
@pytest.mark.parametrize("layout,cap", [("packed", 3), ("packed", 1000), ("unpacked", 5),
                                        ("unpacked", 40)])
def test_keyrow_route_equals_jax_route_cap(layout, cap, distinct):
    """route_plain on key rows (rows of 2 + W + 4 or W + 5 words, W = 3)
    under the dense allowance against JAX's _route_cap with the payload as
    its ``others``: the rows each shard receives (JAX sends (fsort,
    payload); the port's wire row is the payload, which holds what the
    receiver needs), the new ring, its overflow and its min fsort.  With
    distinct f the order is JAX's exactly; with ties (f in 0..4) JAX's
    sort is not stable, so each destination's rows and the ring compare as
    multisets."""
    ndev, L, ccar, W = 4, 120, 120, 3
    pw = W + (4 if layout == "packed" else 5)
    empty = INFP if layout == "packed" else INF
    fill = [ndev, empty] + [-1] * W + [0] * (pw - W)
    cand, carry = keyrow_route_inputs(len(layout) + cap, ndev, L, ccar, pw,
                                      1 << 20 if distinct else 5, fill, distinct)
    j_recv, j_carry, j_ovf, j_min = jax_route_rows(ndev, cap, cand, carry, tuple(fill[1:]))
    outs = [S.route_plain(torch.from_numpy(cand[i]), L, torch.from_numpy(carry[i]), ndev, i,
                          cap, fill=fill) for i in range(ndev)]
    counts = np.stack([o[2][:ndev].numpy() for o in outs])
    A = S.route_sizes(counts, ndev, cap, False)
    srt = lambda a: sorted(map(tuple, a.tolist()))
    for j in range(ndev):
        for i in range(ndev):
            blk = j_recv[j][i * cap:(i + 1) * cap]
            mine = outs[i][0][j * cap:j * cap + A[i][j]].numpy()
            assert mine.shape == (A[i][j], pw)
            got = blk[:A[i][j], 1:]  # JAX's received rows lead with fsort
            assert np.all(blk[A[i][j]:, 1:1 + W] == -1)
            if distinct:
                assert np.array_equal(got, mine)
            else:
                assert srt(got) == srt(mine)
        wire, ring, out = outs[j]
        if distinct:
            assert np.array_equal(ring.numpy(), j_carry[j])
        else:
            assert srt(ring) == srt(j_carry[j])
        assert int(out[ndev + 1]) == int(j_ovf[j])
        assert int(out[ndev + 2]) == int(j_min[j])


def test_keyrow_route_ragged_allowance():
    """The ragged allowance on key rows (XLA:CPU has no ragged all-to-all):
    a receiver takes at most ndev cap rows, its senders in rank order, and
    every sent row is a remote payload of its destination."""
    ndev, L, ccar, W, cap = 4, 200, 200, 2, 7
    pw = W + 5
    fill = [ndev, INF] + [-1] * W + [0] * (pw - W)
    cand, carry = keyrow_route_inputs(9, ndev, L, ccar, pw, 50, fill, False)
    counts = [S.route_plain(torch.from_numpy(cand[i]), L, torch.from_numpy(carry[i]), ndev, i,
                            cap, fill=fill)[2][:ndev].numpy() for i in range(ndev)]
    Sm = torch.from_numpy(np.stack(counts).astype(np.int32))
    A = S.route_sizes(np.stack(counts), ndev, cap, True)
    assert (A.sum(0) <= ndev * cap).all() and (A <= np.stack(counts)).all()
    for i in range(ndev):
        wire, ring, out = S.route_plain(torch.from_numpy(cand[i]), L,
                                        torch.from_numpy(carry[i]), ndev, i, cap, Sm, fill)
        rows = np.concatenate([cand[i], carry[i]])
        at = 0
        for j in range(ndev):
            sent = wire[at:at + A[i][j]].numpy()
            want = rows[rows[:, 0] == j]
            want = want[np.lexsort((np.arange(len(want)), want[:, 1]))][:A[i][j], 2:]
            assert np.array_equal(sent, want)
            at += A[i][j]
        assert int(out[ndev + 1]) == max(int(np.stack(counts)[i].sum()) - int(A[i].sum())
                                         - ccar, 0)


# --- the consensus's carry bound


def test_carry_bound_by_layout():
    nb, f0 = 3, 1000
    words = np.array([INFP, (7 << nb) | 5, 0])
    assert S.carry_bound("sig", words, nb, f0).tolist() == [INF, 1007, 1000]
    assert S.carry_bound("packed", words, nb, f0).tolist() == [INF, 1007, 1000]
    # unpacked rows sort by f itself: the ring's min is the bound, INF empty
    assert S.carry_bound("unpacked", np.array([INF, 24450, -3]), nb, f0).tolist() == [
        INF, 24450, -3]


def test_unpacked_spill_keeps_the_ring_min_f_in_the_bound(monkeypatch):
    """A one-row wire on the unpacked layout: migrants wait in the carry
    ring, and at some step the ring holds the lowest f of the whole
    frontier.  Each step's carry bound is the min f of the live ring rows
    (not the packed form (f >> n) + f0), and the brute-force optimum
    holds."""
    p = Problem(random_seqs(31, 4, 12, 16))
    want = optimal_cost(p, HPairHeuristic.build(p, "cpu"))
    shards, seen = [], []
    make, bound = S.ShardedFrontierSearch._shards, S.carry_bound

    def keep(self):
        shards[:] = make(self)
        return shards

    def watch(layout, ring_min, nb, f0):
        out = bound(layout, ring_min, nb, f0)
        ring_f = [int(sh.ring[sh.ring[:, 0] < len(shards), 1].min())
                  if bool((sh.ring[:, 0] < len(shards)).any()) else INF for sh in shards]
        open_f = min(int(sh.state[4]) for sh in shards)
        seen.append((out.tolist(), ring_f, open_f))
        return out

    monkeypatch.setattr(S.ShardedFrontierSearch, "_shards", keep)
    monkeypatch.setattr(S, "carry_bound", watch)
    eng = S.ShardedFrontierSearch(p, devices=["cpu"] * 4, layout="unpacked", exchange_cap=1,
                                  hash_type="FZORDER", hash_shift=0, batch=16)
    res = eng.run()
    assert res.g == want and eng.last_stats["peak_carry"] > 0
    assert all(b == r for b, r, _ in seen)
    assert any(min(r) < o for _, r, o in seen)  # the ring held the frontier's min f


# --- K10's received rows: their claim tags


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_insert_received_tags_by_place(layout):
    """insert_pending_plain: a received row claims with its place in the
    received region and a self-owned entry with the tag it carries, so the
    table does not depend on the order of the self-owned entries, and a
    race for a slot between a received row and a self-owned lane goes to
    the received row (the smaller tag), as JAX's position tags do."""
    p = golden("test2.fasta")
    eng = S.ShardedFrontierSearch(p, devices=["cpu"] * 2, layout=layout, capacity=1 << 12)
    st = eng.st
    rng = np.random.default_rng(4)
    n = 300
    coords = torch.from_numpy(rng.integers(0, 20, (n, st.n)))
    keys = S._pack_keys(coords, st.W)
    h0 = S._hash_keys(keys)
    g = torch.from_numpy(rng.integers(0, 1000, n))
    f = g + torch.from_numpy(rng.integers(0, 100, n))
    m = torch.from_numpy(rng.integers(1, st.M + 1, n))
    tag = 10_000 + torch.from_numpy(rng.permutation(n))
    if layout == "packed":
        tail = [f - g, ((f - st.f0).clamp(min=0) << st.nb) | m]
    else:
        fpar = f * (1 << st.nb) + m
        tail = [g, S._as_i32(fpar & 0xFFFFFFFF).long(), fpar >> 32]
    rows = torch.cat([S._as_i32(keys).long(), torch.stack([S._as_i32(h0).long(), tag, *tail], 1)],
                     1).to(torch.int32)
    n_front = 40
    tables = []
    for perm in (torch.arange(n - n_front), torch.from_numpy(rng.permutation(n - n_front))):
        tab = S._shard_table(st, layout, eng.h_root, False)
        order = torch.cat([torch.arange(n_front), n_front + perm])
        out = S.insert_pending_plain(st, tab, layout, rows[order], n_front)
        assert out[0] == 0 and out[2] >= 1
        tables.append(tab)
    for name in tables[0].__dataclass_fields__:
        if name != "claim":
            assert torch.equal(getattr(tables[0], name)[:st.C], getattr(tables[1], name)[:st.C])
    # two keys of one home slot, a received row and a self-owned entry: the
    # received row (tag 0) wins the slot, the other key takes probe slot 1
    home = h0 & (st.C - 1)
    i, j = next((i, j) for i in range(n) for j in range(i + 1, n)
                if int(home[i]) == int(home[j]) and not torch.equal(keys[i], keys[j]))
    tab = S._shard_table(st, layout, eng.h_root, False)
    S.insert_pending_plain(st, tab, layout, rows[[j, i]], 1)
    slot0 = int(home[j])
    slot1 = int(S._probe_slot(h0[i], 1, st.C - 1))
    assert torch.equal(tab.t_key[slot0, :st.W], S._as_i32(keys[j]))
    assert torch.equal(tab.t_key[slot1, :st.W], S._as_i32(keys[i]))


# --- the new C entries' arguments


def test_keyrow_sharded_launch_arguments_match_signatures():
    """The sharded key-row wrappers' C arguments (K9s, K10 on received rows,
    K7h, keyrow_coords) have their entries' arity, and K9s differs from K9
    only in the entry, the cubes (none where h3 stands in), its launch
    shape (k9s_launch_shape), the pending rows' offset and its own
    arguments, its rows a block last, before the stream."""
    for layout in ("packed", "unpacked"):
        eng = S.ShardedFrontierSearch(golden("test2.fasta"), devices=["cpu"] * 2,
                                      layout=layout, capacity=1 << 12)
        st = eng.st
        tab = S._shard_table(st, layout, eng.h_root, True)
        bufs = TS.StepBuffers.for_step(st, torch.device("cpu"), layout)
        pw = S.pend_words(st, layout)
        base = TS._keyrow_expand_args(st, tab, bufs, bufs.counters, eng.ub, "stream")
        extra = (11, 12, 2 + pw, *eng.hash_params, eng.ndev, 1, 77)
        shd = TS._keyrow_expand_args(st, tab, bufs, bufs.counters, eng.ub, "stream",
                                     entry="keyrow_expand_sharded", cubes=False, pend_at=5,
                                     sharded=extra)
        assert len(base) - 1 == len(_kernels.SIGNATURES["keyrow_expand"])
        assert len(shd) - 1 == len(_kernels.SIGNATURES["keyrow_expand_sharded"])
        assert shd[0] == "keyrow_expand_sharded" and shd[-1] == base[-1] == "stream"
        assert shd[10] is None and (base[10] is not None) == bool(st.T3)
        assert shd[28] == bufs.pend.data_ptr() + 4 * pw * 5
        blocks, threads, rows = TS.k9s_launch_shape(st.B, st.M)
        assert shd[23:25] == (blocks, threads) and rows == (TS.K9S_ROWS if st.M <= 31 else 0)
        assert shd[29:-1] == (*extra, rows) and shd[1:10] == base[1:10]
        assert shd[11:23] == base[11:23] and shd[25:28] == base[25:28]
        recv = torch.zeros(1, dtype=torch.int32)
        ins = TS._keyrow_insert_args(st, tab, bufs, bufs.counters, 64, 0, TS.K10_CAP, "s",
                                     pend_at=3, recv=recv)
        assert ins[0] == "keyrow_insert_recv"
        assert len(ins) - 1 == len(_kernels.SIGNATURES["keyrow_insert_recv"])
        # the received count is read on the card, at the list's start
        assert ins[11] == bufs.pend.data_ptr() + 4 * pw * 3 and ins[-2] == recv.data_ptr()
        plain = TS._keyrow_insert_args(st, tab, bufs, bufs.counters, 64, 0, TS.K10_CAP, "s")
        assert plain[0] == "keyrow_insert" and plain[11] == bufs.pend.data_ptr()
        assert ins[1:11] == plain[1:11] and ins[12:-2] == plain[12:-1]
    # the hop mode takes the walk loop's run flag beside path_walk's arguments
    assert len(_kernels.SIGNATURES["path_walk_hops"]) == len(_kernels.SIGNATURES["path_walk"]) + 1
    assert len(_kernels.SIGNATURES["route_count_rows"]) == len(
        _kernels.SIGNATURES["route_count"]) + 3
    assert len(_kernels.SIGNATURES["route_pack_rows"]) == len(
        _kernels.SIGNATURES["route_pack"]) + 3
    assert _kernels.SOURCES["keyrow_coords"] == "tri_partial"
