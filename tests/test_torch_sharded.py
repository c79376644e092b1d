"""The port's sharded engine (mpi_pastar_msa_tpu_torch/parallel/sharded.py)
on the CPU: the plain route (K11's plain version) against JAX's
``_route_cap`` under ``jax.shard_map`` on 4 of conftest's 8 CPU devices and
its ragged allowance against a NumPy transcription of ``_route_ragged``
(XLA:CPU has no ragged all-to-all); the plain tri-partial (K12's) against
JAX's ``_make_tri_partial`` on the same cubes; NumPy emulations of K11's
two passes and of K7's hop-limited mode against their plain versions; the
engine on 2 and 4 CPU shards (golden g and alignment on PF08184 and test2,
the brute-force optimum on random inputs, the four owner hashes, a one-row
wire, sharded cubes on and off, one shard against FrontierSearch, the
fractional cover) and its refusals."""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mpi_pastar_msa_tpu.core.problem import Problem as JProblem
from mpi_pastar_msa_tpu.heuristic.hpair import HPairHeuristic as JHPair
from mpi_pastar_msa_tpu.heuristic.triples import HTriples as JTriples
from mpi_pastar_msa_tpu.parallel import sharded as JS
from mpi_pastar_msa_tpu.search.engine import _Static as JStatic
from mpi_pastar_msa_tpu_torch import _kernels
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.heuristic.triples import HTriples
from mpi_pastar_msa_tpu_torch.parallel import sharded as S
from mpi_pastar_msa_tpu_torch.parallel.mesh import LocalMesh
from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
from mpi_pastar_msa_tpu_torch.search.bruteforce import optimal_cost
from mpi_pastar_msa_tpu_torch.search.engine import INF, INFP, FrontierSearch, _sig_encode

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))
AMINO = "ACDEFGHIKLMNPQRSTVWY"


def golden(name):
    return Problem(tuple(r.replace("-", "") for r in GOLD[name]["alignment"]))


# --- K11: the plain route against JAX's


def route_inputs(seed, ndev, L, ccar, f_range, remote_p=0.7):
    """Per shard: candidate rows (dest, fsort, home, sig) with dest = ndev
    for a lane that stays, and a carry ring whose first rows are live."""
    rng = np.random.default_rng(seed)
    cand = np.zeros((ndev, L, 4), np.int32)
    carry = np.zeros((ndev, ccar, 4), np.int32)
    for me in range(ndev):
        dest = rng.integers(0, ndev, L)
        dest[(dest == me) | (rng.random(L) > remote_p)] = ndev
        cand[me, :, 0] = dest
        cand[me, :, 1] = rng.integers(0, f_range, L)
        cand[me, :, 2] = rng.integers(0, 1 << 20, L)
        cand[me, :, 3] = rng.integers(0, 1 << 30, L)
        live = rng.integers(0, ccar // 2)
        carry[me] = [ndev, INFP, 0, -1]
        carry[me, :live, 0] = rng.integers(0, ndev, live)
        carry[me, :live, 1] = rng.integers(0, f_range, live)
        carry[me, :live, 2] = rng.integers(0, 1 << 20, live)
        carry[me, :live, 3] = rng.integers(0, 1 << 30, live)
    return cand, carry


def jax_route(ndev, cap, cand, carry):
    """JAX _route_cap under shard_map over ndev CPU devices: per shard
    (received (ndev cap, 3) [fsort, home, sig], new carry, overflow, carried
    min)."""
    mesh = Mesh(np.array(jax.devices("cpu")[:ndev]), (JS.AXIS,))

    def body(c, car):
        c, car = c[0], car[0]
        recv, nc, covf, cfm = JS._route_cap(ndev, cap, c[:, 0], c[:, 1], (c[:, 2], c[:, 3]),
                                            car, fills=(INFP, 0, -1))
        return jnp.stack(recv, 1)[None], nc[None], covf[None], cfm[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(JS.AXIS), P(JS.AXIS)),
                               out_specs=(P(JS.AXIS),) * 4, check_vma=False))
    return [np.asarray(x) for x in fn(jnp.asarray(cand), jnp.asarray(carry))]


def port_route(ndev, cap, cand, carry, ragged=False):
    """route_plain on every shard, then the dense exchange as the engine
    runs it: shard j's rows from shard i are i's wire rows j cap ..
    j cap + A[i][j] (ragged: the A[i][j] rows at i's offset for j)."""
    outs = [S.route_plain(torch.from_numpy(cand[i]), cand.shape[1],
                          torch.from_numpy(carry[i]), ndev, i, cap) for i in range(ndev)]
    counts = np.stack([o[2][:ndev].numpy() for o in outs])
    if ragged:
        Sm = torch.from_numpy(counts.astype(np.int32))
        outs = [S.route_plain(torch.from_numpy(cand[i]), cand.shape[1],
                              torch.from_numpy(carry[i]), ndev, i, cap, Sm)
                for i in range(ndev)]
    A = S.route_sizes(counts, ndev, cap, ragged)
    off = np.cumsum(A, axis=1) - A if ragged else np.tile(np.arange(ndev) * cap, (ndev, 1))
    recv = [[outs[i][0][off[i][j]:off[i][j] + A[i][j]].numpy() for i in range(ndev)]
            for j in range(ndev)]
    return outs, A, recv


@pytest.mark.parametrize("seed,cap", [(1, 3), (2, 40), (3, 1000)])
def test_route_equals_jax_route_cap(seed, cap):
    ndev, L, ccar = 4, 160, 160
    # distinct f values: no tie anywhere, so the order is JAX's exactly
    cand, carry = route_inputs(seed, ndev, L, ccar, 1 << 20)
    rng = np.random.default_rng(seed + 50)
    f = rng.permutation(1 << 20)[: ndev * (L + ccar)].reshape(ndev, L + ccar)
    cand[:, :, 1] = f[:, :L]
    live = carry[:, :, 0] < ndev
    carry[:, :, 1] = np.where(live, f[:, L:], INFP)
    j_recv, j_carry, j_ovf, j_min = jax_route(ndev, cap, cand, carry)
    outs, A, recv = port_route(ndev, cap, cand, carry)
    for j in range(ndev):
        for i in range(ndev):
            blk = j_recv[j][i * cap:(i + 1) * cap]
            n = int((blk[:, 2] != -1).sum())
            assert n == A[i][j]
            assert np.array_equal(blk[:n], recv[j][i][:, [2, 0, 1]])  # port rows: home, sig, f
        wire, ring, out = outs[j]
        assert np.array_equal(ring.numpy(), j_carry[j])
        assert int(out[ndev + 1]) == int(j_ovf[j])
        assert int(out[ndev + 2]) == int(j_min[j])
        assert int(out[ndev]) == int((cand[j, :, 0] < ndev).sum())


def test_route_ties_equal_jax_as_multisets():
    ndev, L, ccar, cap = 4, 200, 200, 6
    cand, carry = route_inputs(7, ndev, L, ccar, 5)  # f in 0..4: ties at every cap
    j_recv, j_carry, j_ovf, j_min = jax_route(ndev, cap, cand, carry)
    outs, A, recv = port_route(ndev, cap, cand, carry)
    for j in range(ndev):
        for i in range(ndev):
            blk = j_recv[j][i * cap:(i + 1) * cap]
            n = int((blk[:, 2] != -1).sum())
            assert n == A[i][j]
            # equal f: which rows ride is unspecified in JAX, their f is not
            assert sorted(blk[:n, 0]) == sorted(recv[j][i][:, 2])
        ring = outs[j][1].numpy()
        for d in range(ndev + 1):
            assert sorted(ring[ring[:, 0] == d, 1]) == sorted(j_carry[j][j_carry[j][:, 0] == d, 1])
        assert int(outs[j][2][ndev + 1]) == int(j_ovf[j])
        assert int(outs[j][2][ndev + 2]) == int(j_min[j])


def test_route_carry_overflow_and_empty():
    ndev, L, ccar, cap = 2, 64, 8, 1
    cand, carry = route_inputs(9, ndev, L, ccar, 1 << 10, remote_p=1.0)
    j_recv, j_carry, j_ovf, j_min = jax_route(ndev, cap, cand, carry)
    outs, _, _ = port_route(ndev, cap, cand, carry)
    for j in range(ndev):
        assert int(outs[j][2][ndev + 1]) == int(j_ovf[j]) > 0
    empty = np.zeros((1, 16, 4), np.int32)
    empty[0, :, 0] = 1
    ring = np.tile(np.array([1, INFP, 0, -1], np.int32), (1, 4, 1))
    wire, new, out = S.route_plain(torch.from_numpy(empty[0]), 16, torch.from_numpy(ring[0]),
                                   1, 0, 8)
    assert out.tolist() == [0, 0, 0, INFP] and torch.equal(new, torch.from_numpy(ring[0]))


@pytest.mark.parametrize("seed,cap", [(11, 2), (12, 30), (13, 500)])
def test_route_ragged_allowance_equals_numpy(seed, cap):
    """_route_ragged :213-224 in NumPy: S[i, j] rows i -> j, before =
    exclusive prefix over senders, A = clip(ndev cap - before, 0, S); a
    sender's segment for j starts at the exclusive prefix of its row of A,
    a receiver's rows from i at the exclusive prefix of its column."""
    ndev, L, ccar = 4, 300, 100
    cand, carry = route_inputs(seed, ndev, L, ccar, 1 << 20)
    outs, A, recv = port_route(ndev, cap, cand, carry, ragged=True)
    Sm = np.stack([o[2][:ndev].numpy() for o in outs]).astype(np.int64)
    before = np.cumsum(Sm, axis=0) - Sm
    want = np.clip(ndev * cap - before, 0, Sm)
    assert np.array_equal(A, want)
    for me in range(ndev):
        send_t = want[me]
        recv_sizes = want[:, me]
        assert sum(len(r) for r in recv[me]) == recv_sizes.sum() <= ndev * cap
        # the rows sent to each j are the best send_t[j] of me's remote rows to j
        rows = np.concatenate([cand[me], carry[me]])
        for j in range(ndev):
            mine = rows[rows[:, 0] == j]
            best = sorted(mine[:, 1])[: send_t[j]]
            assert sorted(recv[j][me][:, 2]) == best
        wire, ring, out = outs[me]
        spilled = (Sm[me] - send_t).sum()
        assert int(out[ndev + 1]) == max(spilled - ccar, 0)
        assert int((ring[:, 0] < ndev).sum()) == min(spilled, ccar)


PAD = np.uint64(2**64 - 1)  # route_pack.cu's padding key


def emulate_count(rows, n_lanes, ndev, seg_len, rng, tally=None, p=0):
    """route_count in NumPy over ``rows`` (the lanes, then the carry ring's
    live rows only): a warp takes 32 consecutive rows, the warps (and a
    warp's destination groups) in an arbitrary order, the kernel's
    atomics; the lanes of a warp with one destination (__match_any_sync)
    take one atomicAdd for the group and rank themselves by lane.  The
    counts and migrants go into ``tally[p]`` (ndev + 1 words, zero before;
    a new pair when None), whose other row block 0 zeroes.  Returns
    (tally[p], per destination its segment of keys fsort << 32 |
    position)."""
    n = len(rows)
    if tally is None:
        tally = np.zeros((2, ndev + 1), np.int64)
    assert not tally[p].any()
    tally[1 - p] = 0
    out = tally[p]
    seg = np.zeros((ndev, seg_len), np.uint64)
    for w in rng.permutation(-(-n // 32)):
        r = w * 32 + np.arange(32)
        d = np.where(r < n, rows[np.minimum(r, n - 1), 0], -1)
        remote = (d >= 0) & (d < ndev)
        out[ndev] += int((remote & (r < n_lanes)).sum())  # one atomic a block
        for dd in rng.permutation(np.unique(d[remote])):
            peers = r[d == dd]  # lane order
            at = out[dd]
            out[dd] += len(peers)  # the leader's atomicAdd
            f = ((rows[peers, 1] & 0xFFFFFFFF) ^ 0x80000000).astype(np.uint64)
            seg[dd, at:at + len(peers)] = f << np.uint64(32) | peers.astype(np.uint64)
    return out, seg


def k11_constants():
    """route_pack.cu's constants of its sort, read from the source: kKeys
    (a thread's group of keys), kPackThreads (a sorting block's most
    threads) and kShKeys (the keys a block sorts between two shared
    buffers)."""
    with open(os.path.join(_kernels.CSRC, "route_pack.cu")) as f:
        src = f.read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kKeys", "kPackThreads", "kShKeys")}


K11 = k11_constants()


def emulate_merge(x, a, b, w, o, keys):
    """merge_group: outputs o .. o + keys of the merge of the sorted runs
    x[a:a + w] and x[b:b + w] (Python ints): a lower bound along the merge
    path, then a serial merge in which a key of the first run goes first
    only when smaller and every step loads the next key of its run."""
    lo = max(0, o - w)
    span = min(o, w) - lo
    while span > 0:
        half = span // 2
        if x[a + lo + half] < x[b + o - 1 - lo - half]:
            lo, span = lo + half + 1, span - half - 1
        else:
            span = half
    ia, ib = lo, o - lo
    ka, kb = x[a + min(ia, w - 1)], x[b + min(ib, w - 1)]
    v = []
    for _ in range(keys):
        from_a = ib >= w or (ia < w and ka < kb)
        v.append(ka if from_a else kb)
        if from_a:
            ia += 1
            ka = x[a + min(ia, w - 1)]
        else:
            ib += 1
            kb = x[b + min(ib, w - 1)]
    return v


def emulate_warp_sort(run, keys):
    """sort_warp: a warp's 32 groups of ``keys`` keys (lane l holds keys l
    keys .. l keys + keys - 1 of ``run``) sorted by its bitonic network as
    the kernel indexes it: every merge of runs of k / 2 keys first pairs
    key i of lane l with key keys - 1 - i of lane l ^ (k / keys - 1) (its
    mirror; within the lane while k <= keys), then with the key j apart
    (a register while j < keys, lane l ^ (j / keys) beyond), the lower
    lane or register taking the smaller key."""
    v = np.array([int(k) for k in run], dtype=np.uint64).reshape(32, keys)
    lane = np.arange(32)[:, None]
    k = 2
    while k <= 32 * keys:
        if k <= keys:
            for i in range(keys):
                l = i ^ (k - 1)
                if l > i:
                    lo, hi = np.minimum(v[:, i], v[:, l]), np.maximum(v[:, i], v[:, l])
                    v[:, i], v[:, l] = lo, hi
        else:
            p = v[np.arange(32) ^ (k // keys - 1)][:, ::-1]  # key keys - 1 - i of the partner
            lower = (lane & (k // (2 * keys))) == 0
            v = np.where(lower, np.minimum(v, p), np.maximum(v, p))
        j = k // 4
        while j > 0:
            if j < keys:
                for i in range(keys):
                    if i & j == 0:
                        lo = np.minimum(v[:, i], v[:, i | j])
                        v[:, i | j] = np.maximum(v[:, i], v[:, i | j])
                        v[:, i] = lo
            else:
                p = v[np.arange(32) ^ (j // keys)]
                lower = (lane & (j // keys)) == 0
                v = np.where(lower, np.minimum(v, p), np.maximum(v, p))
            j //= 2
        k *= 2
    return [int(x) for x in v.reshape(-1)]


def emulate_sort(seg, n, keys, threads, shared_keys, rng, pbits=None):
    """route_pack's sort of a segment of n keys, padded to np2 on nt =
    np2 / keys threads (at least a warp, at most ``threads``); a block
    barrier is a named barrier over the nt threads, a warp's own sync when
    nt is one warp.  sort_segment: each warp's 32 groups of ``keys`` (a
    run of 32 keys keys, a segment of fewer groups padded) sorted by its
    network (emulate_warp_sort), then rounds that merge runs of w = 32
    keys, 64 keys, ... pairwise from one buffer into the other
    (emulate_merge), a block barrier before each round and one at the
    end.  Up to ``threads`` groups (sort_small, a group a thread) a block
    barrier first joins the least and the largest fsort, and with
    ``pbits`` (log2 of the key segment) the keys sort as ((fsort - least)
    << pbits) | position when those fit 32 bits below the padding
    0xFFFFFFFF ("narrow").  At np2 = 2 ``shared_keys`` (sort_halves) each
    half sorts so, the first stored back in place while the second sorts,
    and the last round merges the halves, with a block barrier after the
    first half's store, after its reload and after the merge.  Groups run
    in an arbitrary order.  Returns (sorted keys, block barriers, where:
    "narrow", "shared", "halves" or "device")."""
    np2 = max(keys, 1 << max(n - 1, 0).bit_length())
    nt = min(threads, max(32, np2 // keys))
    block = nt > 32
    run = 32 * keys

    def sort_segment(src, m, size, pad=int(PAD)):
        x = [int(k) for k in src[:m]] + [pad] * (size - m)
        for g0 in rng.permutation(-(-size // run)) * run:
            part = x[g0:g0 + run]
            x[g0:g0 + run] = emulate_warp_sort(part + [pad] * (run - len(part)),
                                               keys)[:len(part)]
        barriers, w = 0, run
        while w < size:
            barriers += block
            y = [None] * size
            for g in rng.permutation(size // keys):
                at = int(g) * keys
                pair = at & ~(2 * w - 1)
                y[at:at + keys] = emulate_merge(x, pair, pair + w, w, at - pair, keys)
            x, w = y, 2 * w
        return x, barriers + block

    if np2 <= threads * keys:  # sort_small: the fsort range's barrier first
        real = [int(k) for k in seg[:n]]
        least, most = min(k >> 32 for k in real), max(k >> 32 for k in real)
        if pbits is not None and ((most - least) << pbits) + (1 << pbits) <= 0xFFFFFFFF:
            narrow = [((k >> 32) - least) << pbits | (k & ((1 << pbits) - 1)) for k in real]
            back = dict(zip(narrow, real))
            x, barriers = sort_segment(narrow, n, np2, 0xFFFFFFFF)
            return [back[k] for k in x[:n]], barriers + block, "narrow"
        x, barriers = sort_segment(seg, n, np2)
        return x[:n], barriers + block, "shared"
    if np2 != 2 * shared_keys:
        x, barriers = sort_segment(seg, n, np2)
        return x[:n], barriers, "shared" if np2 <= shared_keys else "device"
    x0, b0 = sort_segment(seg, shared_keys, shared_keys)
    x1, b1 = sort_segment(seg[shared_keys:], n - shared_keys, shared_keys)
    x, y = x0 + x1, [None] * np2
    for g in rng.permutation(np2 // keys):
        at = int(g) * keys
        y[at:at + keys] = emulate_merge(x, 0, shared_keys, shared_keys, at, keys)
    return y[:n], b0 + b1 + 3 * block, "halves"


def emulate_allowance(out, Sm, ndev, me, cap):
    """allowance(): a warp's lanes over the destinations 32 at a time, with
    a scan of the spills and allowances: per destination (allow, wire base,
    spilled before it), and the rows spilled in all."""
    cnt = out[:ndev].astype(np.int64)
    if Sm is None:
        allow = np.full(ndev, cap, np.int64)
    else:
        allow = np.clip(ndev * cap - Sm[:me].astype(np.int64).sum(0), 0, cnt)
    over = np.maximum(cnt - allow, 0)
    base = np.cumsum(allow) - allow if Sm is not None else np.arange(ndev) * cap
    return allow, base, np.cumsum(over) - over, int(over.sum())


def emulate_route(cand, n_lanes, carry, ndev, me, cap, Sm, seed, keys=K11["kKeys"],
                  threads=K11["kPackThreads"], shared_keys=K11["kShKeys"], carry_len=None,
                  ring=None, ring_len=None, fill=None, tally=None, p=0):
    """csrc/route_pack.cu's two passes in NumPy on sig rows or (``fill``,
    the empty row) key rows: emulate_count over the lanes and the carry's
    first ``carry_len`` rows (default all), into ``tally[p]``; then block
    d sorts its segment (emulate_sort) and copies its rows by position,
    the first allow to the wire and the rest to the ring from its spill
    offset, its first spilled row taking the ring's min; block ndev copies
    the counts into out, sets the overflow, and writes the empty row over
    [len_new, len_old) of the ring buffer (``ring``, its word
    ``ring_len``; by default a buffer of unknown contents, its word its
    length) and then len_new there.  Returns (wire, ring, out, len_new,
    per destination its sort's block barriers and where it sorted)."""
    rng = np.random.default_rng(seed)
    ccar, width = carry.shape
    live = ccar if carry_len is None else carry_len
    rows = np.concatenate([cand[:n_lanes], carry[:live]]).astype(np.int64)
    empty = [ndev, INFP, 0, -1] if fill is None else list(fill)
    counts, seg = emulate_count(rows, n_lanes, ndev, len(rows), rng, tally, p)
    pbits = max(1, (len(cand) + ccar - 1).bit_length())  # the kernel's key segment's
    allow, base, before, spilled = emulate_allowance(counts, Sm, ndev, me, cap)
    cols = [2, 3, 1] if fill is None else list(range(2, width))
    wire = np.zeros((max(ndev * cap, len(cand) + ccar), len(cols)), np.int64)
    if ring is None:  # unknown contents
        ring = np.full((ccar, width), -7, np.int64)
        ring_len = ccar
    ring = ring.astype(np.int64).copy()
    kept = min(spilled, ccar)
    out = np.concatenate([counts, [max(spilled - ccar, 0), empty[1]]]).astype(np.int64)
    ring[kept:max(kept, ring_len)] = empty  # the tail's block
    sorts = {}
    for d in rng.permutation(ndev):
        n = int(counts[d])
        if n == 0:
            sorts[d] = (0, None)
            continue
        ordered, nb, where = emulate_sort(seg[d], n, keys, threads, shared_keys, rng, pbits)
        sorts[d] = (nb, where)
        for i, key in enumerate(ordered):
            v = rows[int(key) & 0xFFFFFFFF]
            if i < allow[d]:
                wire[base[d] + i] = v[cols]
            elif before[d] + i - allow[d] < ccar:
                ring[before[d] + i - allow[d]] = [d, *v[1:]]
                if i == allow[d]:
                    out[ndev + 2] = min(out[ndev + 2], v[1])
    return wire, ring, out, kept, sorts


@pytest.mark.parametrize("seed,cap,ragged,f_range", [
    (21, 3, False, 1 << 20), (22, 50, False, 8), (23, 3, True, 1 << 20),
    (24, 20, True, 4), (25, 1, False, 2)])
def test_k11_emulation_equals_plain(seed, cap, ragged, f_range):
    ndev, L, ccar = 3, 240, 120
    cand, carry = route_inputs(seed, ndev, L, ccar, f_range)
    n_lanes = L - 17  # the lanes of the listed rows only
    Sm = None
    if ragged:
        Sm = np.stack([S.route_plain(torch.from_numpy(cand[i]), n_lanes,
                                     torch.from_numpy(carry[i]), ndev, i, cap)[2][:ndev].numpy()
                       for i in range(ndev)])
    for me in range(ndev):
        w, r, o = S.route_plain(torch.from_numpy(cand[me]), n_lanes, torch.from_numpy(carry[me]),
                                ndev, me, cap, None if Sm is None else torch.from_numpy(Sm))
        ew, er, eo, _, _ = emulate_route(cand[me], n_lanes, carry[me], ndev, me, cap, Sm,
                                         seed + me)
        A = S.route_sizes(Sm if ragged else np.tile(o[:ndev].numpy(), (ndev, 1)), ndev, cap,
                          ragged)[me]
        base = np.cumsum(A) - A if ragged else np.arange(ndev) * cap
        sent = np.concatenate([np.arange(b, b + a) for a, b in zip(A, base)]).astype(int)
        assert np.array_equal(o.numpy(), eo)
        assert np.array_equal(r.numpy(), er)
        assert np.array_equal(w.numpy()[sent], ew[sent])


def _schedule_route(keys, threads, shared_keys, L, ndev, ragged, seed):
    """emulate_route at the given group size, threads and shared keys
    against route_plain on every shard of route_inputs(seed) with ties in
    f: the same out, ring and wire rows sent.  Returns each shard's
    segments' (size, block barriers, where sorted)."""
    ccar, cap = L // 2, 50
    cand, carry = route_inputs(seed, ndev, L, ccar, 1 << 12)
    n_lanes = L - 5
    Sm = None
    if ragged:
        Sm = np.stack([S.route_plain(torch.from_numpy(cand[i]), n_lanes,
                                     torch.from_numpy(carry[i]), ndev, i, cap)[2][:ndev].numpy()
                       for i in range(ndev)])
    shapes = []
    for me in range(ndev):
        w, r, o = S.route_plain(torch.from_numpy(cand[me]), n_lanes, torch.from_numpy(carry[me]),
                                ndev, me, cap, None if Sm is None else torch.from_numpy(Sm))
        ew, er, eo, _, sorts = emulate_route(cand[me], n_lanes, carry[me], ndev, me, cap, Sm,
                                             60 + me, keys=keys, threads=threads,
                                             shared_keys=shared_keys)
        assert np.array_equal(o.numpy(), eo) and np.array_equal(r.numpy(), er)
        A = S.route_sizes(Sm if ragged else np.tile(o[:ndev].numpy(), (ndev, 1)), ndev, cap,
                          ragged)[me]
        base = np.cumsum(A) - A if ragged else np.arange(ndev) * cap
        sent = np.concatenate([np.arange(b, b + a) for a, b in zip(A, base)]).astype(int)
        assert np.array_equal(w.numpy()[sent], ew[sent])
        shapes += [(int(o[d]), *sorts[d]) for d in range(ndev)]
    return shapes


@pytest.mark.parametrize("keys,threads,L,ndev,ragged", [
    # about 700 rows a destination: 7 rounds, 2 of them past a warp's runs
    (8, 512, 2000, 2, False), (8, 512, 2000, 2, True),
    # groups of 2 keys on 64 threads: each thread loops over several groups
    (2, 64, 1500, 3, False),
    # groups of 4 keys on one warp
    (4, 32, 900, 2, True)])
def test_k11_schedules_equal_plain(keys, threads, L, ndev, ragged):
    """The emulation at the kernel's group size and at smaller ones, so that
    small inputs reach many rounds, in two shared buffers: the same route
    as the plain version; rounds past a warp's runs (a segment above 64
    groups) take block barriers, unless one warp sorts."""
    shapes = _schedule_route(keys, threads, 1 << 20, L, ndev, ragged, 40 + keys)
    big = [(n, nb) for n, nb, where in shapes if n > 2 * 32 * keys]
    assert big and all(where in ("narrow", "shared", None) for _, _, where in shapes)
    assert all((nb > 0) == (threads > 32) for _, nb in big)


@pytest.mark.parametrize("ragged", [False, True])
def test_k11_halves_schedule_equals_plain(ragged):
    """sort_halves, emulated at groups of 2 keys on 64 threads with two
    shared buffers of 256 keys: segments of 257 to 512 keys sort as two
    halves and a last merge, and route as the plain version."""
    shapes = _schedule_route(2, 64, 256, 1500, 3, ragged, 42)
    assert {where for n, _, where in shapes if 256 < n <= 512} == {"halves"}


def live_ring_rows(rng, dest, ndev, fill, f_lo):
    """Rows (dest, fsort, payload) for ``dest``: a remote row's fsort from
    f_lo up with ties, random payload words (sig: home, sig); every other
    row the empty one (``fill``, or sig's)."""
    empty = [ndev, INFP, 0, -1] if fill is None else list(fill)
    rows = np.tile(np.array(empty, np.int64), (len(dest), 1))
    live = dest < ndev
    k = int(live.sum())
    rows[:, 0] = dest
    rows[live, 1] = rng.integers(f_lo, f_lo + 400, k)
    if fill is None:
        rows[live, 2] = rng.integers(0, 1 << 20, k)
        rows[live, 3] = rng.integers(0, 1 << 30, k)
    else:
        rows[live, 2:] = rng.integers(-2**31, 2**31 - 1, (k, len(empty) - 2))
    return rows.astype(np.int32)


# the rows each step of test_k11_live_rings_equal_plain spills: none, many
# (cap 1), a few (a cap two rows short of the largest destination's), none,
# many
LIVE_RING_SPILLS = ("none", "many", "few", "none", "many")


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_k11_live_rings_equal_plain(layout, ragged):
    """Steps of one shard on its two ring buffers in turns, as the engine
    runs them: each step new lanes and the ring the last step wrote (the
    carry), spilling none, many, a few, none and many rows
    (LIVE_RING_SPILLS).  The emulated route (emulate_route: the count over
    the lanes and only the carry's live rows, by its word; the counts in
    the two count buffers in turns; the pack writing the spilled rows and
    the empty row over only [len_new, len_old) of the buffer, whose word
    was left by the step two before, then len_new) against route_plain on
    the lanes and the whole carry ring: out, every word of the new ring,
    the new word (the plain ring's live rows) and the rows sent.  Sig rows
    and key rows of kinase's packed and unpacked widths (W = 3; unpacked f
    negative too)."""
    ndev, me, L, ccar, W = 3, 1, 400, 300, 3
    fill = None
    if layout != "sig":
        pw = W + (4 if layout == "packed" else 5)
        fill = [ndev, INFP if layout == "packed" else INF] + [-1] * W + [0] * (pw - W)
    empty = [ndev, INFP, 0, -1] if fill is None else fill
    rng = np.random.default_rng(len(layout) + ragged)
    rings = [np.tile(np.array(empty, np.int32), (ccar, 1)) for _ in range(2)]
    words = [0, 0]
    tally = np.zeros((2, ndev + 1), np.int64)
    f_lo = -100 if layout == "unpacked" else 0
    kept = []
    for t, spill in enumerate(LIVE_RING_SPILLS):
        a, b = t % 2, 1 - t % 2
        dest = rng.integers(0, ndev, L)
        dest[(dest == me) | (rng.random(L) < 0.2)] = ndev
        cand = live_ring_rows(rng, dest, ndev, fill, f_lo)
        n_lanes = L - 7
        tc, ta = torch.from_numpy(cand), torch.from_numpy(rings[a])
        # the remote rows to each destination, then the cap that spills so
        n_d = S.route_plain(tc, n_lanes, ta, ndev, me, 1, fill=fill)[2][:ndev].numpy()
        Sm = None
        if ragged:  # the other shards send as this one: allow = ndev cap - me n_d
            Sm = np.tile(n_d, (ndev, 1)).astype(np.int32)
            cap = {"none": L + ccar, "many": 1,
                   "few": max(1, ((me + 1) * int(n_d.max()) - 2) // ndev)}[spill]
        else:
            cap = {"none": L + ccar, "many": 1, "few": max(1, int(n_d.max()) - 2)}[spill]
        w_p, r_p, o_p = S.route_plain(tc, n_lanes, ta, ndev, me, cap,
                                      None if Sm is None else torch.from_numpy(Sm), fill)
        ew, er, eo, new_len, _ = emulate_route(
            cand, n_lanes, rings[a], ndev, me, cap, Sm, 100 + t, carry_len=words[a],
            ring=rings[b], ring_len=words[b], fill=fill, tally=tally, p=t % 2)
        live = int((r_p[:, 0] < ndev).sum())
        assert np.array_equal(eo, o_p.numpy()), (t, eo, o_p)
        assert np.array_equal(er, r_p.numpy()), t
        assert new_len == live, (t, new_len, live)
        A = S.route_sizes(Sm if ragged else np.tile(o_p[:ndev].numpy(), (ndev, 1)), ndev, cap,
                          ragged)[me]
        base = np.cumsum(A) - A if ragged else np.arange(ndev) * cap
        sent = np.concatenate([np.arange(x, x + y) for y, x in zip(A, base)]).astype(int)
        assert np.array_equal(ew[sent], w_p.numpy()[sent]), t
        assert np.array_equal(tally[t % 2], o_p.numpy()[:ndev + 1]) and not tally[1 - t % 2].any()
        rings[b], words[b] = er.astype(np.int32), new_len
        kept.append(live)
    # the ring grew, shrank to a few rows, emptied and grew again
    assert kept[0] == kept[3] == 0 and kept[1] > kept[2] > 0 and kept[4] > 0, kept


# (segment size, block barriers, where it sorts) of route_pack's sort at
# route_pack.cu's constants; tests/test_torch_cuda.py::K11_BARRIERS holds
# the kernel's K11_BARRIERS build to the same counts on the card
K11_SHAPES = [(1, 0, "shared"), (256, 0, "shared"), (257, 3, "shared"), (636, 4, "shared"),
              (1024, 4, "shared"), (1456, 5, "shared"), (4096, 6, "shared"),
              (4097, 6, "shared"), (8192, 6, "shared"), (8193, 15, "halves"),
              (16384, 15, "halves"), (16385, 8, "device"), (31744, 8, "device")]


def test_k11_sort_shape():
    """route_pack's sort at route_pack.cu's constants, emulated on random
    keys: up to a warp's 256 keys on one warp with no block barrier; 1,024
    keys with 4 (the fsort range's, two merge rounds', the end's; the block
    bitonic of commit c408a21: 55 stages); a group a thread up to 4,096
    keys, two shared buffers up to 8,192, the halves up to 16,384, device
    memory above; the keys come out sorted, and so they do on 32-bit keys
    where the range fits.  The card tests' K11_BARRIERS, which the
    kernel's K11_BARRIERS build must execute, are the emulation's."""
    from test_torch_cuda import K11_BARRIERS, K11_CASES

    assert K11 == dict(kKeys=8, kPackThreads=512, kShKeys=8192)
    rng = np.random.default_rng(5)
    shapes = {}

    def shape(n):
        if n not in shapes:
            f = rng.integers(0, 1 << 10, n).astype(np.uint64)  # ties: position breaks them
            seg = f << np.uint64(32) | rng.permutation(n).astype(np.uint64)
            ordered, nb, w = emulate_sort(seg, n, K11["kKeys"], K11["kPackThreads"],
                                          K11["kShKeys"], rng)
            assert ordered == sorted(int(k) for k in seg), n
            shapes[n] = nb, w
        return shapes[n]

    for n, barriers, where in K11_SHAPES:
        assert shape(n) == (barriers, where), n
    for n, barriers, where in K11_SHAPES:  # 32-bit keys where the range fits
        f = rng.integers(0, 1 << 10, n).astype(np.uint64)
        seg = (f + np.uint64(1 << 31)) << np.uint64(32) | rng.permutation(n).astype(np.uint64)
        ordered, nb, w = emulate_sort(seg, n, K11["kKeys"], K11["kPackThreads"],
                                      K11["kShKeys"], rng, pbits=15)
        assert ordered == sorted(int(k) for k in seg) and nb == barriers, n
        assert w == ("narrow" if n <= K11["kPackThreads"] * K11["kKeys"] else where), n
    for case, counts, *_ in K11_CASES:
        assert tuple(shape(n)[0] if n else 0 for n in counts) == K11_BARRIERS[case], case


# --- K12: the plain tri-partial against JAX's


@pytest.mark.parametrize("ndev", [2, 4])
def test_tri_partial_equals_jax(ndev):
    seqs = ("ACDEFGHIKLMW", "ACDFGHKLMW", "ACEFGIKLW", "ADEFGHIKMW")
    jh = JTriples.build(JHPair.build(JProblem(seqs), backend="host"), fractional=True)
    st_j = JStatic(JProblem(seqs), jh, 16, 1 << 10)
    th = HTriples.build(HPairHeuristic.build(Problem(seqs), "cpu"), fractional=True,
                        device="cpu")
    assert list(th.triangles) == [tuple(t) for t in jh.triangles]
    T, Sz, M, n = st_j.T3, st_j.S, st_j.M, len(seqs)
    cubes = torch.where(th.tri_tabs >= 2**29, 0, th.tri_tabs)
    assert tuple(cubes.shape) == (T, Sz, Sz, Sz)
    tri = torch.tensor(th.triangles, dtype=torch.int32)
    fn, T_loc, T_pad = JS._make_tri_partial(st_j, ndev)
    tri8 = np.zeros((T_pad * Sz ** 3, 8), np.int32)
    tri8[: T * Sz ** 3] = np.asarray(st_j.d_tri8)
    rng = np.random.default_rng(ndev)
    coords = rng.integers(0, 14, size=(ndev * 16, n)).astype(np.int32)
    coords[0] = 0
    coords[1] = [len(s) for s in seqs]
    for me in range(ndev):
        want = np.asarray(fn(jnp.asarray(coords),
                             jnp.asarray(tri8[me * T_loc * Sz ** 3:(me + 1) * T_loc * Sz ** 3]),
                             me))
        lo, hi = min(me * T_loc, T), min((me + 1) * T_loc, T)
        got = S.tri_partial_plain(torch.from_numpy(coords), cubes[lo:hi], tri[lo:hi], M, Sz)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# --- K7's hop mode: a NumPy emulation of path_walk.cu against the plain one


def emulate_hops(st, tab, coord, hops):
    """path_walk_kernel with tmax = hops from ``coord``: each iteration
    stops at the origin, else looks the node up (the first hit in (bucket
    probe r, way) order of the 64 rows from its home bucket) and emits its
    parent mask, or stops when no row holds it."""
    t_sig, t_best = tab.t_sig.numpy(), tab.t_best.numpy()
    c = np.array(coord, np.int64)
    out, it = [0] * hops, 0
    while it < hops and c.any():
        home, sigb = (int(v[0]) for v in _sig_encode(st, torch.from_numpy(c[None])))
        par = None
        for r in range(st.max_bprobes):
            b = (home + r) & (st.nbuck - 1)
            for w in range(st.ways):
                if t_sig[b * st.ways + w] == (sigb | r):
                    par = int(t_best[b * st.ways + w]) & ((1 << st.n) - 1)
                    break
            if par is not None:
                break
        if par is None:
            break
        out[it] = par
        c = c - [(par >> i) & 1 for i in range(st.n)]
        it += 1
    return out + c.tolist() + [it]


def test_k7_hop_emulation_equals_plain(monkeypatch):
    tables = []
    shards = S.ShardedFrontierSearch._shards

    def keep(self):
        tables[:] = shards(self)
        return tables

    monkeypatch.setattr(S.ShardedFrontierSearch, "_shards", keep)
    eng = S.ShardedFrontierSearch(golden("test2.fasta"), devices=["cpu"] * 2)
    res = eng.run()
    path = list(res.closed) + [(0,) * 5, (1, 0, 0, 0, 0)]
    st, hits = eng.st, 0
    for sh in tables:
        for coord in path:
            for hops in (1, 3, 8):
                got = S.walk_hops_plain(st, sh.tab, coord, hops).tolist()
                assert got == emulate_hops(st, sh.tab, coord, hops)
                hits += got[-1] > 0
    assert hits > 0


def test_k4_launch_arguments_match_both_signatures():
    """K4's two instantiations share ``_expand_args``: each launch has its
    entry's arity, and the sharded one differs from the unsharded only in
    the entry, the cubes (none where h3 stands in), the pending rows'
    offset and its own arguments before the stream (the coordinates and the
    rows a block last)."""
    from mpi_pastar_msa_tpu_torch import _kernels
    from mpi_pastar_msa_tpu_torch.search import step

    eng = S.ShardedFrontierSearch(golden("test2.fasta"), devices=["cpu"] * 2)
    st = eng.st
    assert st.T3 > 0
    tab = S._sig_table(st, eng.h_root, True)
    bufs = step.StepBuffers.for_step(st, torch.device("cpu"))
    base = step._expand_args(st, tab, bufs, bufs.counters, eng.ub, "stream")
    extra = (11, 12, *eng.hash_params, eng.ndev, 1, 13, step.K4S_ROWS)
    shd = step._expand_args(st, tab, bufs, bufs.counters, eng.ub, "stream",
                            entry="sig_expand_sharded", cubes=False, pend_at=5, sharded=extra)
    assert len(base) - 1 == len(_kernels.SIGNATURES["sig_expand"])
    assert len(shd) - 1 == len(_kernels.SIGNATURES["sig_expand_sharded"])
    assert base[0] == "sig_expand" and shd[0] == "sig_expand_sharded"
    assert base[5] == st.d_cubes.data_ptr() and shd[5] is None
    assert shd[22] == bufs.pend.data_ptr() + 4 * 3 * 5 == base[22] + 60
    assert shd[-1] == base[-1] == "stream" and shd[23:-1] == extra
    assert shd[1:5] == base[1:5] and shd[6:22] == base[6:22]


# --- the engine on CPU shards


def run_sharded(problem, ndev, **kw):
    eng = S.ShardedFrontierSearch(problem, devices=["cpu"] * ndev, **kw)
    res = eng.run()
    return eng, res, build_alignment(problem, res.closed)


@pytest.mark.parametrize("hash_type,cap", [("FZORDER", None), ("PZORDER", None),
                                           ("FSUM", None), ("PSUM", None), ("FSUM", 1)])
@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("name", ["PF08184.fasta", "test2.fasta"])
def test_engine_reaches_golden(name, ndev, hash_type, cap):
    p = golden(name)
    # a small table keeps the plain select's scan short (the default
    # capacity runs in the tests below)
    eng, res, al = run_sharded(p, ndev, hash_type=hash_type, exchange_cap=cap,
                               capacity=1 << 16)
    assert eng.layout == "sig" and eng.exchange == "dense" and eng.shard_cubes
    assert res.g == GOLD[name]["optimal_g"]
    assert al == GOLD[name]["alignment"]
    assert len(res.shard_stats) == ndev and all(len(r) == 5 for r in res.shard_stats)
    assert res.nodes_migrated == sum(r[4] for r in res.shard_stats) > 0
    # CPU shards run the chunked driver: one host read a chunk
    assert eng.last_stats["driver"] == "chunked"
    assert eng.last_stats["host_reads"] == -(-res.steps // eng.chunk_steps)


def test_engine_test_fasta_on_four_shards():
    eng, res, al = run_sharded(golden("test.fasta"), 4)
    assert res.g == GOLD["test.fasta"]["optimal_g"] and al == GOLD["test.fasta"]["alignment"]


def random_problem(seed, n, lo, hi):
    rs = np.random.RandomState(seed)
    return Problem(tuple("".join(rs.choice(list(AMINO), size=rs.randint(lo, hi + 1)))
                         for _ in range(n)))


@pytest.mark.parametrize("seed,n,ndev,kw", [
    (1, 3, 2, {}), (2, 4, 4, {}), (3, 4, 2, {"exchange": "ragged"}),
    (4, 3, 4, {"hash_type": "PZORDER", "hash_shift": 0}),
    (5, 4, 3, {"exchange_cap": 1, "hash_shift": 0}),
    (6, 4, 4, {"exchange_cap": 2, "exchange": "ragged", "hash_shift": 0})])
def test_engine_random_equals_bruteforce(seed, n, ndev, kw):
    p = random_problem(seed, n, 5, 9)
    eng, res, al = run_sharded(p, ndev, **kw)
    assert res.g == optimal_cost(p, HPairHeuristic.build(p, "cpu"))
    assert [r.replace("-", "") for r in al] == list(p.seqs)


def test_exchange_cap_one_spills_and_stays_optimal():
    # a one-row wire on a random input whose frontier is wide: migrants
    # wait in the carry ring, whose min f stays in the bound, and the
    # optimum holds
    p = random_problem(31, 4, 12, 16)
    want = optimal_cost(p, HPairHeuristic.build(p, "cpu"))
    eng, res, al = run_sharded(p, 4, exchange_cap=1, hash_type="FZORDER", hash_shift=0,
                               batch=16)
    assert eng.last_stats["peak_carry"] > 0
    assert res.g == want


def test_shard_cubes_on_equals_off():
    p = golden("test2.fasta")
    on = run_sharded(p, 4, shard_cubes=True)
    off = run_sharded(p, 4, shard_cubes=False)
    assert on[0].shard_cubes and not off[0].shard_cubes
    assert on[1].g == off[1].g and on[2] == off[2]
    assert (on[1].steps, on[1].nodes_expanded) == (off[1].steps, off[1].nodes_expanded)


@pytest.mark.parametrize("exchange", ["dense", "ragged"])
def test_one_shard_equals_frontier_search(exchange):
    p = golden("PF08184.fasta")
    eng, res, al = run_sharded(p, 1, exchange=exchange)
    ref = FrontierSearch(p, device="cpu").run()
    assert res.g == ref.g == GOLD["PF08184.fasta"]["optimal_g"]
    assert al == build_alignment(p, ref.closed) == GOLD["PF08184.fasta"]["alignment"]
    assert res.nodes_migrated == 0
    assert eng.last_stats["exchange"] == ("none" if exchange == "dense" else "ragged")


def test_fractional_cover_descales():
    p = golden("test2.fasta")
    h = HTriples.build(HPairHeuristic.build(p, "cpu"), fractional=True, device="cpu")
    assert h.cost_scale > 1
    eng, res, al = run_sharded(p, 4, heuristic=h)
    assert res.g == GOLD["test2.fasta"]["optimal_g"] and al == GOLD["test2.fasta"]["alignment"]


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_packed_and_unpacked_layouts_run(layout):
    """PF08184 pinned to each key-row layout on 2 shards, at the default
    capacity: the golden g and alignment, and as many steps as the sig
    layout's run (the layouts store the same states)."""
    p = golden("PF08184.fasta")
    eng, res, al = run_sharded(p, 2, layout=layout)
    assert eng.layout == layout and eng.exchange == "dense"
    assert res.g == GOLD["PF08184.fasta"]["optimal_g"]
    assert al == GOLD["PF08184.fasta"]["alignment"]
    assert res.steps == run_sharded(p, 2)[1].steps


def test_degenerate_auto_layout_equals_single_table():
    """The degenerate input on 2 shards: the automatic layout is unpacked,
    the warning is given, and the g and the alignment are the single-table
    unpacked search's."""
    p = Problem(("WYWY", "WYY", "YWW"))
    with pytest.warns(RuntimeWarning, match="non-positive Altschul"):
        eng, res, al = run_sharded(p, 2)
    assert eng.layout == "unpacked"
    with pytest.warns(RuntimeWarning, match="non-positive Altschul"):
        ref = FrontierSearch(p, device="cpu", layout="unpacked").run()
    assert res.g == ref.g
    assert al == build_alignment(p, ref.closed)
    assert [r.replace("-", "") for r in al] == list(p.seqs)


def test_refusals_and_mesh():
    p = golden("PF08184.fasta")
    with pytest.raises(ValueError):
        S.ShardedFrontierSearch(p, devices=["cpu"] * 2, exchange_cap=0)
    with pytest.raises(ValueError):
        S.ShardedFrontierSearch(p, devices=["cpu"] * 2, exchange="sparse")
    mesh = LocalMesh(["cpu"] * 3)
    xs = [torch.arange(12, dtype=torch.int32).view(3, 2, 2) + 100 * i for i in range(3)]
    out = mesh.all_to_all(xs)
    for i in range(3):
        for j in range(3):
            assert torch.equal(out[j][i], xs[i][j])
    parts = [torch.full((6, 2), i + 1, dtype=torch.int32) for i in range(3)]
    assert all(torch.equal(r, torch.full((2, 2), 6, dtype=torch.int32))
               for r in mesh.reduce_scatter(parts))
    g = mesh.all_gather([torch.tensor([i, 2 * i]) for i in range(3)])
    assert torch.equal(g[2], torch.tensor([[0, 0], [1, 2], [2, 4]]))
    assert mesh.all_sum([torch.tensor([1, 2])] * 3)[1].tolist() == [3, 6]
