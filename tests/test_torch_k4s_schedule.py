"""K4s's rows form (csrc/sig_expand.cu, ``sig_expand_rows_kernel``: the
sharded sig step's expand at M <= 31) on the CPU, with no card: its
constants against the source and the launch arguments, and a NumPy
emulation of its schedule on captured steps of the sharded engine's plain
run on 4 shards (PF08184, N = 3; the random 4 x 12-16 input, N = 4; test2,
N = 5; under each owner hash; with the cubes split, h3 standing in for
them, and with each shard reading its own cubes): rows spread over blocks
of R warps, a lane a mask; each row's coordinate from sig_coords' output
or decoded from its sig word; the term tables built from the row's T8
rows at the lanes of the pairs, padded to ten entries, the mask codes of
``k9s_mask_codes``, the parent's h as mask 0's lookups plus h3's own
column; the home bucket row's first matching way; one place atomic a
block on kNPend, the blocks in several orders from a seed, the prefix over
a block's warps; a candidate row an int4 a lane.  The places form a
permutation of [0, n_pend), the pending entries equal
``expand_sharded_plain``'s as a multiset, and every candidate word, t_best
after the round-0 match, the surviving lanes and the goal equal it."""
import json
import os
import re

import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu_torch import _kernels
from mpi_pastar_msa_tpu_torch.core.cost import GAP_EXTENSION, GAP_GAP
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.parallel import sharded as S
from mpi_pastar_msa_tpu_torch.search import step as TS
from mpi_pastar_msa_tpu_torch.search.engine import INF, INFP

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))
AMINO = "ACDEFGHIKLMNPQRSTVWY"
SOURCE = open(os.path.join(_kernels.CSRC, "sig_expand.cu")).read()
M32 = 0xFFFFFFFF
SIG_ODD, SIG_ODD_INV = 0x9E3779B1, 0x0E8B2F51  # csrc/sig_key.cuh


def golden(name):
    return Problem(tuple(r.replace("-", "") for r in GOLD[name]["alignment"]))


def random_problem(seed, n, lo, hi):
    rs = np.random.RandomState(seed)
    return Problem(tuple("".join(rs.choice(list(AMINO), size=rs.randint(lo, hi + 1)))
                         for _ in range(n)))


def src_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


# --- the constants and the launch


def test_k4s_constants_match_source():
    """The rows form's widest row (kRowsMaxN) is K9S_ROWS_MAX_M's; its
    padded tables hold every pair and cube of that row and its corners fit
    three a lane; K4S_ROWS is a block the kernel takes; the C entry ends
    with the coordinates and the rows; k4s_rows keeps the warp-strided
    form past M = 31."""
    n_max = src_const("kRowsMaxN")
    assert (1 << n_max) - 1 == TS.K9S_ROWS_MAX_M
    assert src_const("kRowsMaxP") == n_max * (n_max - 1) // 2
    assert src_const("kRowsMaxT") == n_max * (n_max - 1) * (n_max - 2) // 6
    assert 8 * src_const("kRowsMaxT") <= 32 * src_const("kRowsCorners")
    assert 1 <= TS.K4S_ROWS <= src_const("kRowsMaxWarps") == 8
    assert "int ndev, int me,\n                                  const void* coords, int rows, " \
           "void* stream)" in SOURCE
    assert TS.k4s_rows(31) == TS.K4S_ROWS and TS.k4s_rows(15, 4) == 4
    assert TS.k4s_rows(63) == 0 and TS.k4s_rows(31, 0) == 0
    with pytest.raises(ValueError):
        TS.k4s_rows(31, 9)


def test_k4s_launch_arguments(monkeypatch):
    """expand_sharded_cuda's launch (its CUDA checks replaced, so that CPU
    tensors pass): sig_expand_sharded's arity, the coordinates' address
    (None without them) and the rows a block (k4s_rows) just before the
    stream, the rest as the unsharded K4's arguments give them."""
    eng = S.ShardedFrontierSearch(golden("test2.fasta"), devices=["cpu"] * 4)
    st = eng.st
    tab = S._sig_table(st, eng.h_root, True)
    bufs = TS.StepBuffers.for_step(st, torch.device("cpu"))
    bufs.pend = torch.zeros((3 + st.B * st.M, 3), dtype=torch.int32)
    cand = torch.zeros((st.B * st.M, 4), dtype=torch.int32)
    coords = torch.zeros((st.B, st.n), dtype=torch.int32)
    h3 = torch.zeros((st.B, st.M + 1), dtype=torch.int32)
    monkeypatch.setattr(TS, "_check_step", lambda *a, **k: torch.device("cpu"))
    monkeypatch.setattr(TS, "_stream", lambda dev: "stream")
    base = TS._expand_args(st, tab, bufs, bufs.counters, eng.ub, "stream")
    seen = []
    for kw in (dict(coords=coords), dict(coords=None, rows=0), dict(coords=coords, rows=4)):
        got = []
        TS.expand_sharded_cuda(st, tab, bufs, bufs.counters, eng.ub, h3, cand, 3,
                               eng.hash_params, eng.ndev, 1, launch=lambda *a: got.append(a),
                               **kw)
        (args,) = got
        assert args[0] == "sig_expand_sharded" and args[-1] == "stream"
        assert len(args) - 1 == len(_kernels.SIGNATURES["sig_expand_sharded"])
        assert args[5] is None and args[1:5] == base[1:5] and args[6:22] == base[6:22]
        assert args[22] == bufs.pend.data_ptr() + 4 * 3 * 3
        assert args[23:31] == (h3.data_ptr(), cand.data_ptr(), *eng.hash_params, eng.ndev, 1)
        seen.append(args[31:33])
    assert seen == [(coords.data_ptr(), TS.K4S_ROWS), (None, 0), (coords.data_ptr(), 4)]


# --- the schedule on captured steps


def captured_steps(problem, keep=3, **kw):
    """The sharded engine's plain run on 4 CPU shards, sig; the inputs of
    the ``keep`` - 2 calls of expand_sharded_plain that list the most rows
    (then remote and pending lanes; the earliest on a tie) and of the
    first with a remote lane, the first with a pending one and the first
    with a lane matched in its home row, each with the table as it
    stood."""
    calls = []
    plain = S.expand_sharded_plain

    def capture(st, tab, sel, n_sel, ub, h3, own, ndev, me):
        before = type(tab)(*(getattr(tab, f).clone() for f in tab.__dataclass_fields__))
        out = plain(st, tab, sel, n_sel, ub, h3, own, ndev, me)
        if n_sel:
            calls.append(dict(st=st, tab=before, sel=sel.clone(), n_sel=n_sel, ub=ub,
                              h3=None if h3 is None else h3.clone(), own=own, ndev=ndev, me=me,
                              remote=bool((out[1][:n_sel * st.M, 0] < ndev).any()),
                              pending=out[2].shape[0] > 0,
                              # survivors neither remote nor pending
                              matched=out[3] - int((out[1][:n_sel * st.M, 0] < ndev).sum())
                              - out[2].shape[0] > 0))
        return out

    S.expand_sharded_plain = capture
    try:
        eng = S.ShardedFrontierSearch(problem, devices=["cpu"] * 4, layout="sig", **kw)
        eng.run()
    finally:
        S.expand_sharded_plain = plain
    assert len(calls) >= keep
    picks = sorted(range(len(calls)), key=lambda k: (-calls[k]["n_sel"],
                                                     -calls[k]["remote"] - calls[k]["pending"]))
    picks = picks[:keep - 2]
    for kind in ("remote", "pending", "matched"):  # and the first step with a lane of each kind
        picks.append(next((k for k in range(len(calls)) if calls[k][kind]), 0))
    return eng, [calls[k] for k in sorted(set(picks))]


def wide_step(eng, split, slack=20000):
    """A step of every stored node at once: the finished table of the
    shard that holds the most, its first B stored slots listed (slot,
    t_best word) as K3 lists rows, the upper bound ``slack`` above the
    run's, and h3 summed from every shard's K12 partials (``split``):
    rows of several blocks, whose children are stored, remote and new."""
    st = eng.st
    sh = max(eng.shards, key=lambda x: int((x.tab.t_sig[:st.C] != -1).sum()))
    slots = torch.nonzero(sh.tab.t_sig[:st.C] != -1)[:, 0][:st.B]
    n = slots.numel()
    sel = torch.zeros((st.B, 2), dtype=torch.int32)
    sel[:n, 0], sel[:n, 1] = slots.to(torch.int32), sh.tab.t_best[slots]
    h3 = None
    if split:
        coords = S.sig_coords_plain(st, sh.tab.t_sig, sel, n, st.B)
        h3 = sum(S.tri_partial_plain(coords, x.cubes, x.tri, st.M, st.S).long()
                 for x in eng.shards).to(torch.int32)
    clone = lambda t: type(t)(*(getattr(t, f).clone() for f in t.__dataclass_fields__))
    c = dict(st=st, tab=clone(sh.tab), sel=sel, n_sel=n, ub=eng.ub + slack, h3=h3,
             own=eng.own, ndev=eng.ndev, me=sh.me)
    # a few of its pending lanes' nodes stored in a free way of their home
    # row, the stored word one above theirs: lanes that match and settle
    _, _, pending, _ = S.expand_sharded_plain(st, clone(c["tab"]), sel, n, c["ub"], h3,
                                              eng.own, eng.ndev, sh.me)
    for home, sigb, packed in pending[::7][:6].tolist():
        free = [w for w in range(st.ways) if int(c["tab"].t_sig[home * st.ways + w]) == -1]
        if free:
            c["tab"].t_sig[home * st.ways + free[-1]] = sigb
            c["tab"].t_best[home * st.ways + free[-1]] = packed + 1
    return c


def mix32(x):
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & np.uint64(M32)
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & np.uint64(M32)
    x ^= x >> np.uint64(16)
    return x


def i32(x):
    x = np.asarray(x, dtype=np.int64) & M32
    return np.where(x >= 1 << 31, x - (1 << 32), x)


def sig_decode(st, slot, sig, shift, bw):
    """sig_key.cuh's decode of (slot, stored word) into the N coordinates."""
    Bmask = np.uint64(st.nbuck - 1)
    sig = np.asarray(sig, dtype=np.int64).astype(np.uint64) & np.uint64(M32)
    r, khi = sig & np.uint64(63), sig >> np.uint64(6)
    home = ((np.asarray(slot, dtype=np.uint64) >> np.uint64(3)) - r) & Bmask
    klo = (((home ^ (mix32(khi) & Bmask)) * np.uint64(SIG_ODD_INV)) & np.uint64(M32)) & Bmask
    key = klo | (khi << np.uint64(st.bbits))
    return np.stack([((key >> np.uint64(s)) & np.uint64((1 << b) - 1)).astype(np.int64)
                     for s, b in zip(shift, bw)], axis=-1)


def sig_encode(st, key):
    """sig_key.cuh's (home, sig base) of packed keys (uint64)."""
    Bmask = np.uint64(st.nbuck - 1)
    clo = key & Bmask
    chi = (key >> np.uint64(st.bbits)) & np.uint64(M32)
    home = ((clo * np.uint64(SIG_ODD)) & np.uint64(M32) & Bmask) ^ (mix32(chi) & Bmask)
    return home.astype(np.int64), ((chi << np.uint64(6)) & np.uint64(M32)).astype(np.int64)


def warp_lanes(c, with_coords):
    """Every listed row's 32 lanes as the rows form computes them (lane l
    mask m = l + 1, none past M), vectorised over rows and lanes: the
    coordinate from sig_coords_plain (``with_coords``) or decoded from the
    row's sig word; the terms of each pair from the row's T8 row (four
    entries, 2 bx + by, padded to ten pairs), the corners of each cube (or
    h3), the parent's h as mask 0's lookups and h3's own column, g from
    the listed word; each mask's cost and h by its codes; the child's sig
    key, home row, its first matching way, its owner.  Returns a dict of
    (n, 32) arrays and the goal before the prune."""
    st, tab = c["st"], c["tab"]
    n, N, M, P, T, nb = c["n_sel"], st.n, st.M, st.P, st.T3, st.nb
    params = TS._kernel_params(st, torch.device("cpu")).long().numpy()
    xs, ys, w, wh = (params[k * P:(k + 1) * P] for k in range(4))
    tri = params[4 * P:4 * P + 3 * T].reshape(-1, 3)
    fin = params[4 * P + 3 * T:4 * P + 3 * T + N]
    bw = params[4 * P + 3 * T + N:4 * P + 3 * T + 2 * N]
    codes = params[4 * P + 3 * T + 2 * N:].reshape(M, 2)
    shift = np.concatenate([[0], np.cumsum(bw)[:-1]])
    sel = c["sel"][:n].long().numpy()
    t_sig = tab.t_sig.long().numpy()
    if with_coords:
        co = S.sig_coords_plain(st, tab.t_sig, c["sel"], n, st.B)[:n].long().numpy()
    else:
        co = sig_decode(st, sel[:, 0], t_sig[sel[:, 0]], shift, bw)
    m = np.arange(1, 33)
    bits = (m[:, None] >> np.arange(N)[None, :]) & 1  # (32, N)
    cc = co[:, None, :] + bits[None]  # (n, 32, N)
    room = ((co < fin) << np.arange(N)).sum(1)
    short1 = ((co + 1 == fin) << np.arange(N)).sum(1)
    near = ((co == fin) | (co + 1 == fin)).all(1)
    fits = (co <= fin).all(1)
    can = (m[None] <= M) & fits[:, None] & ((m[None] & ~room[:, None]) == 0)
    key = np.zeros(cc.shape[:2], dtype=np.uint64)
    for d in range(N):
        key |= cc[..., d].astype(np.uint64) << np.uint64(shift[d])
    home, sigb = sig_encode(st, key)
    # the term tables: (n, 10, 4) cost and h, the pairs past P zero
    S_ = st.S
    t8 = st.d_tables4.long().numpy().reshape(P, S_, S_, 8)
    clamp = lambda v: np.clip(v, 0, S_ - 2)
    par = sel[:, 1] & ((1 << nb) - 1)
    tc = np.zeros((n, 10, 4), dtype=np.int64)
    th = np.zeros((n, 10, 4), dtype=np.int64)
    for p in range(P):
        row = t8[p, clamp(co[:, xs[p]]), clamp(co[:, ys[p]])]  # (n, 8)
        go = st.gap_oe * w[p]
        tc[:, p] = np.stack([np.full(n, w[p] * GAP_GAP),
                             w[p] * GAP_EXTENSION + go * ((par >> xs[p]) & 1),
                             w[p] * GAP_EXTENSION + go * ((par >> ys[p]) & 1),
                             w[p] * row[:, 4]], 1)
        th[:, p] = row[:, :4] * wh[p]
    cubes_on = c["h3"] is None and T > 0
    corner = np.zeros((n, 10, 8), dtype=np.int64)
    if cubes_on:
        cub = st.d_cubes.long().numpy().reshape(T, S_, S_, S_)
        for t in range(T):
            x, y, z = (clamp(co[:, a]) for a in tri[t])
            for q in range(8):
                corner[:, t, q] = cub[t, x + ((q >> 2) & 1), y + ((q >> 1) & 1), z + (q & 1)]
    h3 = (c["h3"][:n].long().numpy() if c["h3"] is not None
          else np.zeros((n, M + 1), dtype=np.int64))
    h_row = h3[:, M] + th[:, :, 0].sum(1) + corner[:, :, 0].sum(1)
    g = (sel[:, 1] >> nb) + st.f0 - h_row
    pidx = (codes[:, 0][:, None] >> (2 * np.arange(10))[None]) & 3  # (M, 10)
    cidx = (codes[:, 1][:, None] >> (3 * np.arange(10))[None]) & 7
    lanes = np.arange(M)
    cost = np.zeros((n, 32), dtype=np.int64)
    h = np.zeros((n, 32), dtype=np.int64)
    for p in range(10):
        cost[:, :M] += tc[:, p][:, pidx[:, p]]
        h[:, :M] += th[:, p][:, pidx[:, p]]
    for t in range(10):
        h[:, :M] += corner[:, t][:, cidx[:, t]]
    h[:, :M] += h3[:, lanes]
    gc = g[:, None] + cost
    fc = gc + h
    goal_m = np.where(near, short1, -1)
    goal = gc[can & (m[None] == goal_m[:, None])]
    valid = can & (fc <= c["ub"])
    owner = np.full((n, 32), c["ndev"], dtype=np.int64)
    owner[can] = np.asarray(c["own"](torch.as_tensor(cc[can].astype(np.int32)))).astype(np.int64)
    self_ = can & (owner == c["me"])
    ways = t_sig[(home[..., None] * 8 + np.arange(8)).clip(0, st.C - 1)]  # (n, 32, 8)
    match = ways == i32(sigb)[..., None]
    way = np.where(match.any(-1), match.argmax(-1), -1)
    packed = i32(((fc - st.f0) << nb) | m[None])
    return dict(valid=valid, self=self_, owner=owner, home=home, sigb=i32(sigb), way=way,
                packed=packed), (int(goal.min()) if goal.size else INF)


def emulate_rows_form(c, R, seed, with_coords):
    """The rows form's schedule on captured step ``c``: B rows over ceil(B
    / R) blocks of R warps (row i = block R + warp; a block whose first
    row is past n_sel returns), each live row's M lanes writing their
    int4 candidate row; the round-0 matches' t_best mins; then the blocks
    in a random order (``seed``) each making one place atomic on kNPend
    for its warps' ballots, a warp's places from the block's base plus the
    counts of the warps before it, a lane's its rank in its warp's ballot.
    Returns (cand rows of the listed rows, pending entries by place, places
    taken, surviving lanes, goal, t_best, lanes matched in their home
    row)."""
    st = c["st"]
    n, M, B, ndev = c["n_sel"], st.M, st.B, c["ndev"]
    L, goal = warp_lanes(c, with_coords)
    blocks = -(-B // R)
    cand = np.full((B * M, 4), 0x5A5A5A5A, dtype=np.int64)
    writes = np.zeros(B * M, dtype=np.int64)
    t_best = c["tab"].t_best.clone()
    pending = L["valid"] & L["self"] & (L["way"] < 0)
    live_blocks = [b for b in range(blocks) if b * R < n]
    for b in live_blocks:
        for w in range(R):
            i = b * R + w
            if i >= n:
                continue  # the warp joins the block's barriers, with no row
            for lane in range(M):
                row = ([L["owner"][i, lane], L["packed"][i, lane], L["home"][i, lane],
                        L["sigb"][i, lane]]
                       if L["valid"][i, lane] and not L["self"][i, lane] else [ndev, INFP, 0, -1])
                cand[i * M + lane] = row  # one int4 a lane
                writes[i * M + lane] += 1
                if L["valid"][i, lane] and L["self"][i, lane] and L["way"][i, lane] >= 0:
                    at = int(L["home"][i, lane]) * 8 + int(L["way"][i, lane])
                    t_best[at] = min(int(t_best[at]), int(L["packed"][i, lane]))
    assert (writes[:n * M] == 1).all() and writes.sum() == n * M
    rng = np.random.default_rng(seed)
    counter, pend, places = 0, {}, []
    for b in rng.permutation(live_blocks).tolist():
        ballots = [pending[b * R + w].tolist() if b * R + w < n else [False] * 32
                   for w in range(R)]
        counts = [sum(bl) for bl in ballots]
        base, counter = counter, counter + sum(counts)  # the block's one atomicAdd
        for w in range(R):
            at = base + sum(counts[:w])  # the prefix over the warps before it
            for lane in range(32):
                if ballots[w][lane]:
                    place = at + sum(ballots[w][:lane])  # its rank in the ballot
                    places.append(place)
                    i = b * R + w
                    pend[place] = (int(L["home"][i, lane]), int(L["sigb"][i, lane]),
                                   int(L["packed"][i, lane]))
    n_valid = int(L["valid"].sum())
    matched = int((L["valid"] & L["self"] & (L["way"] >= 0)).sum())
    return cand[:n * M], [pend[k] for k in sorted(pend)], places, n_valid, goal, t_best, matched


CASES = [  # (input, owner hash, cubes split)
    ("PF08184.fasta", "FSUM", True), ("PF08184.fasta", "FSUM", False),
    ("random", "FZORDER", True), ("random", "PSUM", False),
    ("test2.fasta", "FZORDER", True), ("test2.fasta", "PZORDER", True),
    ("test2.fasta", "FSUM", True), ("test2.fasta", "PSUM", True),
    ("test2.fasta", "FSUM", False)]


@pytest.mark.parametrize("name,hash_type,split", CASES,
                         ids=[f"{n.split('.')[0]}-{h}-{'h3' if s else 'cubes'}"
                              for n, h, s in CASES])
def test_k4s_rows_schedule_equals_plain(name, hash_type, split):
    problem = random_problem(31, 4, 12, 16) if name == "random" else golden(name)
    kw = dict(batch=16, hash_shift=0) if name == "random" else dict(capacity=1 << 14)
    eng, steps = captured_steps(problem, keep=4, hash_type=hash_type, shard_cubes=split, **kw)
    assert eng.layout == "sig" and eng.cubes_split == split and eng.st.M <= TS.K9S_ROWS_MAX_M
    steps.append(wide_step(eng, split))
    seen = dict(remote=0, pending=0, matched=0)
    for k, c in enumerate(steps):
        assert (c["h3"] is not None) == split
        tab = type(c["tab"])(*(getattr(c["tab"], f).clone() for f in c["tab"].__dataclass_fields__))
        goal, cand, pending, n_valid = S.expand_sharded_plain(
            c["st"], tab, c["sel"], c["n_sel"], c["ub"], c["h3"], c["own"], c["ndev"], c["me"])
        L = c["n_sel"] * c["st"].M
        want_pend = sorted(map(tuple, pending.tolist()))
        C = c["st"].C  # the plain version's misses go to trash slots past C
        for R, seed, with_coords in ((1, 3 * k, True), (2, 3 * k + 1, False),
                                     (4, 3 * k + 2, True), (8, 3 * k + 3, False),
                                     (TS.K4S_ROWS, 3 * k + 4, split)):
            e_cand, e_pend, places, e_valid, e_goal, e_best, matched = emulate_rows_form(
                c, R, seed, with_coords)
            assert sorted(places) == list(range(len(places)))
            assert sorted(e_pend) == want_pend
            assert np.array_equal(e_cand, cand[:L].numpy())
            assert e_valid == n_valid and e_goal == goal
            assert torch.equal(e_best[:C], tab.t_best[:C])
        seen["remote"] += int((cand[:L, 0] < c["ndev"]).sum())
        seen["pending"] += len(want_pend)
        seen["matched"] += matched
    # the steps' lanes hold every kind: remote candidate rows, pending
    # lanes and lanes matched in their home row
    assert seen["remote"] > 0 and seen["pending"] > 0 and seen["matched"] > 0, seen
    assert max(c["n_sel"] for c in steps) > 2, [c["n_sel"] for c in steps]
