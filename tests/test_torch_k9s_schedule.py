"""K9s's rows form (csrc/keyrow_expand.cu, ``keyrow_expand_rows_kernel``:
the sharded step's expand at M <= 31) on the CPU, with no card: its launch
shape (``search/step.py::k9s_launch_shape``), its constants against the
source, and a NumPy emulation of its schedule on captured steps of the
sharded engine's plain run (the random 4 x 12-16 input and PF08184 on 4
shards, packed and unpacked): rows spread over blocks of R warps, a
lane a mask; each block's one place atomic on kNPend, the blocks in
several orders from a seed; the prefix over a block's warps; the
candidate rows staged at their destination's phase and stored in 16-byte
chunks, a word at a time in the span's head and tail.  The places form a
permutation of [0, n_pend), the pending entries equal
``expand_keyrow_sharded_plain``'s as a multiset, and every candidate word
(and t_best after the round-0 match, the surviving lanes, the goal)
equals it."""
import json
import os
import re

import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu_torch import _kernels
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.parallel import sharded as S
from mpi_pastar_msa_tpu_torch.search import step as TS
from mpi_pastar_msa_tpu_torch.search.engine import INF, INFP

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))
AMINO = "ACDEFGHIKLMNPQRSTVWY"
SOURCE = open(os.path.join(_kernels.CSRC, "keyrow_expand.cu")).read()
M32 = 0xFFFFFFFF


def golden(name):
    return Problem(tuple(r.replace("-", "") for r in GOLD[name]["alignment"]))


def random_problem(seed, n, lo, hi):
    rs = np.random.RandomState(seed)
    return Problem(tuple("".join(rs.choice(list(AMINO), size=rs.randint(lo, hi + 1)))
                         for _ in range(n)))


def src_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


# --- the launch shape


@pytest.mark.parametrize("B,M,sms,rows", [
    (508, 31, 132, TS.K9S_ROWS),   # kinase on 4 shards, step 200's list
    (512, 31, 132, TS.K9S_ROWS),   # kinase's batch on 4 shards
    (512, 31, 132, 1), (512, 31, 132, 8),
    (16, 15, 132, TS.K9S_ROWS),    # the random 4 x 12-16 input, batch 16
    (1024, 63, 132, TS.K9S_ROWS),  # N = 6: the block form
    (512, 31, 114, TS.K9S_ROWS),   # a card of 114 multiprocessors
    (512, 31, 132, 0)])            # rows 0: the block form
def test_k9s_launch_shape(B, M, sms, rows):
    blocks, threads, r = TS.k9s_launch_shape(B, M, sms, rows)
    if rows and M <= TS.K9S_ROWS_MAX_M:
        # a warp a row, every row of the list's B has one, no block idle
        assert (threads, r) == (32 * rows, rows)
        assert blocks * rows >= B > (blocks - 1) * rows
        assert threads <= src_const("kMaxThreads")
    else:
        assert (blocks, threads) == TS.k9_launch_shape(B, M, sms)[:2] and r == 0
    # the grid does not depend on the card's multiprocessors in the rows form
    if r:
        assert TS.k9s_launch_shape(B, M, 132, rows) == TS.k9s_launch_shape(B, M, sms, rows)


def test_k9s_constants_match_source():
    """The rows form's widest row (kRowsMaxN) is K9S_ROWS_MAX_M's; its
    padded tables hold every pair and cube of that row; a block of 8 warps
    fits kMaxThreads, its shared memory (rows_shared_bytes) 48 KB, and a
    thread's params words (kRowsParams) the constants, at every N it takes,
    rows of 2 + W + 5 words."""
    n_max = src_const("kRowsMaxN")
    assert (1 << n_max) - 1 == TS.K9S_ROWS_MAX_M
    assert src_const("kRowsMaxW") == (n_max + 1) // 2
    assert "constexpr int kRowsMaxCW = 2 + kRowsMaxW + 5;" in SOURCE
    assert src_const("kRowsMaxP") == n_max * (n_max - 1) // 2 <= 32
    assert src_const("kRowsMaxT") == n_max * (n_max - 1) * (n_max - 2) // 6
    assert 8 * src_const("kRowsMaxT") <= 32 * src_const("kRowsCorners")
    assert 8 * 32 <= src_const("kMaxThreads") and TS.K9S_ROWS <= 8
    assert "int tag_base, int rows, void* stream" in SOURCE
    a16 = lambda b: (b + 15) // 16 * 16
    for N in range(2, n_max + 1):
        P, T, W = N * (N - 1) // 2, N * (N - 1) * (N - 2) // 6, (N + 1) // 2
        CW = 2 + W + 5
        warp = 16 * 4 * src_const("kRowsMaxP") + 4 * 8 * src_const("kRowsMaxT") + a16(
            4 * (31 * CW + 3))
        assert a16(4 * (4 * P + 3 * T + N)) + 8 * warp <= 48 * 1024
        assert 4 * P + 3 * T + N <= 32 * src_const("kRowsParams")


# --- the schedule on captured steps


def captured_steps(problem, layout, keep=3, **kw):
    """The sharded engine's plain run on 4 CPU shards, ``layout``; the
    inputs of the ``keep`` - 2 calls of expand_keyrow_sharded_plain that
    list the most rows (then remote and pending lanes; the earliest on a
    tie) and of the first with a remote lane and the first with a pending
    one, each with the table as it stood."""
    calls = []
    plain = S.expand_keyrow_sharded_plain

    def capture(st, tab, lay, sel, n_sel, ub, h3, own, ndev, me, tag_base):
        before = type(tab)(*(getattr(tab, f).clone() for f in tab.__dataclass_fields__))
        out = plain(st, tab, lay, sel, n_sel, ub, h3, own, ndev, me, tag_base)
        if n_sel:
            calls.append(dict(st=st, tab=before, layout=lay, sel=sel.clone(), n_sel=n_sel,
                              ub=ub, h3=None if h3 is None else h3.clone(), own=own, ndev=ndev,
                              me=me, tag_base=tag_base,
                              remote=bool((out[1][:n_sel * st.M, 0] < ndev).any()),
                              pending=out[2].shape[0] > 0))
        return out

    S.expand_keyrow_sharded_plain = capture
    try:
        eng = S.ShardedFrontierSearch(problem, devices=["cpu"] * 4, layout=layout, **kw)
        eng.run()
    finally:
        S.expand_keyrow_sharded_plain = plain
    assert len(calls) >= keep
    picks = sorted(range(len(calls)), key=lambda k: (-calls[k]["n_sel"],
                                                     -calls[k]["remote"] - calls[k]["pending"]))
    picks = picks[:keep - 2]
    for kind in ("remote", "pending"):  # and the first step with a lane of each kind
        picks.append(next((k for k in range(len(calls)) if calls[k][kind]), 0))
    return [calls[k] for k in sorted(set(picks))]


def mix32(x):
    x = np.uint64(x)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & np.uint64(M32)
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & np.uint64(M32)
    x ^= x >> np.uint64(16)
    return int(x)


def hash_words(words):
    h = 2166136261
    for w in words:
        h = ((h ^ w) * 16777619) & M32
    return mix32(h)


def i32(x):
    x &= M32
    return x - (1 << 32) if x >= 1 << 31 else x


def warp_lanes(c):
    """Each listed row's 32 lanes as the rows form computes them: lane l
    takes mask m = l + 1 (none past M); the row's cost and h from the
    port's _expand (the arithmetic the block form's term tables hold);
    the child's key words, hash, owner and (packed) home row in NumPy.
    Returns a list a row of 32 lane dicts and the goal before the
    prune."""
    st, layout, tab = c["st"], c["layout"], c["tab"]
    n_sel, M, W, nb, C = c["n_sel"], st.M, st.W, st.nb, st.C
    sel = c["sel"][:n_sel].long()
    rows = tab.t_key[sel[:, 0]]
    coords = S._unpack_keys(st, rows)
    pm = (1 << nb) - 1
    if layout == "packed":
        g, par, f_par = (sel[:, 1] >> nb) + st.f0 - rows[:, W].long(), sel[:, 1] & pm, None
    else:
        fp = tab.t_fpar[sel[:, 0]]
        g, par, f_par = tab.t_g[sel[:, 0]].long(), fp & pm, fp >> nb
    g_c, f_c, _, valid0, is_goal, child = S._expand(
        st, coords, g, par, torch.ones(n_sel, dtype=torch.bool), f_parent=f_par,
        h3=None if c["h3"] is None else c["h3"][:n_sel])
    # _expand's lanes are row-major: lane i M + m - 1
    g_c, f_c, valid0, is_goal = (t.view(n_sel, M) for t in (g_c, f_c, valid0, is_goal))
    owner = c["own"](child.to(torch.int32)).view(n_sel, M).numpy()
    child = child.view(n_sel, M, st.n).numpy()
    key = tab.t_key[:C].numpy()
    goal = INF
    out = []
    for i in range(n_sel):
        lanes = []
        for lane in range(32):
            m = lane + 1
            if m > M or not bool(valid0[i, m - 1]):
                lanes.append(dict(m=m, valid=False, pending=False))
                continue
            gc, fc = int(g_c[i, m - 1]), int(f_c[i, m - 1])
            if bool(is_goal[i, m - 1]):
                goal = min(goal, gc)  # before the prune
            valid = fc <= c["ub"]
            ch = [int(v) for v in child[i, m - 1]] + [0]
            words = [ch[2 * j] | (ch[2 * j + 1] << 16 if 2 * j + 1 < st.n else 0)
                     for j in range(W)]
            h0 = hash_words(words)
            dest = int(owner[i, m - 1])
            tag = c["tag_base"] + i * M + m - 1
            if layout == "packed":
                fsort = ((fc - st.f0) << nb) | m
                entry = [i32(w) for w in words] + [i32(h0), tag, fc - gc, fsort]
            else:
                fsort = fc
                fpar = fc * (1 << nb) + m
                entry = [i32(w) for w in words] + [i32(h0), tag, gc, i32(fpar), fpar >> 32]
            lane_d = dict(m=m, valid=valid, dest=dest, self=dest == c["me"], fsort=fsort,
                          entry=entry, home=h0 & (C - 1), pending=False, hit=False)
            if valid and lane_d["self"]:
                home = key[lane_d["home"]]
                lane_d["hit"] = (layout == "packed" and int(home[0]) != -1
                                 and all(int(home[w]) == i32(words[w]) for w in range(W)))
                lane_d["pending"] = not lane_d["hit"]
            lanes.append(lane_d)
        out.append(lanes)
    return out, goal


def emulate_rows_form(c, R, seed, cand_word0):
    """The rows form's schedule on captured step ``c``: B rows over
    ceil(B / R) blocks of R warps (row i = block R + warp; a block whose
    first row is past n_sel returns), each live warp's candidate rows
    staged at the phase of their destination (``cand_word0``: the cand
    buffer's first word's phase in 16-byte chunks) and stored as
    store_span does (the whole chunks, up to three a lane, as 16-byte
    stores; the head's words by lanes 0-3 and the tail's by lanes 4-7:
    each word once); the packed round-0 matches'
    t_best mins; then the blocks in a random order (``seed``) each making
    one place atomic on kNPend for its warps' ballots, a warp's places
    from the block's base plus the counts of the warps before it, a
    lane's its rank in its warp's ballot.  Returns (cand words of the
    listed rows, pending entries by place, places taken, surviving lanes,
    goal, t_best)."""
    st, layout = c["st"], c["layout"]
    n_sel, M, B = c["n_sel"], st.M, st.B
    fill = S.keyrow_fill(st, layout, c["ndev"])
    CW = len(fill)
    lanes, goal = warp_lanes(c)
    blocks, threads, rows = TS.k9s_launch_shape(B, M, 132, R)
    assert rows == R and threads == 32 * R
    mem = np.full(cand_word0 + B * M * CW + 4, 0x5A5A5A5A, dtype=np.int64)
    writes = np.zeros_like(mem)
    t_best = c["tab"].t_best.clone() if layout == "packed" else None
    n_valid = 0
    live_blocks = [b for b in range(blocks) if b * R < n_sel]
    for b in live_blocks:
        for w in range(R):
            i = b * R + w
            if i >= n_sel:
                continue  # the warp joins the block's barriers, with no row
            stage = np.zeros(3 + 31 * CW + 4, dtype=np.int64)
            dst = cand_word0 + i * M * CW
            g0 = dst % 4
            for ln in lanes[i][:M]:
                r = (([ln["dest"], ln["fsort"]] + ln["entry"])
                     if ln["valid"] and not ln["self"] else fill)
                stage[g0 + (ln["m"] - 1) * CW: g0 + ln["m"] * CW] = r
                if ln.get("hit"):
                    t_best[ln["home"]] = min(int(t_best[ln["home"]]), ln["fsort"])
                n_valid += ln["valid"]
            n = M * CW
            base = dst - g0
            assert base % 4 == 0
            end, first, last = g0 + n, (g0 + 3) // 4, (g0 + n) // 4
            for lane in range(32):  # store_span: a lane's chunks, then its word
                for k in range(3):
                    j = first + lane + 32 * k
                    if j < last:  # one 16-byte store
                        mem[base + 4 * j: base + 4 * j + 4] = stage[4 * j: 4 * j + 4]
                        writes[base + 4 * j: base + 4 * j + 4] += 1
                assert first + lane + 32 * 3 >= last  # three chunks a lane suffice
                q = lane if lane < 4 else 4 * last + lane - 4
                if lane < 8 and (g0 <= q < 4 * first if lane < 4 else q < end):
                    mem[base + q] = stage[q]  # the head's or the tail's word
                    writes[base + q] += 1
    listed = slice(cand_word0, cand_word0 + n_sel * M * CW)
    assert (writes[listed] == 1).all() and writes.sum() == n_sel * M * CW
    # the places: one atomic a block, blocks in a random order
    rng = np.random.default_rng(seed)
    counter, pend, places = 0, {}, []
    for b in rng.permutation(live_blocks).tolist():
        ballots = [[ln["pending"] for ln in lanes[b * R + w]] if b * R + w < n_sel else
                   [False] * 32 for w in range(R)]
        counts = [sum(bl) for bl in ballots]
        base, counter = counter, counter + sum(counts)  # the block's one atomicAdd
        for w in range(R):
            at = base + sum(counts[:w])  # the prefix over the warps before it
            for lane in range(32):
                if ballots[w][lane]:
                    place = at + sum(ballots[w][:lane])  # its rank in the ballot
                    places.append(place)
                    pend[place] = lanes[b * R + w][lane]["entry"]
    cand = mem[listed].reshape(n_sel * M, CW)
    return cand, [pend[k] for k in sorted(pend)], places, n_valid, goal, t_best


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("name", ["random", "PF08184.fasta"])
def test_k9s_rows_schedule_equals_plain(name, layout):
    problem = (random_problem(31, 4, 12, 16) if name == "random" else golden(name))
    kw = dict(batch=16, hash_type="FSUM", hash_shift=0) if name == "random" else {}
    steps = captured_steps(problem, layout, keep=4, **kw)
    seen = dict(remote=0, pending=0)
    for k, c in enumerate(steps):
        tab = type(c["tab"])(*(getattr(c["tab"], f).clone() for f in c["tab"].__dataclass_fields__))
        goal, cand, pending, n_valid = S.expand_keyrow_sharded_plain(
            c["st"], tab, layout, c["sel"], c["n_sel"], c["ub"], c["h3"], c["own"], c["ndev"],
            c["me"], c["tag_base"])
        L = c["n_sel"] * c["st"].M
        want_pend = sorted(map(tuple, pending.tolist()))
        for R, seed, word0 in ((1, 3 * k, 0), (2, 3 * k + 1, 1), (4, 3 * k + 2, 2),
                               (8, 3 * k + 3, 3), (TS.K9S_ROWS, 3 * k + 4, 0)):
            e_cand, e_pend, places, e_valid, e_goal, e_best = emulate_rows_form(c, R, seed,
                                                                              word0)
            assert sorted(places) == list(range(len(places)))
            assert sorted(map(tuple, e_pend)) == want_pend
            assert np.array_equal(e_cand, cand[:L].numpy())
            assert e_valid == n_valid and e_goal == goal
            if layout == "packed":
                C = c["st"].C  # the plain version's misses go to trash slots past C
                assert torch.equal(e_best[:C], tab.t_best[:C])
        seen["remote"] += int((cand[:L, 0] < c["ndev"]).sum())
        seen["pending"] += len(want_pend)
    # the steps' lanes hold every kind of candidate row, remote and empty,
    # and pending lanes; the random input's blocks of R >= 2 hold several
    # rows
    assert seen["remote"] > 0 and seen["pending"] > 0
    if name == "random":
        assert max(c["n_sel"] for c in steps) > 2


@pytest.mark.parametrize("name", ["random", "PF08184.fasta", "test2.fasta"])
def test_k9s_mask_codes_are_the_lookups(name):
    """The rows form's mask codes (step.k9s_mask_codes, appended to
    _kernel_params after the constants and the key bit widths) hold, for
    every mask, each pair's entry 2 bx + by in the row's term tables and
    each cube's corner 4 bx + 2 by + bz, as the block form works them out
    from xs, ys and the triangles."""
    problem = random_problem(31, 4, 12, 16) if name == "random" else golden(name)
    st = S.ShardedFrontierSearch(problem, devices=["cpu"] * 2).st
    assert st.M <= TS.K9S_ROWS_MAX_M
    params = TS._kernel_params(st, torch.device("cpu")).long()
    n_const = 4 * st.P + 3 * st.T3 + st.n
    assert params.numel() == n_const + st.n + 2 * st.M
    codes = params[n_const + st.n:].view(st.M, 2)
    xs, ys = params[:st.P], params[st.P:2 * st.P]
    tri = params[4 * st.P:4 * st.P + 3 * st.T3].view(-1, 3)
    for m in range(1, st.M + 1):
        pc, cc = (int(v) for v in codes[m - 1])
        for p in range(st.P):
            assert (pc >> 2 * p) & 3 == 2 * (m >> int(xs[p]) & 1) + (m >> int(ys[p]) & 1)
        assert pc >> 2 * st.P == 0
        for t in range(st.T3):
            x, y, z = (int(v) for v in tri[t])
            assert (cc >> 3 * t) & 7 == 4 * (m >> x & 1) + 2 * (m >> y & 1) + (m >> z & 1)
        assert cc >> 3 * st.T3 == 0
