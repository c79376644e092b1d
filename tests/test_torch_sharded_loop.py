"""The sharded loop of the port (parallel/sharded.py, kernels
csrc/shard_loop.cu) on the CPU: ``consensus_plain`` against JAX's
``_consensus`` run under ``jax.shard_map`` on 4 of conftest's 8 CPU
devices and against ``_route_ragged``'s allowance written in
``jax.numpy``, on seeded random reports (both exchanges, an overflow of
each kind, an empty ring, a stopped run); ``exchange_plain`` against
``LocalMesh.all_to_all_ragged`` and the dense copy loop on the wires of
the plain route, and the exchange kernel's schedule (its one round of A
loads, its flat word range) against ``exchange_plain``; ``walk_advance_plain`` against the host walk, and over
each shard's run by address against the one-buffer form, and the
walk_advance kernel's warp schedule (one load round, ballots, one store
an address) against it at three shapes and every stop; the chunked
driver against the host driver on CPU shards (sig, packed, unpacked;
test2 and PF08184 on 2 and 4 shards; a one-row wire that spills): the
results, the per-shard stats and every table tensor equal, also across
table-overflow retries; the several-card step, four shards grouped into
two or three cards (``_card_groups`` replaced), against the host
driver's rank form on the same mesh; the rank form (``_rank_form``
replaced: a ProcessMesh's step, a card a shard) against the card form;
the consensus of one card's targets over every shard's report; an engine
freed without the cyclic collector; and the driver's choice and
refusals."""
import ctypes
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mpi_pastar_msa_tpu.parallel import sharded as JS
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.parallel import sharded as S
from mpi_pastar_msa_tpu_torch.parallel.mesh import LocalMesh, ProcessMesh
from mpi_pastar_msa_tpu_torch.search import step as TS
from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
from mpi_pastar_msa_tpu_torch.search.bruteforce import optimal_cost
from mpi_pastar_msa_tpu_torch.search.engine import INF, INFP
from walk_cases import WALK_SHAPES, WALK_STOPS, walk_case

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))
AMINO = "ACDEFGHIKLMNPQRSTVWY"


def golden(name):
    return Problem(tuple(r.replace("-", "") for r in GOLD[name]["alignment"]))


# --- the consensus


def random_reports(seed, ndev, cap, layout, case, nb=5, f0=1000):
    """Seeded reports (ndev, R_ROUTE + ndev + 3) int64 as ``_Shard.report``
    gives them: goal (some INF), overflow, K3's five (g max, open,
    selected, reopened, f-min), K11's out (send counts, migrants, carry
    overflow, ring min: a packed word or INFP on sig and packed rows, an f
    or INF on unpacked ones).  ``case``: "plain", "table_ovf" (a shard's
    table overflowed), "carry_ovf" (a shard's ring), "empty_ring" (no ring
    holds a row)."""
    rng = np.random.default_rng(seed)
    rep = np.zeros((ndev, S.R_ROUTE + ndev + 3), np.int64)
    rep[:, S.R_GOAL] = np.where(rng.random(ndev) < 0.5, INF, rng.integers(f0, f0 + 400, ndev))
    rep[:, S.R_NOPEN] = rng.integers(0, 5000, ndev)
    rep[:, S.R_NSEL] = rng.integers(0, 64, ndev)
    rep[:, S.R_REOPEN] = rng.integers(0, 5, ndev)
    rep[:, S.R_FMIN] = np.where(rng.random(ndev) < 0.2, INF, rng.integers(f0, f0 + 300, ndev))
    route = rep[:, S.R_ROUTE:]
    route[:, :ndev] = rng.integers(0, 3 * cap, (ndev, ndev))
    route[np.arange(ndev), np.arange(ndev)] = 0  # nobody routes to itself
    route[:, ndev] = route[:, :ndev].sum(1) - rng.integers(0, cap, ndev).clip(0)
    route[:, ndev] = route[:, ndev].clip(0)
    if layout == "unpacked":
        ring = rng.integers(f0 - 50, f0 + 300, ndev)
        empty = INF
    else:
        ring = ((rng.integers(0, 300, ndev) << nb) | rng.integers(1, 1 << nb, ndev))
        empty = INFP
    route[:, ndev + 2] = np.where(rng.random(ndev) < 0.3, empty, ring)
    if case == "empty_ring":
        route[:, ndev + 2] = empty
    if case == "table_ovf":
        rep[rng.integers(ndev), S.R_OVF] = rng.integers(1, 9)
    if case == "carry_ovf":
        route[rng.integers(ndev), ndev + 1] = rng.integers(1, 9)
    return rep


def jax_consensus(rep, layout, nb, f0):
    """JAX ``_consensus`` on 4 CPU devices, each shard's inputs as its
    step passes them (:439, :692, :854): goal, f-min with the ring's
    carried f, rows selected, and the overflow kind (table in the high
    half, carry in the low).  Returns (goal_g, fmin_g, n_sel_g, table
    overflow shards, carry overflow shards)."""
    ndev = rep.shape[0]
    mesh = Mesh(np.array(jax.devices("cpu")[:ndev]), (JS.AXIS,))
    route = rep[:, S.R_ROUTE:]
    ring = route[:, ndev + 2]
    if layout == "unpacked":
        carry_f = ring
    else:
        carry_f = np.where(ring < INFP, (ring >> nb) + f0, INF)
    fmin_l = np.minimum(rep[:, S.R_FMIN], carry_f).astype(np.int32)
    ovf = (np.minimum(rep[:, S.R_OVF], 1) * (1 << 16) + np.minimum(route[:, ndev + 1], 1))

    def body(goal_l, f_l, nsel, o):
        out = JS._consensus(jnp.int32(INF), goal_l[0], f_l[0], nsel[0], o[0])
        return jnp.stack(out)[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(JS.AXIS),) * 4,
                               out_specs=P(JS.AXIS), check_vma=False))
    out = np.asarray(fn(*(jnp.asarray(x.astype(np.int32)) for x in (
        rep[:, S.R_GOAL], fmin_l, rep[:, S.R_NSEL], ovf))))
    assert (out == out[0]).all()  # every shard agrees
    goal, fmin, nsel, ovf_g = (int(v) for v in out[0])
    return goal, fmin, nsel, ovf_g >> 16, ovf_g & 0xFFFF


def jax_allowance(counts, ndev, cap, ragged):
    """A[i][j], the rows shard i sends shard j: ``_route_ragged``'s
    receiver-capacity truncation (:214-:231) in jax.numpy, or the dense
    wire's cap a destination (``_route_cap``)."""
    Sm = jnp.asarray(counts.astype(np.int32))
    if not ragged:
        return np.asarray(jnp.minimum(Sm, cap))
    before = jnp.cumsum(Sm, axis=0) - Sm
    return np.asarray(jnp.clip(ndev * cap - before, 0, Sm))


def targets_of(ndev, rng, rep=None):
    """Every shard's (counters, step state (some pending lanes already),
    received count, insert flag, index) as the consensus writes them, and
    its report's (counters, state, route out) where it lies; with ``rep``,
    those words as the report says (the consensus then reads them)."""
    targets, reports = [], []
    for me in range(ndev):
        ctr = torch.as_tensor(rng.integers(0, 100, 14), dtype=torch.int64)
        state = torch.zeros(TS.STATE_WORDS, dtype=torch.int64)
        state[TS.STATE_NPEND] = int(rng.integers(0, 500))
        route_out = torch.zeros(ndev + 3, dtype=torch.int32)
        if rep is not None:
            ctr[0], ctr[6] = int(rep[me, S.R_GOAL]), int(rep[me, S.R_OVF])
            state[:5] = torch.from_numpy(rep[me, 2:S.R_ROUTE])
            route_out[:] = torch.from_numpy(rep[me, S.R_ROUTE:].astype(np.int32))
        targets.append((ctr, state, torch.zeros(1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32), me))
        reports.append((ctr, state, route_out))
    return targets, reports


@pytest.mark.parametrize("cards", [1, 2, 3], ids=["one_card", "two_cards", "three_cards"])
@pytest.mark.parametrize("case", ["plain", "table_ovf", "carry_ovf", "empty_ring"])
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("seed", [1, 2])
def test_consensus_plain_equals_jax(seed, layout, ragged, case, cards):
    """consensus_plain against JAX's _consensus and _route_ragged's
    allowance; its telemetry, targets and run flag; with the shards' words
    read where they lie (no report gathered) the same.  ``cards``: the
    targets split over that many cards (shards 0, 1 | 2, 3; 0 | 1, 2 | 3),
    each card's consensus over every shard's report with its own vector,
    run flag and targets: every card's vector and flag equal the one card's,
    and each target the same words."""
    ndev, cap, nb, f0, ccar = 4, 40, 5, 1000, 100
    rep = random_reports(seed, ndev, cap, layout, case, nb, f0)
    rng = np.random.default_rng(seed + 10)
    targets, _ = targets_of(ndev, rng)
    before = [(c.clone(), s.clone()) for c, s, *_ in targets]
    cons = S.fresh_cons(ndev, "cpu")
    cons[S.C_STEPS], cons[S.C_WIRE], cons[S.C_MIGR], cons[S.C_PEAK] = 7, 100, 90, 5
    cons[S.C_HEAD:S.C_HEAD + 4 * ndev] = torch.as_tensor(rng.integers(0, 50, 4 * ndev))
    cons0 = cons.clone()
    groups = {1: [[0, 1, 2, 3]], 2: [[0, 1], [2, 3]], 3: [[0], [1, 2], [3]]}[cards]
    runs = []
    for g in groups:
        mine, run = cons0.clone(), torch.ones(1, dtype=torch.int32)
        S.consensus_plain(torch.from_numpy(rep), ndev, cap, ragged, layout, nb, f0, ccar, run,
                          [targets[me] for me in g], mine)
        runs.append((mine, run))
    for mine, run in runs[1:]:
        assert torch.equal(mine, runs[0][0]) and torch.equal(run, runs[0][1])
    cons, run = runs[0]
    goal, fmin, nsel, tovf, covf = jax_consensus(rep, layout, nb, f0)
    c = cons.numpy()
    assert (c[S.C_GOAL], c[S.C_FMIN], c[S.C_NSEL], c[S.C_TOVF], c[S.C_COVF]) == (
        goal, fmin, nsel, tovf, covf)
    counts = rep[:, S.R_ROUTE:S.R_ROUTE + ndev]
    A = jax_allowance(counts, ndev, cap, ragged)
    assert np.array_equal(A, S.route_sizes(counts, ndev, cap, ragged))
    assert np.array_equal(S.cons_sizes(c, ndev), A)
    # the telemetry: the host loop's sums, on the same report
    per0 = cons0.numpy()[S.C_HEAD:S.C_HEAD + 4 * ndev].reshape(ndev, 4)
    per = c[S.C_HEAD:S.C_HEAD + 4 * ndev].reshape(ndev, 4)
    route = rep[:, S.R_ROUTE:]
    assert np.array_equal(per[:, 0], per0[:, 0] + rep[:, S.R_NSEL])
    assert np.array_equal(per[:, 1], per0[:, 1] + rep[:, S.R_REOPEN])
    assert np.array_equal(per[:, 2], rep[:, S.R_NOPEN])
    assert np.array_equal(per[:, 3], per0[:, 3] + route[:, ndev])
    assert c[S.C_STEPS] == 8 and c[S.C_WIRE] == 100 + A.sum()
    assert c[S.C_MIGR] == 90 + route[:, ndev].sum()
    spill = np.minimum(np.maximum(counts.sum(1) - A.sum(1), 0), ccar)
    assert c[S.C_PEAK] == max(5, spill.max())
    stop = tovf > 0 or covf > 0
    assert stop == (case in ("table_ovf", "carry_ovf"))
    assert int(run[0]) == c[S.C_RUN] == int(not stop and fmin < goal)
    for (ctr, state, recv, go, me), (c0, s0) in zip(targets, before):
        if stop:  # the step stops before the exchange and the insert
            assert int(go[0]) == 0 and torch.equal(ctr, c0) and torch.equal(state, s0)
            continue
        assert int(go[0]) == 1 and int(recv[0]) == A[:, me].sum()
        assert int(ctr[0]) == goal and torch.equal(ctr[1:], c0[1:])
        assert int(state[TS.STATE_FMIN]) == fmin and int(state[TS.STATE_NSEL]) == nsel
        assert int(state[TS.STATE_NPEND]) == int(s0[TS.STATE_NPEND]) + A[:, me].sum()
    # a stopped run: nothing changes
    run.zero_()
    snap = [t.clone() for tg in targets for t in tg[:4]] + [cons.clone()]
    S.consensus_plain(torch.from_numpy(rep), ndev, cap, ragged, layout, nb, f0, ccar, run,
                      targets, cons)
    assert all(torch.equal(a, b) for a, b in
                zip(snap, [t for tg in targets for t in tg[:4]] + [cons]))
    # no report gathered: each shard's words where they lie (as rows, or
    # as its counters, state and route out) give the same consensus
    tg2, reports = targets_of(ndev, np.random.default_rng(seed + 10), rep)
    assert torch.equal(S.gather_reports(reports), torch.from_numpy(rep))
    rows = [S.report_row(*r) for r in reports]
    for form in (reports, rows):
        cons2, run2 = cons0.clone(), torch.ones(1, dtype=torch.int32)
        S.consensus_plain(form, ndev, cap, ragged, layout, nb, f0, ccar, run2,
                          [tg2[me] for me in groups[-1]], cons2)
        assert torch.equal(cons2, cons) and torch.equal(run2, run.fill_(int(c[S.C_RUN])))


def test_consensus_sig_ring_and_goal_stop():
    """The sig layout's ring min is a packed word, as packed's; fmin_g >=
    goal_g clears the run flag but not the insert's flags (the insert
    still runs, the next step does not)."""
    ndev, cap, nb, f0 = 2, 8, 4, 500
    rep = np.zeros((ndev, S.R_ROUTE + ndev + 3), np.int64)
    rep[:, S.R_GOAL] = [600, INF]
    rep[:, S.R_FMIN] = [650, 700]
    rep[:, S.R_ROUTE + ndev + 2] = [INFP, (90 << nb) | 3]  # carried f 590
    targets, _ = targets_of(ndev, np.random.default_rng(0))
    cons, run = S.fresh_cons(ndev, "cpu"), torch.ones(1, dtype=torch.int32)
    S.consensus_plain(torch.from_numpy(rep), ndev, cap, False, "sig", nb, f0, 10, run, targets,
                      cons)
    assert (int(cons[S.C_GOAL]), int(cons[S.C_FMIN])) == (600, 590) == jax_consensus(
        rep, "sig", nb, f0)[:2]
    assert int(run[0]) == 1 and all(int(t[3][0]) == 1 for t in targets)
    rep[1, S.R_ROUTE + ndev + 2] = INFP
    S.consensus_plain(torch.from_numpy(rep), ndev, cap, False, "sig", nb, f0, 10, run, targets,
                      cons)
    assert int(cons[S.C_FMIN]) == 650 >= int(cons[S.C_GOAL])
    assert int(run[0]) == 0 and int(cons[S.C_RUN]) == 0
    assert all(int(t[3][0]) == 1 for t in targets)


# --- the exchange


def route_wires(seed, ndev, L, ccar, cap, ragged):
    """Every shard's wire from the plain route on random rows, and A."""
    rng = np.random.default_rng(seed)
    cand = np.zeros((ndev, L, 4), np.int32)
    for me in range(ndev):
        dest = rng.integers(0, ndev, L)
        dest[(dest == me) | (rng.random(L) > 0.6)] = ndev
        cand[me] = np.stack([dest, rng.integers(0, 1 << 20, L), rng.integers(0, 1 << 20, L),
                             rng.integers(0, 1 << 30, L)], 1)
    carry = torch.tensor([[ndev, INFP, 0, -1]], dtype=torch.int32).repeat(ccar, 1)
    outs = [S.route_plain(torch.from_numpy(cand[i]), L, carry, ndev, i, cap)
            for i in range(ndev)]
    counts = np.stack([o[2][:ndev].numpy() for o in outs])
    if ragged:
        Sm = torch.from_numpy(counts.astype(np.int32))
        outs = [S.route_plain(torch.from_numpy(cand[i]), L, carry, ndev, i, cap, Sm)
                for i in range(ndev)]
    return [o[0] for o in outs], S.route_sizes(counts, ndev, cap, ragged)


def emu_exchange(cons, ndev, cap, ragged, R, xtab, wires, pends, rng, blocks=16, threads=256,
                 per=2, received=False):
    """csrc/shard_loop.cu's exchange with its schedule emulated, from the
    address table ``exchange_table`` built (the host memory the C entry
    reads; ``wires`` and ``pends`` stand behind its addresses): per
    receiver block, warp 0's one round of A loads (A[i][r], ragged A[i][:r])
    and its prefix sums, then a row a thread over the flat range of rows,
    each thread's ``per`` rows loaded before any is stored, the threads of
    a receiver's row of blocks in a random order; ``received``: sender i's
    dense rows from row i cap of its entry (a rank's received blocks)."""
    A = S.cons_sizes(cons, ndev).numpy()
    tab = xtab.tolist()
    by_ptr = {t.data_ptr(): t for t in list(wires) + list(pends)}
    assert tab[:ndev] == [w.data_ptr() for w in wires]
    pw = wires[0].shape[1]
    for b in range(len(pends)):
        pend_ptr, flag_ptr, r = tab[ndev + 3 * b: ndev + 3 * b + 3]
        if not ctypes.c_int32.from_address(flag_ptr).value:
            continue
        n = [int(A[i][r]) for i in range(ndev)]
        src = [int(A[i][:r].sum()) if ragged else (i if received else r) * cap
               for i in range(ndev)]
        at = [0] + list(np.cumsum(n))  # the shuffles' inclusive scan, shifted
        rows = at[ndev]
        dst = by_ptr[pend_ptr]
        base = R - rows
        stride = blocks * threads
        for t in rng.permutation(stride):
            for q0 in range(int(t), rows, per * stride):
                qs = [q for q in (q0 + u * stride for u in range(per)) if q < rows]
                vals = []
                for q in qs:
                    s = 0
                    while at[s + 1] <= q:
                        s += 1
                    vals.append(wires[s][src[s] + q - at[s]].clone())
                for q, v in zip(qs, vals):
                    dst[base + q] = v


@pytest.mark.parametrize("ndev,pw,cap,recv_me,ragged", [
    (4, 7, 50, [0, 1, 2, 3], True), (4, 7, 50, [3, 1], False), (8, 3, 20, list(range(8)), True),
    (31, 7, 6, list(range(0, 31, 3)), True), (31, 9, 4, list(range(31)), False),
    (4, 16, 30, [2, 0, 3], False)])
def test_exchange_schedule_equals_plain(ndev, pw, cap, recv_me, ragged):
    """The exchange kernel's schedule (emu_exchange) against exchange_plain
    on random allowances of the route's shape, a receiver's flag 0, a
    receiver with its flag at 1 that gets rows at every row width, and
    (with three receivers or more) one that gets 0 rows from every
    sender."""
    rng = np.random.default_rng(ndev * 100 + pw)
    counts = rng.integers(0, 3 * cap, (ndev, ndev))
    if len(recv_me) >= 3:
        counts[:, recv_me[-1]] = 0  # nothing for the last receiver
    A = S.route_sizes(counts, ndev, cap, ragged)
    assert A[:, recv_me[1]].sum() > 0  # the second receiver: flag 1 and rows
    assert len(recv_me) < 3 or A[:, recv_me[-1]].sum() == 0
    R = ndev * cap
    cons = S.fresh_cons(ndev, "cpu")
    S.cons_sizes(cons, ndev)[:] = torch.from_numpy(A)
    wires = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (max(R, 3 * cap * ndev), pw))
                              .astype(np.int32)) for _ in range(ndev)]
    outs = []
    for emulated in (True, False):
        pends = [torch.full((R + 16, pw), -5, dtype=torch.int32) for _ in recv_me]
        flags = [torch.ones(1, dtype=torch.int32) for _ in recv_me]
        flags[0].zero_()
        if emulated:
            xtab = S.exchange_table(wires, pends, flags, recv_me)
            assert xtab.dtype == torch.int64 and xtab.numel() == ndev + 3 * len(recv_me)
            emu_exchange(cons, ndev, cap, ragged, R, xtab, wires, pends, rng)
        else:
            S.exchange_plain(cons, ndev, cap, ragged, R, wires, pends, flags, recv_me)
        outs.append(pends)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert (outs[0][0] == -5).all() and (outs[0][1] != -5).any()
    assert len(recv_me) < 3 or (outs[0][-1] == -5).all()


@pytest.mark.parametrize("ndev,pw", [(2, 7), (2, 13), (4, 7), (4, 13)])
def test_exchange_received_schedule_equals_plain(ndev, pw):
    """The exchange of the rank form: each rank r's received blocks (the
    dense all-to-all of every sender's wire, ``LocalMesh.all_to_all``),
    named once a sender, with ``received`` (sender i's rows at row i cap):
    the kernel's schedule (emu_exchange) and exchange_plain equal, and
    equal to exchange_plain over the senders' own wires (the card form's
    reading); ragged with ``received`` is refused."""
    rng = np.random.default_rng(ndev * 100 + pw)
    cap = 40
    A = S.route_sizes(rng.integers(0, 2 * cap, (ndev, ndev)), ndev, cap, False)
    R = ndev * cap
    cons = S.fresh_cons(ndev, "cpu")
    S.cons_sizes(cons, ndev)[:] = torch.from_numpy(A)
    wires = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (R + 3 * cap, pw))
                              .astype(np.int32)) for _ in range(ndev)]
    recv = LocalMesh(["cpu"] * ndev).all_to_all([w[:R].view(ndev, cap, pw) for w in wires])
    for r in range(ndev):
        got = recv[r].view(R, pw)
        outs = []
        for way in ("emulated", "plain", "senders"):
            pend = torch.full((R + 8, pw), -5, dtype=torch.int32)
            flag = torch.ones(1, dtype=torch.int32)
            if way == "emulated":
                xtab = S.exchange_table([got] * ndev, [pend], [flag], [r])
                emu_exchange(cons, ndev, cap, False, R, xtab, [got] * ndev, [pend], rng,
                             received=True)
            elif way == "plain":
                S.exchange_plain(cons, ndev, cap, False, R, [got] * ndev, [pend], [flag], [r],
                                 received=True)
            else:
                S.exchange_plain(cons, ndev, cap, False, R, wires, [pend], [flag], [r])
            outs.append(pend)
        assert A[:, r].sum() > 0 and (outs[0][R - int(A[:, r].sum()):R] != -5).all()
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError):
        S.exchange_plain(cons, ndev, cap, True, R, wires, [pend], [flag], [0], received=True)
    with pytest.raises(ValueError):
        S.exchange_cuda(cons, ndev, cap, True, R, pw, xtab, received=True)


def test_exchange_table_refuses():
    w = [torch.zeros((8, 3), dtype=torch.int32) for _ in range(2)]
    flag = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):  # rows of another width
        S.exchange_table(w, [torch.zeros((8, 4), dtype=torch.int32)], [flag], [0])
    with pytest.raises(ValueError):  # a receiver that is no shard
        S.exchange_table(w, [w[0]], [flag], [2])
    with pytest.raises(ValueError):  # an int64 flag
        S.exchange_table(w, [w[0]], [flag.long()], [0])
    with pytest.raises(ValueError):  # the table on the card, not in host memory
        S.exchange_cuda(S.fresh_cons(2, "cpu"), 2, 4, True, 8, 3, torch.zeros(3))
    xtab = S.exchange_table(w, [w[0]], [flag], [0])
    with pytest.raises(ValueError):  # a row wider than the kernel copies
        S.exchange_cuda(S.fresh_cons(2, "cpu"), 2, 4, True, 8, S.EXCHANGE_ROW_WORDS + 1, xtab)


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("seed,cap", [(1, 3), (2, 50), (3, 1000)])
def test_exchange_plain_equals_mesh(seed, cap, ragged):
    """Each receiver's rows, before row R of its pending list, as the
    host-sized exchange moves them (``all_to_all_ragged``; dense: the
    all_to_all of cap-row blocks and the copy loop); rows outside the
    received region and a receiver whose insert flag is 0 untouched."""
    ndev, L, ccar, pw = 4, 120, 120, 3
    wires, A = route_wires(seed, ndev, L, ccar, cap, ragged)
    R = ndev * cap
    cons = S.fresh_cons(ndev, "cpu")
    S.cons_sizes(cons, ndev)[:] = torch.from_numpy(A)
    n_recv = A.sum(0)
    pends = [torch.full((R + 10, pw), -7, dtype=torch.int32) for _ in range(ndev)]
    flags = [torch.ones(1, dtype=torch.int32) for _ in range(ndev)]
    flags[2].zero_()
    S.exchange_plain(cons, ndev, cap, ragged, R, wires, pends, flags, list(range(ndev)))
    mesh = LocalMesh(["cpu"] * ndev)
    want = [torch.full((int(n),), 0, dtype=torch.int32).new_empty((int(n), pw))
            for n in n_recv]
    if ragged:
        off = np.cumsum(A, axis=1) - A
        mesh.all_to_all_ragged(wires, off, A, want)
    else:
        blocks = mesh.all_to_all([w[:ndev * cap].view(ndev, cap, pw) for w in wires])
        for j, blk in enumerate(blocks):
            at = 0
            for i in range(ndev):
                want[j][at:at + A[i][j]] = blk[i, :A[i][j]]
                at += A[i][j]
    for j in range(ndev):
        lo = R - int(n_recv[j])
        if j == 2:
            assert (pends[j] == -7).all()
            continue
        assert torch.equal(pends[j][lo:R], want[j])
        assert (pends[j][:lo] == -7).all() and (pends[j][R:] == -7).all()


# --- the walk


def test_walk_advance_plain_rounds():
    """Three rounds by hand: a run of masks in one shard, the coordinate
    stepped back, the walk's flag cleared when a round emits nothing."""
    n, hops = 3, 4
    params = torch.tensor([3, 2, 2, 8, 8, 8], dtype=torch.int32)
    masks = torch.zeros(6 + hops, dtype=torch.int32)
    wst, wrun = torch.zeros(2, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    wout = torch.zeros((2, hops + n + 1), dtype=torch.int32)
    wout[1, :3] = torch.tensor([7, 1, 3])
    S.walk_advance_plain(wout, hops, n, params, masks, wst, wrun)
    assert params[:n].tolist() == [0, 0, 1] and wst.tolist() == [3, 1] and int(wrun[0]) == 1
    wout.zero_()
    wout[0, 0] = 4
    S.walk_advance_plain(wout, hops, n, params, masks, wst, wrun)
    assert params[:n].tolist() == [0, 0, 0] and int(wrun[0]) == 0
    assert masks[:4].tolist() == [7, 1, 3, 4] and wst.tolist() == [4, 2]
    S.walk_advance_plain(wout, hops, n, params, masks, wst, wrun)  # stopped: nothing
    assert wst.tolist() == [4, 2]
    wrun.fill_(1)
    params[:n] = torch.tensor([1, 0, 0])
    wout.zero_()
    S.walk_advance_plain(wout, hops, n, params, masks, wst, wrun)  # no progress
    assert int(wrun[0]) == 0 and wst.tolist() == [4, 3]


@pytest.mark.parametrize("seed", [3, 4])
def test_walk_advance_plain_rows_by_address(seed):
    """walk_advance_plain over each shard's run where it lies (a sequence
    of tensors, as the several-card walk reads them) against the same runs
    as rows of one buffer, and two cards' copies of the walk state advanced
    from the same runs against each other: the same masks, coordinate,
    counts and flag, round after round until the flag clears."""
    rng = np.random.default_rng(seed)
    n, hops, ndev = 4, 8, 3
    final = [30, 28, 31, 29]
    states = [[torch.tensor(final + [9] * n, dtype=torch.int32),
               torch.zeros(sum(final) + hops, dtype=torch.int32),
               torch.zeros(2, dtype=torch.int32), torch.ones(1, dtype=torch.int32)]
              for _ in range(3)]
    for _ in range(100):
        coord = states[0][0][:n].tolist()
        wout = torch.zeros((ndev, hops + n + 1), dtype=torch.int32)
        owner = int(rng.integers(ndev))
        for h in range(int(rng.integers(1, hops + 1))):
            live = [d for d in range(n) if coord[d] > 0]
            if not live:
                break
            pick = rng.random(len(live)) < 0.7
            pick[int(rng.integers(len(live)))] = True
            m = sum(1 << d for d, p in zip(live, pick) if p)
            wout[owner, h] = m
            coord = [coord[d] - ((m >> d) & 1) for d in range(n)]
        rows = [wout[i].clone() for i in range(ndev)]
        S.walk_advance_plain(wout, hops, n, *states[0])
        S.walk_advance_plain(rows, hops, n, *states[1])
        S.walk_advance_plain(list(reversed(rows))[::-1], hops, n, *states[2])
        for other in states[1:]:
            assert all(torch.equal(a, b) for a, b in zip(states[0], other))
    assert int(states[0][3][0]) == 0 and int(states[0][2][0]) > 0


def emu_walk_advance(wtab, ndev, hops, n, params, masks, wst, wrun):
    """csrc/shard_loop.cu's walk_advance with its warp's schedule emulated,
    from the address table ``run_table`` built (the host memory the C entry
    copies into the launch's parameters; each run read through it): one
    round of loads over the 32 lanes (the flag and the counts on every
    lane, lane d's coordinate word for d < N, lane h's word of every run
    for h < hops), then ballots as 32-bit words and their popcounts (the
    masks' places a prefix popcount, dimension d's decrement one ballot
    kept by lane d, ``any`` a vote), then the stores, each address at most
    once; the arrays in place."""
    lanes = np.arange(32)
    popc = lambda w: bin(int(w)).count("1")
    ballot = lambda pred: sum(1 << int(l) for l in lanes[pred])
    # the load round
    go = [int(wrun[0])] * 32
    nn = [int(wst[0])] * 32
    rounds = int(wst[1])  # lane 0's
    p = np.array([int(params[l]) if l < n else 0 for l in lanes], np.int64)
    v = np.zeros((32, ndev), np.int64)
    for s_, addr in enumerate(wtab.tolist()[:ndev]):
        for h in range(hops):
            v[h, s_] = ctypes.c_int32.from_address(addr + 4 * h).value
    m = v.sum(axis=1)
    pos = m > 0
    b = ballot(pos)
    emitted = popc(b)
    at = np.array([nn[l] + popc(b & ((1 << l) - 1)) for l in lanes])
    dec = np.zeros(32, np.int64)
    for d in range(n):
        dec[d] = popc(ballot(pos & (((m >> d) & 1) == 1)))
    c = p - dec
    anyv = ballot((lanes < n) & (c != 0)) != 0
    if go[0] == 0:
        return
    stores = []
    for l in lanes:
        if pos[l] and at[l] < masks.size:
            stores.append(("masks", int(at[l]), int(m[l])))
        if l < n:
            stores.append(("params", int(l), int(c[l])))
    stores += [("wst", 0, nn[0] + emitted), ("wst", 1, rounds + 1)]
    if emitted == 0 or not anyv or nn[0] + emitted + hops > masks.size:
        stores.append(("wrun", 0, 0))
    places = [(a, i) for a, i, _ in stores]
    assert len(places) == len(set(places)), "an address stored twice"
    arrays = dict(masks=masks, params=params, wst=wst, wrun=wrun)
    for a, i, val in stores:
        arrays[a][i] = val


@pytest.mark.parametrize("stop", WALK_STOPS)
@pytest.mark.parametrize("n,hops,ndev", WALK_SHAPES)
def test_walk_advance_schedule_equals_plain(n, hops, ndev, stop):
    """The walk_advance kernel's schedule (emu_walk_advance, its runs read
    by address from run_table) against walk_advance_plain, round after
    round from seeded runs until the walk's flag clears, and two rounds
    more (nothing changes): masks, coordinate, counts and flag equal after
    every round; each case ends at the stop it is built for."""
    state, runs = walk_case(7 * n + hops + ndev, n, hops, ndev, stop)
    emu = [a.copy() for a in state]
    plain = [torch.from_numpy(a.copy()) for a in state]
    bufs = [torch.zeros(hops + n + 1, dtype=torch.int32) for _ in range(ndev)]
    wtab = S.run_table(bufs, hops, n)
    rounds = 0
    for out in runs + [np.zeros_like(runs[0])] * 2:
        for buf, row in zip(bufs, out):
            buf.copy_(torch.from_numpy(row))
        live = int(plain[3][0])
        emu_walk_advance(wtab, ndev, hops, n, *emu)
        S.walk_advance_plain(bufs, hops, n, *plain)
        rounds += live
        for a, b in zip(emu, plain):
            assert np.array_equal(a, b.numpy())
    params, masks, wst, wrun = plain
    coord = params[:n].tolist()
    assert int(wrun[0]) == 0 and int(wst[1]) == rounds
    if stop == "off":
        assert rounds == 0 and all(np.array_equal(a, b.numpy()) for a, b in zip(state, plain))
    elif stop == "origin":
        assert not any(coord) and int(wst[0]) == int((masks > 0).sum()) > 0
    elif stop == "empty":
        assert any(coord) and rounds == 3
    elif stop == "room":
        assert any(coord) and rounds == 2 and int(wst[0]) == 2 * hops
    else:
        assert any(coord) and rounds == 1 and int(wst[0]) == 2 * hops - hops // 2 + hops
        assert int((masks[state[2][0]:] > 0).sum()) == hops // 2


@pytest.mark.parametrize("form", ["launch", "rounds"])
@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_walk_loop_equals_host_walk(layout, form):
    """The chunked driver's walk on every shard's finished table of one
    card against the host walk (``_walk``): the same masks and rounds; a
    coordinate no shard holds raises in both.  Its one-launch form (one
    card's default: ``walk_shards_plain``, one read) and its round form
    (WALK_ROUNDS rounds a read, walk_advance_plain), which several cards
    take, both on the same one card."""
    eng = S.ShardedFrontierSearch(golden("PF08184.fasta"), devices=["cpu"] * 4, layout=layout,
                                  capacity=1 << 14, driver="host")
    res = eng.run()
    assert eng.walk_form() == "launch"
    masks, rounds = eng._walk(eng.shards)
    got, got_rounds, reads = eng._walk_loop(eng.shards, form=form)
    assert got == masks and got_rounds == rounds == eng.last_stats["walk_rounds"]
    assert reads == (1 if form == "launch" else -(-rounds // S.WALK_ROUNDS))
    assert len(res.closed) == len(masks)
    eng.problem = Problem(tuple(s + "W" for s in eng.problem.seqs))
    with pytest.raises(RuntimeError, match="did not reach the origin"):
        eng._walk(eng.shards)
    with pytest.raises(RuntimeError, match="did not reach the origin"):
        eng._walk_loop(eng.shards, form=form)


# --- the chunked driver against the host driver


def shard_words(eng):
    """Every tensor a shard's step leaves that does not depend on the order
    lanes run in: the table, counters, step state, both rings and which is
    current, the received count, the insert flag, the route's out, the
    candidate rows, the wire, the rings' live lengths and the route's
    count buffers; then the consensus vector."""
    out = []
    for sh in eng.shards:
        out += [getattr(sh.tab, f) for f in sh.tab.__dataclass_fields__]
        out += [sh.ctr, sh.state[:TS.STATE_CNT], *sh.rings, torch.tensor(sh.cur), sh.recv, sh.go,
                sh.route_out, sh.cand, sh.wire, sh.ring_len, sh.tally]
    return out + [eng.cards[0].cons]


def both_drivers(problem, ndev, **kw):
    runs = []
    for driver in ("chunked", "host"):
        eng = S.ShardedFrontierSearch(problem, devices=["cpu"] * ndev, driver=driver, **kw)
        runs.append((eng, eng.run()))
    return runs


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
@pytest.mark.parametrize("name", ["PF08184.fasta", "test2.fasta"])
def test_chunked_equals_host_driver(name, layout, ndev):
    """Chunks of 16 steps (the run stops inside one) against one step a
    read: the result, the per-shard stats and every table tensor equal,
    with no tolerance (all int32 and int64); one read a chunk."""
    (ce, cr), (he, hr) = both_drivers(golden(name), ndev, layout=layout, capacity=1 << 14,
                                      chunk_steps=16,
                                      exchange="ragged" if ndev == 4 else "dense")
    assert cr.g == hr.g == GOLD[name]["optimal_g"]
    assert build_alignment(ce.problem, cr.closed) == GOLD[name]["alignment"]
    assert (cr.closed, cr.steps, cr.shard_stats, cr.nodes_migrated) == (
        hr.closed, hr.steps, hr.shard_stats, hr.nodes_migrated)
    for a, b in zip(shard_words(ce), shard_words(he)):
        assert torch.equal(a, b)
    cs, hs = ce.last_stats, he.last_stats
    assert (cs["driver"], hs["driver"]) == ("chunked", "host")
    assert cs["host_reads"] == -(-cr.steps // 16) and hs["host_reads"] == hr.steps
    for k in ("steps", "wire_rows", "migrated", "peak_carry", "walk_rounds"):
        assert cs[k] == hs[k], k


#: four shards of one device split into two cards, and into three
SPLITS = {"two_cards": [[0, 1], [2, 3]], "three_cards": [[0], [1, 2], [3]]}


@pytest.mark.parametrize("exchange", ["ragged", "dense"])
@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
@pytest.mark.parametrize("name", ["PF08184.fasta", "test2.fasta"])
def test_split_cards_chunked_equals_host_driver(monkeypatch, name, layout, exchange):
    """Four CPU shards grouped into two cards (``_card_groups`` replaced):
    the chunked driver runs the several-card step (each card pulls the
    other's coordinates, partials and send counts into its own buffers,
    snapshots its shards' reports, runs the consensus over every shard's
    report and the exchange for its own receivers) in chunks of 16, the
    host driver the rank form on the same mesh (a card a shard: the
    mesh's collectives, the exchange sized on the card, ragged over every
    rank's wire by address).  The result, the per-shard stats and every
    table word equal, with no tolerance; the alignment is the golden one
    (JAX's); one host read a chunk, and one a step under the host driver;
    both cards' consensus vectors equal."""
    monkeypatch.setattr(S, "_card_groups", lambda devices: SPLITS["two_cards"])
    (ce, cr), (he, hr) = both_drivers(golden(name), 4, layout=layout, capacity=1 << 14,
                                      chunk_steps=16, exchange=exchange)
    assert [len(c.shards) for c in ce.cards] == [2, 2]
    assert [len(c.shards) for c in he.cards] == [1, 1, 1, 1]
    assert ce.card_form and not he.card_form
    assert cr.g == hr.g == GOLD[name]["optimal_g"]
    assert build_alignment(ce.problem, cr.closed) == GOLD[name]["alignment"]
    assert (cr.closed, cr.steps, cr.shard_stats, cr.nodes_migrated) == (
        hr.closed, hr.steps, hr.shard_stats, hr.nodes_migrated)
    for a, b in zip(shard_words(ce), shard_words(he)):
        assert torch.equal(a, b)
    assert torch.equal(ce.cards[0].cons, ce.cards[1].cons)
    cs, hs = ce.last_stats, he.last_stats
    assert cs["host_reads"] == -(-cr.steps // 16)
    assert hs["host_reads"] == hr.steps
    assert cs["walk_form"] == "rounds"  # two cards: the device loop of rounds
    assert cs["walk_reads"] == -(-cs["walk_rounds"] // S.WALK_ROUNDS)
    for k in ("steps", "wire_rows", "migrated", "peak_carry", "walk_rounds"):
        assert cs[k] == hs[k], k


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
@pytest.mark.parametrize("name", ["PF08184.fasta", "test2.fasta"])
def test_rank_form_equals_card_form(monkeypatch, name, layout):
    """Four CPU shards of a LocalMesh in the rank form (``_rank_form``
    replaced: a card a shard, the mesh's collectives as copies into each
    rank's buffers, the consensus over each rank's gathered reports, the
    dense exchange from each rank's received wire blocks, the walk's runs
    summed by the mesh), the chunked driver in chunks of 16, against the
    card form's chunked run of the same engine arguments: the result, the
    per-shard stats, every table word and every rank's consensus vector
    equal, with no tolerance; the golden alignment; one host read a
    chunk and a walk read every WALK_ROUNDS rounds."""
    p = golden(name)
    kw = dict(layout=layout, capacity=1 << 14, chunk_steps=16, exchange="dense",
              driver="chunked")
    card = S.ShardedFrontierSearch(p, devices=["cpu"] * 4, **kw)
    cr = card.run()
    monkeypatch.setattr(S, "_rank_form", lambda mesh: True)
    rank = S.ShardedFrontierSearch(p, devices=["cpu"] * 4, **kw)
    rr = rank.run()
    assert card.card_form and not rank.card_form
    assert [len(c.shards) for c in rank.cards] == [1, 1, 1, 1]
    assert rr.g == cr.g == GOLD[name]["optimal_g"]
    assert build_alignment(rank.problem, rr.closed) == GOLD[name]["alignment"]
    assert (rr.closed, rr.steps, rr.shard_stats, rr.nodes_migrated) == (
        cr.closed, cr.steps, cr.shard_stats, cr.nodes_migrated)
    for a, b in zip(shard_words(rank), shard_words(card)):
        assert torch.equal(a, b)
    assert all(torch.equal(c.cons, rank.cards[0].cons) for c in rank.cards)
    rs, cs = rank.last_stats, card.last_stats
    assert rs["host_reads"] == cs["host_reads"] == -(-rr.steps // 16)
    assert rs["walk_form"] == "rounds" and cs["walk_form"] == "launch"
    assert rs["walk_reads"] == -(-rs["walk_rounds"] // S.WALK_ROUNDS) and cs["walk_reads"] == 1
    for k in ("steps", "wire_rows", "migrated", "peak_carry", "walk_rounds"):
        assert rs[k] == cs[k], k


def spilling_input():
    """A random input whose frontier is wide, and the engine arguments
    under which its one-row wire spills into the carry rings."""
    rs = np.random.RandomState(31)
    p = Problem(tuple("".join(rs.choice(list(AMINO), size=rs.randint(12, 17)))
                      for _ in range(4)))
    return p, dict(exchange_cap=1, hash_type="FZORDER", hash_shift=0, batch=16, chunk_steps=8)


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("layout", ["sig", "packed"])
@pytest.mark.parametrize("name", ["PF08184.fasta", "test2.fasta", "spilling"])
def test_rank_form_ragged_equals_host_driver_and_card_form(monkeypatch, name, layout, ndev):
    """The ragged exchange in the rank form (``_rank_form`` replaced: a
    card a shard, every rank's exchange reading the senders' wires by
    address, the mesh's ``map_peers``, as a ProcessMesh of cards reads
    them through CUDA IPC) on ``ndev`` CPU shards: the chunked driver
    against the host driver in the same form and against the card form's
    chunked run, on PF08184, test2 (chunks of 16) and a one-row wire that
    spills into the carry rings (chunks of 8): the golden g and alignment
    (the brute-force optimum on the random input), the result, the
    per-shard stats and every table word equal, with no tolerance; every
    rank's consensus vector the same; the chunked runs one host read a
    chunk, the host driver one a step, and no step reads the host."""
    if name == "spilling":
        p, kw = spilling_input()
        want = optimal_cost(p, HPairHeuristic.build(p, "cpu"))
    else:
        p, kw, want = golden(name), dict(capacity=1 << 14, chunk_steps=16), None
    kw.update(layout=layout, exchange="ragged")
    card = S.ShardedFrontierSearch(p, devices=["cpu"] * ndev, driver="chunked", **kw)
    cr = card.run()
    monkeypatch.setattr(S, "_rank_form", lambda mesh: True)

    def host_sized(self, shards):
        raise AssertionError("the ragged exchange was sized on the host")

    monkeypatch.setattr(S.ShardedFrontierSearch, "_exchange_host", host_sized)
    runs = []
    for driver in ("chunked", "host"):
        eng = S.ShardedFrontierSearch(p, devices=["cpu"] * ndev, driver=driver, **kw)
        runs.append((eng, eng.run()))
    (ce, rr), (he, hr) = runs
    assert card.card_form and not ce.card_form and not he.card_form
    assert ce.exchange == he.exchange == "ragged" and ce.cards[0].recv is None
    assert [len(c.shards) for c in ce.cards] == [1] * ndev
    assert all(len(c.wires) == ndev for c in ce.cards)
    if want is None:
        assert rr.g == GOLD[name]["optimal_g"]
        assert build_alignment(ce.problem, rr.closed) == GOLD[name]["alignment"]
    else:
        assert rr.g == want and ce.last_stats["peak_carry"] > 0
    for eng, res in ((he, hr), (card, cr)):
        assert (res.g, res.closed, res.steps, res.shard_stats, res.nodes_migrated) == (
            rr.g, rr.closed, rr.steps, rr.shard_stats, rr.nodes_migrated)
        for a, b in zip(shard_words(ce), shard_words(eng)):
            assert torch.equal(a, b)
    assert all(torch.equal(c.cons, ce.cards[0].cons) for c in ce.cards + he.cards)
    cs, hs = ce.last_stats, he.last_stats
    chunk = kw["chunk_steps"]
    assert cs["host_reads"] == card.last_stats["host_reads"] == -(-rr.steps // chunk)
    assert hs["host_reads"] == hr.steps
    for k in ("steps", "wire_rows", "migrated", "peak_carry", "walk_rounds"):
        assert cs[k] == hs[k] == card.last_stats[k], k


def test_rank_form_refusals_and_choice(monkeypatch):
    """The rank form's driver rules on a LocalMesh (``_rank_form``
    replaced), as on a ProcessMesh of cards: the chunked driver under
    either exchange (auto: dense on the CPU, ragged on cards, as JAX's),
    the ragged one reading every rank's wire by address; over cards
    without peer access the ragged exchange maps nothing, so auto takes
    the host driver and chunked raises; a chunked rank form over two
    devices raises when it runs; ranks that end with different consensus
    vectors raise."""
    monkeypatch.setattr(S, "_rank_form", lambda mesh: True)
    p = golden("PF08184.fasta")
    eng = S.ShardedFrontierSearch(p, devices=["cpu"] * 2)
    assert (eng.driver, eng.exchange) == ("chunked", "dense")
    eng = S.ShardedFrontierSearch(p, devices=["cpu"] * 2, exchange="ragged")
    assert (eng.driver, eng.exchange) == ("chunked", "ragged")
    assert S.choose_driver(LocalMesh(["cuda:0"] * 4), "auto") == "chunked"
    assert S.auto_exchange(LocalMesh(["cuda:0"] * 4).devices) == "ragged"
    cards = LocalMesh(["cuda:0", "cuda:1"])
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: False)
    assert S.choose_driver(cards, "auto") == "host"
    assert S.choose_driver(cards, "auto", "dense") == "chunked"
    with pytest.raises(ValueError, match="maps no peer"):
        S.choose_driver(cards, "chunked", "ragged")
    eng = S.ShardedFrontierSearch(p, devices=["cpu", "cpu"], capacity=1 << 14)
    eng.local_devices = [torch.device("cpu"), torch.device("meta")]
    with pytest.raises(ValueError, match="one device"):
        eng._shards()
    eng = S.ShardedFrontierSearch(p, devices=["cpu"] * 2, capacity=1 << 14)
    eng.run()
    eng.cards[1].cons[S.C_STEPS] += 1
    with pytest.raises(RuntimeError, match="consensus vectors differ"):
        eng._check_agreement()


@pytest.mark.parametrize("split", [None, "three_cards"], ids=["one_card", "three_cards"])
@pytest.mark.parametrize("layout", ["sig", "unpacked"])
def test_chunked_equals_host_driver_spilling(monkeypatch, layout, split):
    """A one-row wire on a random input whose frontier is wide: rows wait in
    the carry rings, under both drivers alike, and the optimum holds; on
    one card, and on three cards (two shards on the middle one; the host
    driver's rank form there: a card a shard)."""
    if split:
        monkeypatch.setattr(S, "_card_groups", lambda devices: SPLITS[split])
    rs = np.random.RandomState(31)
    p = Problem(tuple("".join(rs.choice(list(AMINO), size=rs.randint(12, 17)))
                      for _ in range(4)))
    (ce, cr), (he, hr) = both_drivers(p, 4, layout=layout, exchange_cap=1,
                                      hash_type="FZORDER", hash_shift=0, batch=16,
                                      chunk_steps=8)
    assert len(ce.cards) == (3 if split else 1) and len(he.cards) == (4 if split else 1)
    assert cr.g == hr.g == optimal_cost(p, HPairHeuristic.build(p, "cpu"))
    assert ce.last_stats["peak_carry"] == he.last_stats["peak_carry"] > 0
    assert (cr.steps, cr.shard_stats) == (hr.steps, hr.shard_stats)
    for a, b in zip(shard_words(ce), shard_words(he)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_chunked_overflow_retries_equal_host_driver(layout):
    """A table of 16 slots a shard overflows twice: the chunk stops there,
    the run reads the overflow's kind from the consensus vector and
    retries at twice the capacity, as under the host driver; the retries,
    the result and the last run's tables equal."""
    rs = np.random.RandomState(31)
    p = Problem(tuple("".join(rs.choice(list(AMINO), size=rs.randint(12, 17)))
                      for _ in range(4)))
    (ce, cr), (he, hr) = both_drivers(p, 2, layout=layout, capacity=16, batch=16,
                                      hash_shift=0, chunk_steps=8)
    assert ce.retries == he.retries == [("table", 32, 240), ("table", 64, 240)]
    assert cr.g == hr.g == optimal_cost(p, HPairHeuristic.build(p, "cpu"))
    assert (cr.steps, cr.shard_stats) == (hr.steps, hr.shard_stats)
    for a, b in zip(shard_words(ce), shard_words(he)):
        assert torch.equal(a, b)


def test_chunked_max_steps_once_a_chunk():
    """max_steps is read once a chunk, as JAX's: a run stopped there raises
    after the same whole chunks under both drivers, with equal tables."""
    p = golden("test2.fasta")
    out = []
    for driver in ("chunked", "host"):
        eng = S.ShardedFrontierSearch(p, devices=["cpu"] * 2, capacity=1 << 14, chunk_steps=8,
                                      max_steps=10, driver=driver)
        with pytest.raises(RuntimeError, match="max_steps exceeded"):
            eng.run()
        out.append(eng)
    assert out[0].last_stats["steps"] == out[1].last_stats["steps"] == 16
    for a, b in zip(shard_words(out[0]), shard_words(out[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("split", [None, "two_cards"], ids=["one_card", "two_cards"])
@pytest.mark.parametrize("driver", ["chunked", "host"])
def test_finished_run_frees_without_the_collector(monkeypatch, driver, split):
    """A finished engine, its cards and its shards go by reference count
    alone (no cycle): on the card a graph destroyed by a collection that
    runs during a later capture would break that capture."""
    import gc
    import weakref

    if split:
        monkeypatch.setattr(S, "_card_groups", lambda devices: SPLITS[split])
    eng = S.ShardedFrontierSearch(golden("PF08184.fasta"), devices=["cpu"] * 4,
                                  capacity=1 << 14, driver=driver)
    eng.run()
    refs = [weakref.ref(o) for o in [eng, *eng.cards, *eng.shards]]
    gc.disable()
    try:
        del eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_driver_choice_and_refusals(monkeypatch):
    p = golden("PF08184.fasta")
    assert S.ShardedFrontierSearch(p, devices=["cpu"] * 2).driver == "chunked"
    with pytest.raises(ValueError, match="driver"):
        S.ShardedFrontierSearch(p, devices=["cpu"] * 2, driver="graph")
    # one card: chunked, whatever the peers
    assert S.choose_driver(LocalMesh(["cuda:0"] * 4), "auto") == "chunked"
    # cards that are each other's peers take the chunked driver under auto;
    # without peer access the host driver, and chunked raises there: it
    # never falls back
    cards = LocalMesh(["cuda:0", "cuda:1", "cuda:1", "cuda:2"])
    for peer in (True, False):
        monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: peer)
        assert S.choose_driver(cards, "auto") == ("chunked" if peer else "host")
        assert S.choose_driver(cards, "host") == "host"
    with pytest.raises(ValueError, match="peer access"):
        S.ShardedFrontierSearch(p, devices=cards, driver="chunked")
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: {a, b} != {0, 2})  # one pair without
    assert S.choose_driver(cards, "auto") == "host"
    with pytest.raises(ValueError, match="peer access"):
        S.choose_driver(cards, "chunked")
    # a card and the CPU have no peer access
    assert S.choose_driver(LocalMesh(["cpu", "cuda:0"]), "auto") == "host"
    # a several-rank ProcessMesh on the CPU: the chunked driver with the
    # dense exchange, which auto resolves to there (JAX's rule); with
    # ragged the host driver under auto, and chunked raises: a CPU rank
    # maps no peer's wire, so its ragged all-to-all takes host sizes
    pm = ProcessMesh.__new__(ProcessMesh)
    pm.ndev, pm.rank, pm.local, pm.multiprocess = 2, 0, [0], True
    pm.devices = [torch.device("cpu")]
    assert S.choose_driver(pm, "auto") == S.choose_driver(pm, "chunked", "dense") == "chunked"
    assert S.choose_driver(pm, "auto", "ragged") == S.choose_driver(pm, "host") == "host"
    eng = S.ShardedFrontierSearch(p, devices=pm)
    assert (eng.driver, eng.exchange) == ("chunked", "dense")
    eng = S.ShardedFrontierSearch(p, devices=pm, exchange="ragged")
    assert (eng.driver, eng.exchange) == ("host", "ragged")
    assert S.ShardedFrontierSearch(p, devices=pm, driver="host").exchange == "dense"
    with pytest.raises(ValueError, match="ProcessMesh"):
        S.ShardedFrontierSearch(p, devices=pm, driver="chunked", exchange="ragged")
    with pytest.raises(ValueError, match="CPU maps nothing"):
        pm.map_peers([torch.zeros((4, 3), dtype=torch.int32)])
    # a ProcessMesh of cards: auto is ragged (every shard on a card) and
    # chunked, each rank's exchange reading the others' wires through
    # CUDA IPC mappings
    pm.devices = [torch.device("cuda", 0)]
    assert S.auto_exchange(pm.devices) == "ragged" and S.maps_peers(pm)
    assert S.choose_driver(pm, "auto") == S.choose_driver(pm, "chunked", "ragged") == "chunked"
    assert S.choose_driver(pm, "auto", "dense") == "chunked"
    # one shard, dense: the single-table search under either driver
    for driver in ("chunked", "host"):
        eng = S.ShardedFrontierSearch(p, devices=["cpu"], driver=driver)
        res = eng.run()
        assert res.g == GOLD["PF08184.fasta"]["optimal_g"]
        assert eng.last_stats["driver"] == driver
        assert eng.last_stats["host_reads"] == (res.steps if driver == "host"
                                                else -(-res.steps // eng.chunk_steps))


# --- a chunk as replays of one-step graphs, one a ring parity


def test_replay_schedule():
    """The parity of each step graph a chunk replays alternates from the
    rings' parity at its start, and the parity after a chunk follows the
    steps that ran: over whole runs of T steps in chunks of C (a stop in
    mid-chunk included), the replays that run a step take the host
    driver's parities, step by step."""
    assert S.replay_parities(0, 5) == [0, 1, 0, 1, 0]
    assert S.replay_parities(1, 4) == [1, 0, 1, 0]
    assert S.replay_parities(1, 1) == [1]
    assert [S.parity_after(p, r) for p, r in ((0, 0), (0, 7), (1, 7), (1, 16))] == [0, 1, 0, 1]
    for C in (1, 2, 7, 16):
        for T in range(41):
            parity, steps, ran = 0, 0, []
            while True:
                order = S.replay_parities(parity, C)
                r = min(C, T - steps)
                ran += order[:r]
                parity = S.parity_after(parity, r)
                steps += r
                if steps >= T:
                    break
            assert ran == [k % 2 for k in range(T)], (C, T)
            assert parity == T % 2


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
@pytest.mark.parametrize("chunk", [1, 7])
def test_chunked_odd_chunks_equal_host_driver(layout, chunk):
    """Chunks of 1 and 7 steps on PF08184 (59 steps: an odd stop, inside a
    chunk of 7) on 4 shards, ragged, against one step a read: the result,
    every stat and every table word equal."""
    (ce, cr), (he, hr) = both_drivers(golden("PF08184.fasta"), 4, layout=layout,
                                      capacity=1 << 14, chunk_steps=chunk, exchange="ragged")
    assert cr.steps == hr.steps == 59
    assert cr.g == hr.g == GOLD["PF08184.fasta"]["optimal_g"]
    assert (cr.closed, cr.shard_stats, cr.nodes_migrated) == (
        hr.closed, hr.shard_stats, hr.nodes_migrated)
    for a, b in zip(shard_words(ce), shard_words(he)):
        assert torch.equal(a, b)
    cs, hs = ce.last_stats, he.last_stats
    assert cs["host_reads"] == -(-59 // chunk) and hs["host_reads"] == 59
    for k in ("steps", "wire_rows", "migrated", "peak_carry", "walk_rounds"):
        assert cs[k] == hs[k], k
    # one card: the walk in one launch, one read
    assert cs["walk_form"] == "launch" and cs["walk_reads"] == 1


class _StepReplay:
    """A stand-in for a step's CUDA graph on CPU shards: a replay is one
    plain step from the rings at its parity (as the graph captured there
    reads them)."""

    def __init__(self, eng, parity):
        self.eng, self.parity = eng, parity

    def replay(self):
        card = self.eng.cards[0]
        card.cuda = False
        for sh in self.eng.shards:
            sh.cur = self.parity
        self.eng._step(self.eng.shards)
        card.cuda = True


@pytest.mark.parametrize("split", [None, "two_cards", "ranks"],
                         ids=["one_card", "two_cards", "ranks"])
@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
@pytest.mark.parametrize("chunk", [1, 7])
def test_chunk_replays_equal_host_driver(monkeypatch, chunk, layout, split):
    """The chunked driver's card branch, with a stand-in for each ring
    parity's step graph (a replay runs one plain step from its parity) on
    CPU shards: a random input whose one-row wire spills into the carry
    rings (so a replay from the wrong ring would differ), 43 steps on 4
    shards, ragged, in chunks of 1 and 7 (a stop in mid-chunk at an odd
    step), equals the host driver on every table word and ring; two
    graphs, ``chunk`` replays a host read; on one card, on two (the host
    driver then the rank form), and in the rank form (``_rank_form``
    replaced; dense, as its chunked step needs)."""
    import contextlib

    def step_graphs(self, card, shards, stats):
        if not card.graphs:
            card.graphs = {p: TS.ChunkGraph(p, _StepReplay(self, p), {}) for p in (0, 1)}
            stats["graph_captures"] += 2
        return card.graphs

    search = S.ShardedFrontierSearch._search_chunked

    def on_card(self, shards, stats):
        self.cards[0].cuda = True
        try:
            return search(self, shards, stats)
        finally:
            self.cards[0].cuda = False

    monkeypatch.setattr(S.ShardedFrontierSearch, "_step_graphs", step_graphs)
    monkeypatch.setattr(S.ShardedFrontierSearch, "_search_chunked", on_card)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    if split == "ranks":
        monkeypatch.setattr(S, "_rank_form", lambda mesh: True)
    elif split:
        monkeypatch.setattr(S, "_card_groups", lambda devices: SPLITS[split])
    rs = np.random.RandomState(31)
    p = Problem(tuple("".join(rs.choice(list(AMINO), size=rs.randint(12, 17)))
                      for _ in range(4)))
    (ce, cr), (he, hr) = both_drivers(p, 4, layout=layout, exchange_cap=1, hash_type="FZORDER",
                                      hash_shift=0, batch=16, chunk_steps=chunk,
                                      exchange="dense" if split == "ranks" else "ragged")
    assert ce.card_form == (split != "ranks")
    assert cr.steps == hr.steps and (cr.g, cr.shard_stats) == (hr.g, hr.shard_stats)
    assert cr.steps == 43 or split == "ranks"
    assert ce.last_stats["peak_carry"] == he.last_stats["peak_carry"] > 0
    for a, b in zip(shard_words(ce), shard_words(he)):
        assert torch.equal(a, b)
    cs = ce.last_stats
    assert cs["graph_captures"] == 2 and cs["host_reads"] == -(-cr.steps // chunk)
    assert cs["graph_replays"] == chunk * cs["host_reads"]
