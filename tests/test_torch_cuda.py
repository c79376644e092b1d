"""Tests that need the card (marker ``cuda``): the hand-written CUDA kernels
(K1 pair wavefront, K8 Gotoh fill, K2 triple cubes, the sig step kernels K3-K5, the
packed and unpacked step kernels K3, K9 and K10 on both of K10's paths,
the path walk K7, and the sharded step's K4 sharded, K11, K12 and K7's hop
mode, and on key rows K9s, K11, K10 on received rows, K7's hop mode and
keyrow_coords, and the sharded loop's consensus, exchange and walk_advance)
against their plain PyTorch versions, the chunk graph (K6) against the
eager chunk, the sharded chunk graph (K6s) against the host driver (on one
card, on two cards of one, and across every card when there are two or
more), and the port's main path, its table layouts and the sharded engine
on four shards of one card on the GPU.
They skip on a host without a CUDA device.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import ctypes
import functools
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu_torch import _kernels
from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.triples import (
    pick_cover, triple_inputs, triple_tables, triple_tables_plain)
from mpi_pastar_msa_tpu_torch.heuristic.wavefront import (
    pair_inputs, wavefront_tables, wavefront_tables_plain)
from mpi_pastar_msa_tpu_torch.heuristic.weights import altschul_rationale2
from test_torch_multihost import run_ranks
from walk_cases import WALK_SHAPES, WALK_STOPS, walk_case

pytestmark = pytest.mark.cuda
HERE = os.path.dirname(os.path.abspath(__file__))
AMINO = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("seed,n,lo,hi", [
    (1, 5, 1, 40), (2, 3, 200, 300), (3, 2, 1, 1),
    # row-band boundaries: lengths 1023/1023 (L1 = 1024, R = 1), 1023/1024
    # (L1 = 1025, R = 2) and 2105/2099 (R = 3)
    (4, 2, 1023, 1023), (4, 2, 1023, 1024), (6, 2, 2095, 2105),
    # ragged, lengths 1176, 371, 163 and 351: n1 << n2 and n1 >> n2
    (4, 4, 30, 1400),
])
def test_k1_kernel_equals_plain(cuda, seed, n, lo, hi):
    rs = np.random.RandomState(seed)
    seqs = tuple("".join(rs.choice(list(AMINO), size=rs.randint(lo, hi + 1)))
                 for _ in range(n))
    args = pair_inputs(Problem(seqs), cuda)
    before = _kernels.launches["pair_wavefront"]
    got = wavefront_tables(**args)
    assert _kernels.launches["pair_wavefront"] == before + 1
    want = wavefront_tables_plain(**args)
    assert torch.equal(got.cpu(), want.cpu())


def test_k1_wrapper_rejects_unequal_gaps(cuda, monkeypatch):
    # the kernel takes gap open == extension (core/cost.py); anything else
    # raises before a launch
    from mpi_pastar_msa_tpu_torch.heuristic import wavefront
    monkeypatch.setattr(wavefront, "GAP_OPEN", 40)
    monkeypatch.setattr(wavefront, "GAP_EXTENSION", 7)
    args = pair_inputs(Problem(("ACDE", "ACF")), cuda)
    before = _kernels.launches["pair_wavefront"]
    with pytest.raises(ValueError):
        wavefront_tables(**args)
    assert _kernels.launches["pair_wavefront"] == before


def test_k1_wrapper_rejects_bad_input(cuda):
    args = pair_inputs(Problem(("ACDE", "ACF")), cuda)
    args["enc"] = args["enc"].long()
    with pytest.raises(ValueError):
        wavefront_tables(**args)


def test_k1_wrapper_rejects_oversize(cuda):
    # Lmax 21605 needs more shared memory than a block may use
    args = pair_inputs(Problem(("ACDE", "A" * 21605)), cuda)
    before = _kernels.launches["pair_wavefront"]
    with pytest.raises(ValueError):
        wavefront_tables(**args)
    assert _kernels.launches["pair_wavefront"] == before


def test_main_path_on_card(cuda):
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    gold = json.load(open(os.path.join(HERE, "goldens.json")))["PF08184.fasta"]
    p = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    _kernels.reset_counts()
    res = FrontierSearch(p, HPairHeuristic.build(p, cuda), device=cuda,
                         triples="off").run()
    assert _kernels.launches["pair_wavefront"] == 1
    assert _kernels.launches["gotoh_wavefront"] == 1
    assert res.g == gold["optimal_g"]
    assert build_alignment(p, res.closed) == gold["alignment"]


def golden_problem(name):
    gold = json.load(open(os.path.join(HERE, "goldens.json")))[name]
    return gold, Problem(tuple(r.replace("-", "") for r in gold["alignment"]))


def k2_inputs(case, device):
    """K2 inputs: kinase's own cover (4 cubes, S = 278), or random
    sequences of given lengths with given triangles and random weights."""
    if case == "kinase":
        _, p = golden_problem("kinase.fasta")
        _, wi = altschul_rationale2(p.seqs)
        cover = pick_cover(wi, p.n_seq)
        assert len(cover) == 4
        return triple_inputs(p, [t for t, _ in cover], [w for _, w in cover],
                             device)
    lens, tris = case
    rs = np.random.RandomState(sum(lens))
    seqs = tuple("".join(rs.choice(list(AMINO), size=L)) for L in lens)
    ws = rs.randint(0, 60, size=(len(tris), 3)).tolist()
    return triple_inputs(Problem(seqs), tris, ws, device)


@pytest.mark.parametrize("case", [
    ((1, 1, 1), [(0, 1, 2)]),
    ((1, 40, 300, 17), [(0, 1, 2), (1, 2, 3)]),
    "kinase",
    # box sides 16, 17 and 18 against 16-cell tiles: at, one above and two
    # above a tile multiple
    ((15, 16, 17), [(0, 1, 2)]),
    # box sides 31, 32 and 33 each once along i (32-cell tiles) and along
    # j and k (16-cell tiles): one below, at and one above a tile multiple
    ((30, 31, 32), [(0, 1, 2), (1, 2, 0), (2, 0, 1)]),
    # a length-1 and a length-0 side: cubes one tile thick
    ((1, 16, 33), [(0, 1, 2)]),
    ((0, 17, 5), [(0, 1, 2)]),
    # a T = 3 cover whose cubes have different tile grids
    ((15, 16, 17, 1, 40), [(0, 1, 2), (1, 3, 4), (0, 2, 4)]),
], ids=["T1-ones", "T2-ragged", "kinase", "T1-tile-edges", "T3-tile-edges",
        "T1-length-1", "T1-length-0", "T3-cover"])
def test_k2_kernel_equals_plain(cuda, case):
    args = k2_inputs(case, cuda)
    before = _kernels.launches["triple_wavefront"]
    got, got_org = triple_tables(**args)
    torch.cuda.synchronize()
    assert _kernels.launches["triple_wavefront"] == before + 1
    want, want_org = triple_tables_plain(**args)
    assert torch.equal(got.cpu(), want.cpu())
    assert torch.equal(got_org.cpu(), want_org.cpu())


def test_k2_wrapper_rejects_bad_input(cuda, monkeypatch):
    from mpi_pastar_msa_tpu_torch.heuristic import triples
    base = k2_inputs(((3, 4, 5), [(0, 1, 2)]), cuda)
    bad = [dict(base, cxy=base["cxy"].long()),
           dict(base, lens=base["lens"][:, :2].contiguous()),
           dict(base, cxz=base["cxz"][:, :-1].contiguous()),
           dict(base, cyz=base["cyz"].transpose(1, 2)),
           dict(base, lens=base["lens"] + 10)]
    before = _kernels.launches["triple_wavefront"]
    for args in bad:
        with pytest.raises(ValueError):
            triple_tables(**args)
    # the C entry refuses a tile other than the one it is compiled for
    T, S = base["cxy"].shape[0], base["cxy"].shape[-1]
    shape = triples.k2_launch_shape(base["lens"].cpu().numpy(), S, (16, 16, 16))
    cubes = torch.empty((T, S, S, S), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError):
        _kernels.launch(
            "triple_wavefront", cubes.data_ptr(),
            *(base[k].data_ptr() for k in ("cxy", "cxz", "cyz", "lens", "ws")),
            T, S, *shape.tile, shape.diagonals, shape.grid.ctypes.data,
            triples.GAP_OPEN, triples.GAP_EXTENSION, triples.GAP_GAP,
            torch.cuda.current_stream().cuda_stream)
    monkeypatch.setattr(triples, "GAP_OPEN", 40)
    with pytest.raises(ValueError):
        triple_tables(**base)
    assert _kernels.launches["triple_wavefront"] == before


def test_main_path_auto_on_card(cuda):
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    gold, p = golden_problem("PF08184.fasta")
    _kernels.reset_counts()
    eng = FrontierSearch(p, HPairHeuristic.build(p, cuda), device=cuda)
    res = eng.run()
    assert len(eng.heuristic.triangles) == 1
    assert _kernels.launches["pair_wavefront"] == 1
    assert _kernels.launches["triple_wavefront"] == 1
    # the sig step: K3, K4 and K5 once a step (steps enqueued after the
    # stop included): one step graph, each kernel launched once as its
    # warm-up, then once a replay, chunk_steps replays a chunk
    n = _kernels.launches["select_best"]
    assert n >= res.steps
    assert _kernels.launches["sig_expand"] == _kernels.launches["sig_probe"] == n
    chunks = -(-res.steps // eng.chunk_steps)
    assert eng.graph_captures == 1 and n == 1 + eng.chunk_steps * chunks
    assert res.g == gold["optimal_g"]
    assert build_alignment(p, res.closed) == gold["alignment"]


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_pinned_layout_on_card(cuda, layout):
    # the same search on the card and on the CPU: g and the path agree
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    gold, p = golden_problem("PF08184.fasta")
    want = FrontierSearch(p, HPairHeuristic.build(p, "cpu"), device="cpu",
                          layout=layout).run()
    eng = FrontierSearch(p, HPairHeuristic.build(p, cuda), device=cuda,
                         layout=layout)
    res = eng.run()
    assert eng.layout == layout
    assert res.g == want.g == gold["optimal_g"]
    assert res.closed == want.closed


def near_identical_family():
    """5 x 130 residues, 5% substitutions (the generator of
    tests/test_large_n.py, seed 5): 40 sig bits, over a 2^14 table's 36."""
    rng = np.random.default_rng(5)
    aa = "ARNDCQEGHILKMFPSTWYV"
    anc = "".join(aa[i] for i in rng.integers(0, 20, 130))
    seqs = []
    for _ in range(5):
        out = []
        for ch in anc:
            r = rng.random()
            out.append(aa[rng.integers(0, 20)] if r < 0.05 else ch)
        seqs.append("".join(out))
    return Problem(tuple(seqs))


def test_near_identical_family_packed_on_card(cuda):
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    p = near_identical_family()
    eng = FrontierSearch(p, HPairHeuristic.build(p, cuda), device=cuda,
                         capacity=1 << 14)
    assert eng.layout == "packed" and eng.st.sig_bits == 40
    res = eng.run()
    # 132508: the JAX engine's g on this input (tests/test_torch_layouts.py
    # holds the port to it on the CPU)
    assert res.g == 132508
    assert res.closed[tuple(int(v) for v in p.final_coord)][0] == res.g


# ------------------------------------------------ the step kernels K3-K5

def sig_engine(name, device, **kw):
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    _, p = golden_problem(name)
    return FrontierSearch(p, HPairHeuristic.build(p, device), device=device, **kw)


def k3_tables(st, device, empty=0.0, ties=False, seed=7):
    """t_best and t_closed (C + TRASH,) on ``device`` for a select: half the
    slots used, whole groups empty with probability ``empty``, some closed,
    some reopened; ``ties`` gives every used slot one word."""
    from mpi_pastar_msa_tpu_torch.search import engine as E

    C, B, nb = st.C, st.B, st.nb
    rs = np.random.RandomState(seed)
    best = np.full(C + E.TRASH, E.INFP, dtype=np.int32)
    closed = best.copy()
    used = (rs.rand(C) < 0.5) & np.repeat(rs.rand(B) >= empty, C // B)
    words = np.full(C, (3 << nb) | 1) if ties else (
        (rs.randint(0, 30, size=C) << nb) | rs.randint(1, st.M + 1, size=C))
    best[:C][used] = words[used]
    u = rs.rand(C)
    closed[:C][used & (u < 0.3)] = best[:C][used & (u < 0.3)]
    reo = used & (u >= 0.3) & (u < 0.5)
    closed[:C][reo] = best[:C][reo] + (5 << nb)
    return torch.from_numpy(best).to(device), torch.from_numpy(closed).to(device)


def k3_statics(device, G=256):
    """PF08184's statics at 2^16 slots, B = 2^16 / G groups, on ``device``."""
    st = sig_engine("PF08184.fasta", "cpu", batch=(1 << 16) // G, capacity=1 << 16,
                    triples="off").st
    assert st.C // st.B == G
    st.device = device
    return st


def assert_k3_equals_plain(st, t_best, closed, goal, thr):
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    a, b = closed.clone(), closed.clone()
    before = _kernels.launches["select_best"]
    got = S.select_best_cuda(st, t_best, a, goal, thr)
    want = E._select_best_plain(st, t_best, b, goal, thr)
    torch.cuda.synchronize()
    assert _kernels.launches["select_best"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y.cpu())
    assert torch.equal(a[:st.C].cpu(), b[:st.C].cpu())
    # the compact list: the active rows (slot, word) in group order
    bufs = S.StepBuffers.select_only(st, t_best.device)
    rows = torch.nonzero(want[2])[:, 0]
    n = int(want[5])
    assert torch.equal(bufs.sel[:n].long().cpu(),
                       torch.stack([want[0][rows], want[1][rows]], 1).cpu())
    assert int(bufs.ticket) == 0


@pytest.mark.parametrize("thr,goal_off,empty,ties", [
    (0, 10**9, 0.0, False), (2**20, 10**9, 0.3, False),
    (40, 900, 0.5, False), (0, 10**9, 0.0, True), (2**20, 10**9, 1.0, False)],
    ids=["thr0", "thr2^20-empty-groups", "goal-cut", "all-ties", "all-empty"])
def test_k3_equals_plain(cuda, thr, goal_off, empty, ties):
    st = k3_statics(cuda)
    t_best, closed = k3_tables(st, cuda, empty, ties)
    assert_k3_equals_plain(st, t_best, closed, st.f0 + goal_off, thr)


@pytest.mark.parametrize("G", [1, 2, 1024])
def test_k3_group_sizes_equal_plain(cuda, G):
    # G = 1: 65536 groups, eight rounds of the last block; G = 2: 16 groups
    # a warp; G = 1024: a warp a group, 8 int4 loads of each table a lane
    st = k3_statics(cuda, G)
    t_best, closed = k3_tables(st, cuda, 0.2, seed=G)
    assert_k3_equals_plain(st, t_best, closed, st.f0 + 10**9, 40)


def test_k3_run_flag_zero_touches_nothing(cuda):
    from mpi_pastar_msa_tpu_torch.search import step as S

    st = k3_statics(cuda)
    t_best, closed = k3_tables(st, cuda, 0.2)
    bufs = S.StepBuffers.select_only(st, cuda)
    for t in (bufs.slots, bufs.vmin, bufs.state):
        t.fill_(-3)
    bufs.active.fill_(True)
    run = torch.zeros(1, dtype=torch.int32, device=cuda)
    seen = [t.clone() for t in (t_best, closed, bufs.slots, bufs.vmin, bufs.active,
                                bufs.state)]
    S.select_best_cuda(st, t_best, closed, st.f0 + 10**9, 40, run=run, bufs=bufs)
    torch.cuda.synchronize()
    after = (t_best, closed, bufs.slots, bufs.vmin, bufs.active, bufs.state)
    assert all(torch.equal(x, y) for x, y in zip(seen, after))
    assert int(bufs.ticket) == 0
    # the same buffers with the flag at 1: the plain select's outputs
    run.fill_(1)
    got = S.select_best_cuda(st, t_best, closed, st.f0 + 10**9, 40, run=run, bufs=bufs)
    torch.cuda.synchronize()
    assert int(got[5]) > 0 and int(bufs.ticket) == 0


def clone_sig(tab):
    from mpi_pastar_msa_tpu_torch.search.engine import SigTable

    return SigTable(tab.t_sig.clone(), tab.t_best.clone(), tab.t_closed.clone())


def assert_same_step(st, ka, kc, pa, pc):
    C = st.C
    for name in ("t_sig", "t_best", "t_closed"):
        assert torch.equal(getattr(ka, name)[:C].cpu(), getattr(pa, name)[:C].cpu()), name
    assert kc.tolist() == pc.tolist()


@pytest.mark.parametrize("triples,warm", [("auto", 150), ("off", 400)])
def test_step_kernels_equal_plain_step_kinase(cuda, triples, warm):
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    eng = sig_engine("kinase.fasta", cuda, triples=triples)
    st = eng.st
    assert eng.layout == "sig"
    tab = eng._init_table()
    ctr = E._run_chunk(st, tab, torch.as_tensor(E.fresh_counters(), device=cuda), warm,
                       eng.ub, eng.fill_target, "sig")
    for n in (1, 32):
        ka, pa = clone_sig(tab), clone_sig(tab)
        kc = S.run_chunk_sig_cuda(st, ka, ctr, n, eng.ub, eng.fill_target)
        pc = E._run_chunk_plain(st, pa, ctr, n, eng.ub, eng.fill_target, "sig",
                                plain_select=True)
        assert_same_step(st, ka, kc, pa, pc)
        assert int(kc[2]) == int(ctr[2]) + n


@pytest.mark.parametrize("steps", [1, 32])
def test_step_kernels_equal_plain_step_synth6(cuda, steps):
    # N = 6: 63 masks a row, two passes of a warp in K4
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    p = problem_from_fasta(os.path.join(HERE, "data", "synth6.fasta"))
    eng = E.FrontierSearch(p, HPairHeuristic.build(p, cuda), device=cuda)
    st = eng.st
    assert eng.layout == "sig" and st.M == 63
    tab = eng._init_table()
    ctr = E._run_chunk(st, tab, torch.as_tensor(E.fresh_counters(), device=cuda), 40,
                       eng.ub, eng.fill_target, "sig")
    ka, pa = clone_sig(tab), clone_sig(tab)
    kc = S.run_chunk_sig_cuda(st, ka, ctr, steps, eng.ub, eng.fill_target)
    pc = E._run_chunk_plain(st, pa, ctr, steps, eng.ub, eng.fill_target, "sig",
                            plain_select=True)
    assert_same_step(st, ka, kc, pa, pc)
    assert int(kc[2]) == int(ctr[2]) + steps


def test_step_kernels_overflow_like_plain(cuda):
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    # a 2^8-slot table under an upper bound 20000 above test2's: the prune
    # lets through enough keys to fill it, and both loops stop on the same
    # overflow, with the same table
    eng = sig_engine("test2.fasta", cuda, batch=16, capacity=1 << 8, triples="off")
    st, ub = eng.st, eng.ub + 20000
    ka = eng._init_table()
    pa = clone_sig(ka)
    kc = pc = torch.as_tensor(E.fresh_counters(), device=cuda)
    for _ in range(20):
        kc = S.run_chunk_sig_cuda(st, ka, kc, 16, ub, eng.fill_target)
        pc = E._run_chunk_plain(st, pa, pc, 16, ub, eng.fill_target, "sig",
                                plain_select=True)
        assert_same_step(st, ka, kc, pa, pc)
        if int(kc[6]) > 0:
            break
    assert int(kc[6]) > 0
    # with its own bound the engine finds the optimum in that table
    res = sig_engine("test2.fasta", cuda, batch=16, capacity=1 << 8,
                     triples="off").run()
    assert res.g == 45037


def test_step_wrappers_reject_bad_input(cuda):
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    eng = sig_engine("PF08184.fasta", cuda, batch=64, capacity=1 << 12, triples="off")
    st, tab = eng.st, eng._init_table()
    ctr = torch.as_tensor(E.fresh_counters(), device=cuda)
    before = dict(_kernels.launches)
    bad_tables = [E.SigTable(tab.t_sig, tab.t_best, tab.t_closed.cpu()),   # device mix
                  E.SigTable(tab.t_sig.long(), tab.t_best, tab.t_closed),  # dtype
                  E.SigTable(tab.t_sig[:100], tab.t_best, tab.t_closed),   # size
                  E.PackedTable(tab.t_sig[:, None], tab.t_best, tab.t_closed,
                                tab.t_closed)]                             # layout
    for bad in bad_tables:
        with pytest.raises(ValueError):
            S.run_chunk_sig_cuda(st, bad, ctr, 1, eng.ub, eng.fill_target)
    for bad_ctr in (ctr.cpu(), ctr.int(), ctr[:8]):
        with pytest.raises(ValueError):
            S.run_chunk_sig_cuda(st, tab, bad_ctr, 1, eng.ub, eng.fill_target)
    with pytest.raises(ValueError):
        S.select_best_cuda(st, tab.t_best, tab.t_closed.cpu(), 10**6, 0)
    with pytest.raises(ValueError):
        S.select_best_cuda(st, tab.t_best.long(), tab.t_closed, 10**6, 0)
    assert _kernels.launches == before


@pytest.mark.parametrize("triples,expanded,reopened,steps", [
    ("auto", 985050, 346443, 299), ("off", 5137387, None, 966)])
def test_kinase_end_to_end_counts(cuda, triples, expanded, reopened, steps):
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment

    gold, p = golden_problem("kinase.fasta")
    _kernels.reset_counts()
    eng = sig_engine("kinase.fasta", cuda, triples=triples)
    res = eng.run()
    assert res.g == gold["optimal_g"]
    assert (res.nodes_expanded, res.steps) == (expanded, steps)
    if reopened is not None:
        assert res.nodes_reopened == reopened
    assert all(_kernels.launches[k] > 0 for k in (
        "pair_wavefront", "select_best", "sig_expand", "sig_probe"))
    assert (_kernels.launches["triple_wavefront"] > 0) == (triples == "auto")
    assert [r.replace("-", "") for r in build_alignment(p, res.closed)] == list(p.seqs)


# ------------------------------------------- K5's two paths, the chunk graph

def warm_sig(name, device, triples, warm, **kw):
    """A sig engine on the card ``warm`` steps into its search: (engine,
    table, counters); ``name`` a golden input or a tests/data one."""
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search import engine as E

    if name.endswith(".fasta"):
        eng = sig_engine(name, device, triples=triples, **kw)
    else:
        p = problem_from_fasta(os.path.join(HERE, "data", f"{name}.fasta"))
        eng = E.FrontierSearch(p, HPairHeuristic.build(p, device), device=device,
                               triples=triples, **kw)
    assert eng.layout == "sig"
    tab = eng._init_table()
    ctr = E._run_chunk(eng.st, tab, torch.as_tensor(E.fresh_counters(), device=device),
                       warm, eng.ub, eng.fill_target, "sig")
    return eng, tab, ctr


@pytest.mark.parametrize("name,triples,warm", [
    ("kinase.fasta", "auto", 150), ("kinase.fasta", "off", 400), ("synth6", "auto", 40)])
def test_k5_both_paths_equal_plain_insert(cuda, name, triples, warm):
    # one step from a mid-search table with K5's cap just below the step's
    # pending count n (the grid path), at n (the block path), at 0 and at
    # K5_CAP, on its own grid and on one block: the plain step's tables
    # and counters every time
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    eng, tab, ctr = warm_sig(name, cuda, triples, warm)
    st, ub, fill = eng.st, eng.ub, eng.fill_target
    pa = clone_sig(tab)
    pc = E._run_chunk_plain(st, pa, ctr, 1, ub, fill, "sig", plain_select=True)
    n = int(pc[12]) - int(ctr[12])
    assert n > 0
    caps = sorted({c for c in (n - 1, n, 0, S.K5_CAP) if 0 <= c <= S.K5_CAP})
    for cap in caps:
        for blocks in (0, 1):
            ka = clone_sig(tab)
            kc = S.run_chunk_sig_cuda(st, ka, ctr, 1, ub, fill, blocks=blocks, cap=cap)
            assert_same_step(st, ka, kc, pa, pc)


def graph_vs_eager(run_chunk, st, tab, ctr, ub, fill, kernels, clone):
    """The step graph replayed against the eager chunk from one mid-search
    table, bit for bit (every table tensor and the 14 counters), after 1
    chunk and after 3 of 1, 7, 16 and 64 steps; one capture a table, for
    every chunk length; each step kernel launched once as the capture's
    warm-up and once a replay, the eager chunk's chunk_steps times a chunk.
    Returns whether a search stopped in the middle of a chunk (its replays
    after the stop then change nothing)."""
    from mpi_pastar_msa_tpu_torch.search import step as S

    mid_chunk = False
    for steps in (1, 7, 16, 64):
        for chunks in (1, 3):
            ga, ea = clone(tab), clone(tab)
            gc = ec = ctr
            n0 = S.capture_stats(st)[0]
            before = dict(_kernels.launches)
            for _ in range(chunks):
                gc = run_chunk(st, ga, gc, steps, ub, fill)
            ran = int(gc[2]) - int(ctr[2])
            graph = {k: _kernels.launches[k] - before[k] for k in kernels}
            for _ in range(chunks):
                ec = run_chunk(st, ea, ec, steps, ub, fill, graph=False)
            assert_same_tables(st, ga, gc, ea, ec)
            assert S.capture_stats(st)[0] == n0 + 1
            assert 0 < ran <= steps * chunks
            for k in kernels:
                assert graph[k] == 1 + steps * chunks, (k, steps, chunks)
                assert _kernels.launches[k] - before[k] - graph[k] == steps * chunks
            mid_chunk |= int(gc[1]) >= int(gc[0]) and ran % steps != 0
    return mid_chunk


@pytest.mark.parametrize("name,triples,warm", [
    ("kinase.fasta", "auto", 150), ("kinase.fasta", "off", 400), ("synth6", "auto", 40)])
def test_graph_chunk_equals_eager_chunk(cuda, name, triples, warm):
    # the chunk graph against the eager chunk, bit for bit, after 1 chunk
    # and after 3 of 1, 7, 16 and 64 steps, from one mid-search table; one
    # capture a table; kinase `auto` reaches its goal (step 299) in the
    # middle of a chunk of 64 (150 + 3 x 64 steps), and the replays after
    # it change nothing
    from mpi_pastar_msa_tpu_torch.search import step as S

    eng, tab, ctr = warm_sig(name, cuda, triples, warm)
    mid = graph_vs_eager(S.run_chunk_sig_cuda, eng.st, tab, ctr, eng.ub, eng.fill_target,
                         ("select_best", "sig_expand", "sig_probe"), clone_sig)
    assert mid or (name, triples) != ("kinase.fasta", "auto")


def test_regrow_recaptures_and_reaches_the_optimum(cuda):
    # synth6 in a 2^20-slot table (the least that keeps its 42 key bits in
    # a sig word) outgrows it: the engine doubles the capacity, starts
    # again on new statics and a new table, captures a new chunk graph,
    # and still reaches the certified optimum
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search import engine as E

    p = problem_from_fasta(os.path.join(HERE, "data", "synth6.fasta"))
    eng = E.FrontierSearch(p, HPairHeuristic.build(p, cuda), device=cuda, capacity=1 << 20)
    assert eng.layout == "sig"
    first = eng.st
    _kernels.reset_counts()
    res = eng.run()
    assert eng.regrown and eng.st is not first and eng.st.C > first.C
    assert eng.layout == "sig" and eng.graph_captures == 1
    assert res.g == 272848  # tests/test_synth6.py
    assert _kernels.launches["sig_expand"] == _kernels.launches["sig_probe"] == (
        _kernels.launches["select_best"])


# ------------------------------- the packed and unpacked step: K3, K9, K10

def open_tables(st, device, negative=False, seed=5):
    """t_state and t_fpar (C + TRASH,) on ``device`` for the unpacked
    select: a third of the slots used, open or closed, f in a narrow band
    (ties: the first index wins), some f at INF; ``negative`` puts f below
    0."""
    from mpi_pastar_msa_tpu_torch.search import engine as E

    C, nb = st.C, st.nb
    rs = np.random.RandomState(seed)
    size = C + E.TRASH
    used = rs.rand(C) < 0.35
    f = rs.randint(0, 40, size=C) + (-500 if negative else st.f0)
    f[rs.rand(C) < 0.02] = E.INF
    fpar = np.full(size, E.INF << nb, dtype=np.int64)
    fpar[:C][used] = (f[used].astype(np.int64) << nb) + rs.randint(1, st.M + 1, size=used.sum())
    state = np.zeros(size, dtype=np.int32)
    state[:C][used] = np.where(rs.rand(used.sum()) < 0.7, 1, 2)
    return torch.from_numpy(state).to(device), torch.from_numpy(fpar).to(device)


@pytest.mark.parametrize("G,negative,goal_off", [(1, False, 30), (2, True, None),
                                                 (1024, False, None), (256, True, None),
                                                 (256, False, 30)])
def test_k3_unpacked_equals_plain(cuda, G, negative, goal_off):
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    st = k3_statics(cuda, G)
    t_state, fpar = open_tables(st, cuda, negative, seed=G)
    goal = E.INF if goal_off is None else st.f0 + goal_off
    a, b = t_state.clone(), t_state.clone()
    before = _kernels.launches["select_best_unpacked"]
    got = S.select_open_cuda(st, a, fpar, goal, 5)
    want = E._select_open_plain(st, b, fpar, torch.tensor(goal, device=cuda),
                                torch.tensor(5, device=cuda))
    torch.cuda.synchronize()
    assert _kernels.launches["select_best_unpacked"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y.cpu())
    assert torch.equal(a[:st.C].cpu(), b[:st.C].cpu())
    bufs = S.StepBuffers.select_only(st, fpar.device)  # the scratch K3 wrote
    rows = torch.nonzero(want[2])[:, 0]
    n = int(want[5])
    assert n > 0 and (int(want[3]) < 0) == negative
    assert torch.equal(bufs.sel[:n].long().cpu(),
                       torch.stack([want[0][rows], want[1][rows]], 1).cpu())
    assert int(bufs.ticket) == 0


def keyrow_engine(seqs_or_name, device, layout, **kw):
    from mpi_pastar_msa_tpu_torch.core.problem import problem_from_fasta
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    if isinstance(seqs_or_name, tuple):
        p = Problem(seqs_or_name)
    elif seqs_or_name.endswith(".fasta"):
        p = golden_problem(seqs_or_name)[1]
    else:
        p = problem_from_fasta(os.path.join(HERE, "data", f"{seqs_or_name}.fasta"))
    return FrontierSearch(p, HPairHeuristic.build(p, device), device=device, layout=layout,
                          **kw)


def warm_keyrow(eng, warm):
    """A table ``warm`` kernel steps into the engine's search, and its
    counters."""
    from mpi_pastar_msa_tpu_torch.search import engine as E

    tab = eng._init_table()
    ctr = torch.as_tensor(E.fresh_counters(), device=eng.st.device)
    if warm:
        ctr = E._run_chunk(eng.st, tab, ctr, warm, eng.ub, eng.fill_target, eng.layout)
    return tab, ctr


def clone_tab(tab):
    return type(tab)(*(t.clone() for t in vars(tab).values()))


def assert_same_tables(st, ka, kc, pa, pc):
    for name, x in vars(ka).items():
        assert torch.equal(x[:st.C].cpu(), getattr(pa, name)[:st.C].cpu()), name
    assert kc.tolist() == pc.tolist()


def family(seed, n, L, sub):
    rng = np.random.default_rng(seed)
    aa = "ARNDCQEGHILKMFPSTWYV"
    anc = "".join(aa[i] for i in rng.integers(0, 20, L))
    return tuple("".join(aa[rng.integers(0, 20)] if rng.random() < sub else ch for ch in anc)
                 for _ in range(n))


@pytest.mark.parametrize("name,layout,warm,kw", [
    ("PF08184.fasta", "packed", 6, {}), ("PF08184.fasta", "unpacked", 6, {}),
    ("test.fasta", "packed", 2, {}), ("test2.fasta", "unpacked", 8, {}),
    ("kinase.fasta", "unpacked", 40, {}), ("synth6", "packed", 20, {}),
    # N = 10: 1023 masks a row, 4 passes of a block of 256 threads in K9
    ("synth10", "packed", 5, dict(capacity=1 << 20))])
def test_keyrow_step_kernels_equal_plain_step(cuda, name, layout, warm, kw):
    # 1 and 8 steps from a mid-search table through the kernels (a chunk
    # graph) and through the plain step: every table tensor (claim
    # included) and the 14 counters identical; K10 on its own grid and on
    # one block, each with the block path of its tail (cap K10_CAP) and
    # with every round on the grid (cap 0)
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    eng = keyrow_engine(name, cuda, layout, **kw)
    st, ub, fill = eng.st, eng.ub, eng.fill_target
    tab, ctr = warm_keyrow(eng, warm)
    for (n, blocks), cap in itertools.product(((1, 0), (1, 1), (8, 0)), (S.K10_CAP, 0)):
        ka, pa = clone_tab(tab), clone_tab(tab)
        kc = S.run_chunk_keyrow_cuda(st, ka, ctr, n, ub, fill, blocks=blocks, cap=cap)
        pc = E._run_chunk_plain(st, pa, ctr, n, ub, fill, layout, plain_select=True)
        assert_same_tables(st, ka, kc, pa, pc)
        # n steps, or fewer when the search ended inside them
        assert int(kc[2]) == int(ctr[2]) + n or int(kc[1]) >= int(kc[0]) > 0


@pytest.mark.parametrize("name,layout,warm,kw", [
    ("globin6", "packed", 60, {}), ("kinase.fasta", "unpacked", 150, {}),
    ("synth10", "packed", 20, dict(capacity=1 << 20))])
def test_k9_settles_home_matches_and_k10_equals_plain(cuda, name, layout, warm, kw):
    # the smoke's step windows: one step of K9 -> K10 (eager and graph, K10
    # at its cap and at 0) against the plain step; on the packed layout K9
    # settles the lanes whose home row holds their key, so K10's list
    # (state[kNPend]) is shorter than the surviving lanes (state[kNValid],
    # the counters' lanes); on the unpacked layout every lane is pending
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    eng = keyrow_engine(name, cuda, layout, **kw)
    st, ub, fill = eng.st, eng.ub, eng.fill_target
    assert eng.layout == layout
    tab, ctr = warm_keyrow(eng, warm)
    pa = clone_tab(tab)
    pc = E._run_chunk_plain(st, pa, ctr, 1, ub, fill, layout, plain_select=True)
    for graph, cap in itertools.product((False, True), (S.K10_CAP, 0)):
        ka = clone_tab(tab)
        kc = S.run_chunk_keyrow_cuda(st, ka, ctr, 1, ub, fill, cap=cap, graph=graph)
        assert_same_tables(st, ka, kc, pa, pc)
        s_ = S._step_buffers(st, ka.t_key.device, layout).state.tolist()
        n_valid, n_pend = s_[S.STATE_NVALID], s_[S.STATE_NPEND]
        assert n_valid == int(kc[9]) - int(ctr[9]) > 0
        if layout == "unpacked":
            assert n_pend == n_valid
        elif name == "globin6":
            assert 0 < n_pend < n_valid
        else:
            assert n_pend <= n_valid


_K10_ENGINES = {}


def k10_list(cuda, layout, n, n_front, seed, seqs="kinase.fasta"):
    """A key-row table of 2^12 slots (batch 128) of ``seqs`` (a golden
    input or a tuple of sequences) with about 900 stored keys, and a
    pending list of ``n`` entries over them whose first ``n_front`` are
    received rows (their tags: places; the others' from n_front up, in
    random order): repeated keys, keys sharing a home slot, stored keys;
    packed h and word, or unpacked g and f * 2^n + mask.  Returns
    (statics, table, rows on the card)."""
    from mpi_pastar_msa_tpu_torch.search import engine as E

    eng = _K10_ENGINES.get((seqs, layout))
    if eng is None:
        eng = _K10_ENGINES[seqs, layout] = keyrow_engine(seqs, cuda, layout, batch=128,
                                                         capacity=1 << 12, triples="off")
    st = eng.st
    rng = np.random.default_rng(seed)
    final = st.final_np
    pool = np.unique(np.stack([rng.integers(0, int(v) + 1, 4000) for v in final], 1), axis=0)
    rng.shuffle(pool)
    keys = E._pack_keys(torch.from_numpy(pool), st.W)
    home = (E._hash_keys(keys) & (st.C - 1)).numpy()
    tab = eng._init_table()
    stored = pool[:900]
    sk = E._pack_keys(torch.from_numpy(stored), st.W).to(cuda)
    if layout == "packed":
        E._insert_core_packed(st, tab, sk, torch.full((900,), 7, device=cuda),
                              torch.full((900,), 3000 << st.nb, device=cuda) | 1)
    else:
        g = torch.from_numpy(rng.integers(1000, 1100, 900)).to(cuda)
        E._insert_core(st, tab, sk, g, g + 500, torch.ones(900, dtype=torch.int64, device=cuda))
        tab.t_state[:st.C][(tab.t_state[:st.C] == 1)
                          & (torch.rand(st.C, device=cuda) < 0.33)] = 2
    # distinct keys: stored ones, groups sharing a home slot, fresh ones
    _, first, cnt = np.unique(home, return_index=True, return_counts=True)
    shared = np.flatnonzero(np.isin(home, home[first[cnt >= 2]]))[:60]
    distinct = np.concatenate([np.arange(150), shared, np.arange(1000, 4000)])
    coords = pool[rng.permutation(np.repeat(distinct, rng.integers(1, 4, len(distinct))))][:n]
    ck = E._pack_keys(torch.from_numpy(coords), st.W)
    tag = torch.from_numpy(n_front + rng.permutation(4 * max(n, 1))[:n])
    if layout == "packed":
        tail = [torch.from_numpy(coords.sum(1) * 7),
                torch.from_numpy((rng.integers(0, 4000, n) << st.nb) | rng.integers(1, 32, n))]
    else:
        g = torch.from_numpy(rng.integers(1000, 1100, n))
        fpar = (g + 1000) * (1 << st.nb) + torch.from_numpy(rng.integers(1, st.M + 1, n))
        tail = [g, E._as_i32(fpar & 0xFFFFFFFF).long(), fpar >> 32]
    rows = torch.cat([E._as_i32(ck).long(), E._as_i32(E._hash_keys(ck)).long()[:, None],
                      tag[:, None]] + [t[:, None] for t in tail], 1).to(torch.int32)
    return st, tab, rows.to(cuda)


@pytest.mark.parametrize("received", ["none", "some", "only"])
@pytest.mark.parametrize("n", [64, "cap-1", "cap", "cap+1"])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_k10_list_lengths_equal_plain(cuda, layout, n, received):
    # K10 (keyrow_insert: no received rows) and K10s (keyrow_insert_recv)
    # over lists of 64 entries and around K10_CAP, eager and in a CUDA
    # graph, at K10_CAP (the whole list in block 0 up to the cap, round 0
    # on the grid above) and at cap 0 (every round on the grid): every
    # table word, the claim words, the 14 counters and the rounds those of
    # insert_pending_plain and finish_plain, bit for bit
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    n = n if isinstance(n, int) else S.K10_CAP + {"cap-1": -1, "cap": 0, "cap+1": 1}[n]
    n_front = {"none": 0, "some": n // 3, "only": n}[received]
    st, tab0, rows = k10_list(cuda, layout, n, n_front, n + len(received))
    lanes, fill = n - n_front, 64
    want = clone_tab(tab0)
    ovf, reopen, rounds, un, tail = SH.insert_pending_plain(st, want, layout, rows, n_front)
    c0 = torch.as_tensor(E.fresh_counters(), device=cuda)
    c0[0] = 5000
    want_c = c0.clone()
    SH.finish_plain(want_c, [0, 900, 40, 3 + reopen, 1200], fill, lanes, ovf, rounds, un, tail)
    assert rounds >= (2 if n < 1000 else 4) and ovf == 0
    bufs = S.StepBuffers.for_step(st, cuda, layout)
    bufs.pend[:n].copy_(rows)
    state0 = torch.zeros_like(bufs.state)
    state0[S.STATE_NOPEN], state0[S.STATE_NSEL], state0[S.STATE_REOPEN] = 900, 40, 3
    state0[S.STATE_FMIN], state0[S.STATE_NVALID], state0[S.STATE_NPEND] = 1200, lanes, n
    recv = torch.tensor([n_front], dtype=torch.int32, device=cuda)
    tab, ctr = clone_tab(tab0), c0.clone()

    def restore():
        for name, x in vars(tab).items():
            x.copy_(getattr(tab0, name))
        ctr.copy_(c0)
        bufs.state.copy_(state0)
        bufs.run.fill_(1)

    for cap, graph in itertools.product((S.K10_CAP, 0), (False, True)):
        if received == "none":  # the single table's entry, on the current stream
            go = lambda: _kernels.launch(*S._keyrow_insert_args(
                st, tab, bufs, ctr, fill, 0, cap, torch.cuda.current_stream().cuda_stream))
        else:
            go = functools.partial(S.insert_pending_cuda, st, tab, bufs, ctr, fill, n_front,
                                   recv, cap=cap)
        restore()
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                go()
            restore()
            g.replay()
        else:
            go()
        torch.cuda.synchronize()
        assert_same_tables(st, tab, ctr, want, want_c)
        assert int(bufs.state[S.STATE_CALLS]) == rounds
        path = S.k10_path(n, rounds, un, cap)
        assert path == ("block" if cap and n <= cap else "tail" if cap and un <= cap
                        else "grid"), (cap, n, un, path)


def test_k10_packed_int4_rows_of_two_equal_plain(cuda):
    # N = 13 (W = 7: packed rows of 8 words, two int4 each) over a list of
    # 300 entries, some received: K10 at K10_CAP (one block) and at cap 0
    # (the grid) against insert_pending_plain and finish_plain
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    seqs = family(13, 13, 24, 0.05)  # close: the packed word's f spread fits 18 bits
    n, n_front = 300, 40
    st, tab0, rows = k10_list(cuda, "packed", n, n_front, 5, seqs)
    assert st.W == 7 and tab0.t_key.shape[1] == 8
    want = clone_tab(tab0)
    ovf, reopen, rounds, un, tail = SH.insert_pending_plain(st, want, "packed", rows, n_front)
    c0 = torch.as_tensor(E.fresh_counters(), device=cuda)
    c0[0] = 5000
    want_c = c0.clone()
    SH.finish_plain(want_c, [0, 900, 40, 3 + reopen, 1200], 64, n - n_front, ovf, rounds, un,
                    tail)
    assert rounds >= 2 and ovf == 0
    bufs = S.StepBuffers.for_step(st, cuda, "packed")
    bufs.pend[:n].copy_(rows)
    recv = torch.tensor([n_front], dtype=torch.int32, device=cuda)
    for cap in (S.K10_CAP, 0):
        tab, ctr = clone_tab(tab0), c0.clone()
        bufs.state.zero_()
        bufs.state[S.STATE_NOPEN], bufs.state[S.STATE_NSEL] = 900, 40
        bufs.state[S.STATE_REOPEN], bufs.state[S.STATE_FMIN] = 3, 1200
        bufs.state[S.STATE_NVALID], bufs.state[S.STATE_NPEND] = n - n_front, n
        bufs.run.fill_(1)
        S.insert_pending_cuda(st, tab, bufs, ctr, 64, n_front, recv, cap=cap)
        torch.cuda.synchronize()
        assert_same_tables(st, tab, ctr, want, want_c)
        assert int(bufs.state[S.STATE_CALLS]) == rounds


def test_keyrow_n16_packed_and_degenerate_equal_plain(cuda, monkeypatch):
    # N = 16 (tests/test_torch_layouts.py::test_n16_packed_eligibility's
    # family, a beam-1 bound): 65535 masks a row; and the degenerate input
    # on the unpacked layout, negative costs, from its first step to its end
    from mpi_pastar_msa_tpu_torch.search import bounds
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    ub = bounds.greedy_upper_bound
    monkeypatch.setattr(E, "greedy_upper_bound", lambda p, h, beam, ub=ub: ub(p, h, beam=1))
    eng = keyrow_engine(family(163, 16, 5, 0.25), cuda, "packed", capacity=1 << 14, batch=16)
    assert eng.st.n == 16 and eng.layout == "packed"
    tab, ctr = warm_keyrow(eng, 0)
    for n in (1, 4):
        ka, pa = clone_tab(tab), clone_tab(tab)
        kc = S.run_chunk_keyrow_cuda(eng.st, ka, ctr, n, eng.ub, eng.fill_target)
        pc = E._run_chunk_plain(eng.st, pa, ctr, n, eng.ub, eng.fill_target, "packed",
                                plain_select=True)
        assert_same_tables(eng.st, ka, kc, pa, pc)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = keyrow_engine(("WYWY", "WYY", "YWW"), cuda, "auto", batch=16, capacity=1 << 12)
    assert eng.layout == "unpacked"
    st = eng.st
    ka, kc = warm_keyrow(eng, 0)
    pa, pc = clone_tab(ka), kc
    for _ in range(20):
        kc = S.run_chunk_keyrow_cuda(st, ka, kc, 4, eng.ub, eng.fill_target)
        pc = E._run_chunk_plain(st, pa, pc, 4, eng.ub, eng.fill_target, "unpacked",
                                plain_select=True)
        assert_same_tables(st, ka, kc, pa, pc)
        if int(kc[1]) >= int(kc[0]):
            break
    assert int(kc[1]) >= int(kc[0]) and int(kc[0]) < 0 and int(kc[4]) > 0


@pytest.mark.parametrize("name,layout,warm", [("PF08184.fasta", "packed", 4),
                                              ("kinase.fasta", "unpacked", 40),
                                              ("synth7", "packed", 20)])
def test_keyrow_graph_chunk_equals_eager_chunk(cuda, name, layout, warm):
    from mpi_pastar_msa_tpu_torch.search import step as S

    # as test_graph_chunk_equals_eager_chunk, on the key-row layouts:
    # PF08184 (packed) reaches its goal in the middle of a chunk
    eng = keyrow_engine(name, cuda, layout)
    tab, ctr = warm_keyrow(eng, warm)
    select = "select_best" if layout == "packed" else "select_best_unpacked"
    mid = graph_vs_eager(S.run_chunk_keyrow_cuda, eng.st, tab, ctr, eng.ub, eng.fill_target,
                         (select, "keyrow_expand", "keyrow_insert"), clone_tab)
    assert mid or name != "PF08184.fasta"


def test_keyrow_wrappers_reject_bad_input(cuda):
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    eng = keyrow_engine("PF08184.fasta", cuda, "packed", batch=64, capacity=1 << 12)
    st, tab = eng.st, eng._init_table()
    ctr = torch.as_tensor(E.fresh_counters(), device=cuda)
    before = dict(_kernels.launches)
    bad = [E.PackedTable(tab.t_key.cpu(), tab.t_best, tab.t_closed, tab.claim),
           E.PackedTable(tab.t_key[:, :2].contiguous(), tab.t_best, tab.t_closed, tab.claim),
           E.PackedTable(tab.t_key, tab.t_best.long(), tab.t_closed, tab.claim),
           E.PackedTable(tab.t_key, tab.t_best, tab.t_closed, tab.claim[:100]),
           E.SigTable(tab.t_best, tab.t_best, tab.t_closed)]
    for t in bad:
        with pytest.raises(ValueError):
            S.run_chunk_keyrow_cuda(st, t, ctr, 1, eng.ub, eng.fill_target)
    with pytest.raises(ValueError):
        S.run_chunk_keyrow_cuda(st, tab, ctr.cpu(), 1, eng.ub, eng.fill_target)
    with pytest.raises(ValueError):
        S.select_open_cuda(st, tab.t_best, tab.t_best, 10, 0)  # t_fpar not int64
    assert _kernels.launches == before


@pytest.mark.parametrize("name,layout,expanded,reopened,steps", [
    ("globin6", "auto", 170120, 52953, 154), ("synth7", "auto", 28604, 3045, 122)])
def test_keyrow_end_to_end_counts(cuda, name, layout, expanded, reopened, steps):
    # the packed main path through K3, K9 and K10 under the chunk graph:
    # the plain step's counts (PR 9's), the certified optimum
    _kernels.reset_counts()
    eng = keyrow_engine(name, cuda, layout)
    res = eng.run()
    assert eng.layout == "packed"
    assert res.g == {"globin6": 988171, "synth7": 402469}[name]
    assert (res.nodes_expanded, res.nodes_reopened, res.steps) == (expanded, reopened, steps)
    n = _kernels.launches["keyrow_insert"]
    assert n == _kernels.launches["keyrow_expand"] == _kernels.launches["select_best"] > 0
    assert eng.graph_captures == 1
    assert _kernels.launches["path_walk"] == 1  # the walk: K7, once a run


# ------------------------------------------------------------ K7, the walk

def planted_walk(n, layout, seed, device, far=False):
    """Statics of a random n-sequence problem on ``device`` and a table of
    its layout holding a planted path from the goal to the origin (random
    nonzero parent masks), each node at its first free probe position from
    a random one in 0 .. 3 (``far``: in 32 .. 39, the second half of K7's
    rows), behind other keys (sig: other words of its rows; key rows: other
    coordinates), and random other entries: (statics, CPU table, the
    path's masks)."""
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search import engine as E

    rs = np.random.RandomState(seed)
    seqs = tuple("".join(rs.choice(list(AMINO), size=rs.randint(3, 9))) for _ in range(n))
    p = Problem(seqs)
    st = E._Static(p, HPairHeuristic.build(p, device), 16, 1 << 16, device)
    size, nb = st.C + E.TRASH, st.nb
    full = lambda v, *shape, dtype=torch.int32: torch.full((size,) + shape, v, dtype=dtype)
    tab = {"sig": lambda: E.SigTable(full(-1), full(E.INFP), full(E.INFP)),
           "packed": lambda: E.PackedTable(full(-1, st.KW), full(E.INFP), full(E.INFP),
                                           full(E.INFP)),
           "unpacked": lambda: E.UnpackedTable(full(-1, st.W), full(E.INF),
                                               full(E.INF << nb, dtype=torch.int64),
                                               torch.zeros(size, dtype=torch.int32),
                                               full(E.INFP))}[layout]()
    word = (tab.t_fpar if layout == "unpacked" else tab.t_best)
    coord, masks = st.final_np.astype(np.int64).copy(), []
    while coord.any():
        live = np.flatnonzero(coord)
        pick = live[rs.rand(len(live)) < 0.5]
        mask = int(sum(1 << int(d) for d in (pick if len(pick) else live[:1])))
        c = torch.as_tensor(coord)[None, :]
        r = rs.randint(32, 40) if far else rs.randint(0, 4)
        if layout == "sig":
            home, sigb = (int(v[0]) for v in E._sig_encode(st, c))
            for q in range(r):  # other keys' words in the rows before
                row = ((home + q) & (st.nbuck - 1)) * 8
                ways = [w for w in range(8) if int(tab.t_sig[row + w]) == -1]
                if ways:
                    tab.t_sig[row + ways[0]] = (rs.randint(1, 1 << 20) << 6) | q
            while True:
                row = ((home + r) & (st.nbuck - 1)) * 8
                ways = [w for w in range(8) if int(tab.t_sig[row + w]) == -1]
                if ways:
                    slot = row + ways[rs.randint(len(ways))]
                    tab.t_sig[slot] = sigb | r
                    break
                r += 1
        else:
            key = E._pack_keys(c, st.W)
            h0 = int(E._hash_keys(key)[0])
            for q in range(r):  # other coordinates' rows before
                s_ = int(E._probe_slot(h0, q, st.C - 1))
                if int(tab.t_key[s_, 0]) == -1:
                    tab.t_key[s_, :st.W] = E._as_i32(E._pack_keys(c + 70000, st.W)[0])
            while int(tab.t_key[int(E._probe_slot(h0, r, st.C - 1)), 0]) != -1:
                r += 1
            slot = int(E._probe_slot(h0, r, st.C - 1))
            tab.t_key[slot, :st.W] = E._as_i32(key[0])
        word[slot] = (rs.randint(0, 1000) << nb) | mask
        masks.append(mask)
        coord = coord - ((mask >> np.arange(n)) & 1)
    return st, tab, np.array(masks, dtype=np.int64)


@pytest.mark.parametrize("layout,n,far", [
    ("sig", 3, False), ("sig", 5, False), ("sig", 8, False), ("packed", 3, False),
    ("packed", 8, False), ("packed", 12, False), ("packed", 16, False),
    ("unpacked", 4, False), ("unpacked", 9, False), ("unpacked", 16, False),
    # every first hit in the second half of the warp's rows
    ("sig", 5, True), ("packed", 8, True), ("unpacked", 16, True)])
def test_k7_walk_equals_plain(cuda, layout, n, far):
    # K7 on planted tables against _walk on the same card tensors: the
    # same masks and final coordinate; then with one node's entry made
    # another key's, where both end there
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    st, tab, want = planted_walk(n, layout, 100 + n, cuda, far)
    assert layout != "sig" or st.sig_ok
    ctab = type(tab)(*(t.to(cuda) for t in vars(tab).values()))
    before = _kernels.launches["path_walk"]
    got, coord = S.walk_cuda(st, ctab, layout)
    assert _kernels.launches["path_walk"] == before + 1
    ref, ref_coord = E._walk(st, ctab, layout)
    assert np.array_equal(got, want) and np.array_equal(ref, want)
    assert not coord.any() and not ref_coord.any()
    # break the path at its middle node
    k = len(want) // 2
    node = st.final_np.astype(np.int64).copy()
    for m in want[:k]:
        node -= (int(m) >> np.arange(n)) & 1
    if layout == "sig":
        home, sigb = (int(v[0]) for v in E._sig_encode(st, torch.as_tensor(node)[None, :]))
        rows = ((home + np.arange(64)) & (st.nbuck - 1)) * 8
        sl = torch.as_tensor((rows[:, None] + np.arange(8)).reshape(-1), device=cuda)
        hit = ctab.t_sig[sl] == torch.as_tensor(np.repeat(sigb | np.arange(64), 8), device=cuda,
                                                 dtype=torch.int32)
        ctab.t_sig[sl[hit]] ^= 1 << 6
    else:
        key = E._pack_keys(torch.as_tensor(node)[None, :], st.W)
        sl = E._probe_slot(E._hash_keys(key)[0], torch.arange(128), st.C - 1).to(cuda)
        hit = (ctab.t_key[sl, :st.W] == E._as_i32(key).to(cuda)).all(1)
        ctab.t_key[sl[hit], 0] ^= 1
    got, coord = S.walk_cuda(st, ctab, layout)
    ref, ref_coord = E._walk(st, ctab, layout)
    assert np.array_equal(got, want[:k]) and np.array_equal(ref, got)
    assert np.array_equal(coord, node) and np.array_equal(ref_coord, node)


@pytest.mark.parametrize("name,layout", [("PF08184.fasta", "sig"), ("test2.fasta", "packed"),
                                         ("test.fasta", "unpacked")])
def test_k7_runs_on_the_main_path(cuda, name, layout, monkeypatch):
    # a run on the card walks with K7, once, and never with _walk
    from mpi_pastar_msa_tpu_torch.search import engine as E

    plain = []
    real = E._walk
    monkeypatch.setattr(E, "_walk", lambda *a: plain.append(a) or real(*a))
    _kernels.reset_counts()
    eng = keyrow_engine(name, cuda, layout)
    res = eng.run()
    assert res.g == golden_problem(name)[0]["optimal_g"]
    assert _kernels.launches["path_walk"] == 1 and not plain
    (exp, _, n_closed, n_open), = res.shard_stats
    assert n_open == res.open_size and len(res.closed) <= n_closed <= exp


def test_walk_cuda_rejects_bad_input(cuda):
    from mpi_pastar_msa_tpu_torch.search import engine as E
    from mpi_pastar_msa_tpu_torch.search import step as S

    st, tab, _ = planted_walk(5, "packed", 7, cuda)
    ctab = type(tab)(*(t.to(cuda) for t in vars(tab).values()))
    ust, utab, _ = planted_walk(5, "unpacked", 7, cuda)
    cutab = type(utab)(*(t.to(cuda) for t in vars(utab).values()))
    before = dict(_kernels.launches)
    bad = [(st, tab, "packed"),  # CPU tensors
           (st, ctab, "sig"), (st, ctab, "unpacked"), (st, ctab, "bucketed"),
           (st, E.PackedTable(ctab.t_key[:, :2].contiguous(), ctab.t_best, ctab.t_closed,
                              ctab.claim), "packed"),
           (st, E.PackedTable(ctab.t_key, ctab.t_best.long(), ctab.t_closed, ctab.claim),
            "packed"),
           (st, E.PackedTable(ctab.t_key, ctab.t_best[:100], ctab.t_closed, ctab.claim),
            "packed"),
           (ust, E.UnpackedTable(cutab.t_key, cutab.t_g, cutab.t_fpar.int(), cutab.t_state,
                                 cutab.claim), "unpacked")]
    for s_, t, lay in bad:
        with pytest.raises(ValueError):
            S.walk_cuda(s_, t, lay)
    assert _kernels.launches == before


def gotoh_pairs(lengths, seed):
    """Dash-prefixed random pairs of the given lengths, with their (n, m)."""
    rs = np.random.RandomState(seed)
    enc = [np.concatenate([[ord("-")], rs.choice(np.frombuffer(AMINO.encode(), np.uint8),
                                                 size=L)]).astype(np.int32)
           for L in lengths]
    pairs = [(enc[i], enc[j]) for i in range(len(enc)) for j in range(len(enc)) if i != j]
    return pairs, [(len(a) - 1, len(b) - 1) for a, b in pairs]


@pytest.mark.parametrize("lengths,seed", [
    ((4, 23, 9, 17), 1), ((1, 40), 2), ((1, 1), 3), ((60, 60, 60), 4),
    # row-band boundaries: l1 = 1024 (R = 1), 1025 (R = 2), 2101 (R = 3)
    ((1023, 700), 5), ((1024, 1), 6), ((2100, 30), 7),
    # transpose tiles: l1 = 33 (a second, one-row tile), equal lengths at
    # l1 = 1024 and 1025, two rows a thread on pairs of every shape
    ((32, 32, 7), 8), ((1023, 1023), 9), ((1024, 1024, 500), 10),
    ((1500, 1499, 3), 11),
])
def test_k8_kernel_equals_plain_and_host(cuda, lengths, seed):
    from mpi_pastar_msa_tpu_torch.heuristic.gotoh_wavefront import (
        gotoh_inputs, gotoh_matrices, gotoh_matrices_device, gotoh_matrices_plain)
    from mpi_pastar_msa_tpu_torch.heuristic.weights import _gotoh_pair_matrices

    pairs, lens = gotoh_pairs(lengths, seed)
    args = gotoh_inputs(pairs, lens, cuda)
    before = _kernels.launches["gotoh_wavefront"]
    got = gotoh_matrices(**args)
    assert _kernels.launches["gotoh_wavefront"] == before + 1
    want = gotoh_matrices_plain(**args).cpu()
    assert torch.equal(got.cpu(), want)
    boxes = gotoh_matrices_device(pairs, lens, cuda)
    assert _kernels.launches["gotoh_wavefront"] == before + 2
    for k, ((a, b), (n, m), mats) in enumerate(zip(pairs, lens, boxes)):
        assert all(np.array_equal(x, want[c, k, : n + 1, : m + 1].numpy())
                   for c, x in enumerate(mats))
        if len(a) * len(b) <= 200_000:  # the host fill is slow beyond
            assert all(np.array_equal(x, y) for x, y in
                       zip(mats, _gotoh_pair_matrices(a, b)))


def test_k8_wrapper_rejects_bad_input(cuda):
    from mpi_pastar_msa_tpu_torch.heuristic.gotoh_wavefront import (
        gotoh_inputs, gotoh_matrices)

    pairs, lens = gotoh_pairs((5, 7), 8)
    good = gotoh_inputs(pairs, lens, cuda)
    before = _kernels.launches["gotoh_wavefront"]
    for bad in (dict(good, seq_a=good["seq_a"].long()),
                dict(good, n1s=good["n1s"].cpu()),
                dict(good, l1=good["l1"] + 1),
                dict(good, n2s=good["n2s"] + good["l1"]),
                dict(good, seq_b=good["seq_b"][:1].contiguous())):
        with pytest.raises(ValueError):
            gotoh_matrices(**bad)
    assert _kernels.launches["gotoh_wavefront"] == before


@pytest.mark.parametrize("name", ["PF08184.fasta", "kinase.fasta"])
def test_hpair_weights_on_card_equal_host(cuda, name):
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic

    gold, p = golden_problem(name)
    _kernels.reset_counts()
    h = HPairHeuristic.build(p, cuda)
    assert _kernels.launches["gotoh_wavefront"] == 1
    wf, wi = altschul_rationale2(p.seqs)
    assert np.array_equal(h.weight_f, wf) and np.array_equal(h.weight_i, wi)
    assert np.array_equal(h.weight_i, np.array(gold["weights_int"]))


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_host_driver_and_checkpoint_on_card(cuda, tmp_path, layout):
    from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment
    from mpi_pastar_msa_tpu_torch.search.engine import FrontierSearch

    gold, p = golden_problem("PF08184.fasta")
    h = HPairHeuristic.build(p, cuda)
    args = dict(device=cuda, batch=64, capacity=1 << 12, chunk_steps=4, triples="off",
                layout=layout)
    whole = FrontierSearch(p, h, **args).run()
    # the host driver: one step a dispatch, the same kernels enqueued
    # eagerly (no chunk graph), the same search
    _kernels.reset_counts()
    eng = FrontierSearch(p, h, driver="host", **args)
    res = eng.run()
    assert (res.g, res.steps, res.nodes_expanded, res.closed) == (
        gold["optimal_g"], whole.steps, whole.nodes_expanded, whole.closed)
    assert eng.graph_captures == 0
    k3 = "select_best_unpacked" if layout == "unpacked" else "select_best"
    assert _kernels.launches[k3] == res.steps
    # interrupted at 12 steps, then resumed by a new engine: its own chunk
    # graph, K7 once, the uninterrupted search
    ckpt = str(tmp_path / "search.ckpt.npz")
    first = FrontierSearch(p, h, max_steps=10, checkpoint_path=ckpt, checkpoint_every=1,
                           **args)
    with pytest.raises(RuntimeError, match="max_steps"):
        first.run()
    _kernels.reset_counts()
    eng = FrontierSearch(p, h, checkpoint_path=ckpt, **args)
    res = eng.run()
    assert eng.resumed_steps == 12 and eng.graph_captures == 1
    assert _kernels.launches["path_walk"] == 1
    assert (res.g, res.steps, res.nodes_expanded, res.closed) == (
        whole.g, whole.steps, whole.nodes_expanded, whole.closed)
    assert build_alignment(p, res.closed) == gold["alignment"]


# --- the sharded engine (parallel/sharded.py) on one card: a LocalMesh of
# [cuda:0] * 4, its kernels against their plain versions


def _sharded_capture(cuda, name="kinase.fasta", at=60, **kw):
    """A sharded search on [cuda] * 4 through ShardedFrontierSearch.run
    under the host driver (the capture reads the card between kernels),
    with shard 1's inputs and outputs of each kernel at step ``at``."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    gold = json.load(open(os.path.join(HERE, "goldens.json")))[name]
    problem = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    cap, shards = {}, []
    methods = {m: getattr(SH._Shard, m) for m in ("select", "expand", "count", "pack")}
    step = [0]

    def select(sh):
        step[0] += sh.me == 0
        if sh not in shards:
            shards.append(sh)
        return methods["select"](sh)

    def expand(sh, eng, h3):
        on = step[0] == at and sh.me == 1
        if on:
            cap.update(sh=sh, eng=eng, h3=None if h3 is None else h3.clone(),
                       t_sig=sh.tab.t_sig.clone(), t_best0=sh.tab.t_best.clone(),
                       sel=sh.bufs.sel.clone(), state0=sh.bufs.state.clone(),
                       ctr0=sh.ctr.clone())
        methods["expand"](sh, eng, h3)
        if on:
            n_pend = int(sh.bufs.state[6])
            cap.update(cand=sh.cand.clone(), t_best1=sh.tab.t_best.clone(),
                       pend=sh.bufs.pend[sh.R:sh.R + n_pend].clone(),
                       state1=sh.bufs.state.clone(), ctr1=sh.ctr.clone())

    def count(sh, eng):
        if step[0] == at and sh.me == 1:
            cap.update(ring=sh.ring.clone(), cand_route=sh.cand.clone(),
                       nsel=int(sh.bufs.state[2]), ring_len=int(sh.ring_len[sh.cur]))
        return methods["count"](sh, eng)

    def pack(sh, eng, S_all):
        methods["pack"](sh, eng, S_all)
        if step[0] == at and sh.me == 1:
            cap.update(S=None if S_all is None else S_all.clone(), wire=sh.wire.clone(),
                       ring1=sh.ring.clone(), route_out=sh.route_out.clone())

    try:
        for m, fn in (("select", select), ("expand", expand), ("count", count), ("pack", pack)):
            setattr(SH._Shard, m, fn)
        _kernels.reset_counts()
        eng = SH.ShardedFrontierSearch(problem, devices=[cuda] * 4, driver="host", **kw)
        res = eng.run()
    finally:
        for m, fn in methods.items():
            setattr(SH._Shard, m, fn)
    return gold, problem, eng, res, cap, shards


def test_sharded_kinase_on_one_card(cuda):
    """Kinase on [cuda] * 4 under ``auto``: JAX's layout and capacity,
    packed at 2^21 slots a shard, the golden g and alignment, every kernel
    of the key-row sharded step launched."""
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment

    gold, problem, eng, res, cap, shards = _keyrow_sharded_capture(cuda, "kinase.fasta", "auto",
                                                                   60)
    assert res.g == gold["optimal_g"]
    assert build_alignment(problem, res.closed) == gold["alignment"]
    assert eng.layout == "packed" and eng.st.C == 1 << 21 and not eng.retries
    assert eng.exchange == "ragged" and eng.cubes_split
    assert res.nodes_migrated > 0
    for k in ("select_best", "keyrow_coords", "tri_partial", "keyrow_expand_sharded",
              "route_count_rows", "route_pack_rows", "keyrow_insert_recv", "path_walk_hops"):
        assert _kernels.launches[k] > 0, k


def test_k4_sharded_and_k11_equal_plain(cuda):
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search.engine import SigTable

    # kinase pinned to the sig layout at the capacity its word takes
    _, _, eng, _, cap, _ = _sharded_capture(cuda, layout="sig", capacity=1 << 23)
    assert eng.layout == "sig"
    sh, st, me, M = cap["sh"], cap["sh"].st, 1, cap["sh"].st.M
    n_sel = int(cap["state0"][2])
    assert n_sel > 0
    tab = SigTable(cap["t_sig"].clone(), cap["t_best0"].clone(), cap["t_sig"].clone())
    goal, cand, pending, n_valid = SH.expand_sharded_plain(st, tab, cap["sel"], n_sel, eng.ub,
                                                           cap["h3"], eng.own, 4, me)
    assert torch.equal(cand[:n_sel * M], cap["cand"][:n_sel * M])
    assert torch.equal(tab.t_best[:st.C], cap["t_best1"][:st.C])
    assert sorted(map(tuple, pending.tolist())) == sorted(map(tuple, cap["pend"].tolist()))
    assert n_valid == int(cap["state1"][5])
    assert min(goal, int(cap["ctr0"][0])) == int(cap["ctr1"][0])
    # K11 as the run launched it (ragged), then dense, on the same inputs
    w, r, o = SH.route_plain(cap["cand_route"], cap["nsel"] * M, cap["ring"], 4, me,
                             eng.exchange_cap, cap["S"])
    assert torch.equal(cap["route_out"], o) and torch.equal(cap["ring1"], r)
    A = SH.route_sizes(cap["S"].cpu().numpy(), 4, eng.exchange_cap, True)[me]
    sent = int(A.sum())
    assert torch.equal(cap["wire"][:sent], w[:sent])
    nsel = torch.tensor(cap["nsel"], dtype=torch.int64, device=cuda)
    ring, wire, out = (torch.empty_like(sh.rings[0]), torch.zeros_like(sh.wire),
                       torch.empty_like(sh.route_out))
    keys = torch.empty_like(sh.keys)
    # the ring's word (its live rows, as the run's own word gives them), and
    # the new ring's: unknown contents
    live = int((cap["ring"][:, 0] < 4).sum())
    assert cap["ring_len"] == live and bool((cap["ring"][:live, 0] < 4).all())
    lens = torch.tensor([live, sh.ccar], dtype=torch.int32, device=cuda)
    counts = torch.zeros((2, 5), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    _kernels.launch("route_count", cap["cand_route"].data_ptr(), cap["ring"].data_ptr(),
                    lens[0].data_ptr(), nsel.data_ptr(), M, cap["cand_route"].shape[0], sh.ccar,
                    4, sh.seg, counts[0].data_ptr(), counts[1].data_ptr(), out.data_ptr(),
                    keys.data_ptr(), None, stream)
    _kernels.launch("route_pack", cap["cand_route"].data_ptr(), cap["ring"].data_ptr(),
                    nsel.data_ptr(), M, sh.ccar, 4, me, eng.exchange_cap, None, sh.seg,
                    counts[0].data_ptr(), out.data_ptr(), keys.data_ptr(), wire.data_ptr(),
                    ring.data_ptr(), lens[1].data_ptr(), None, stream)
    w, r, o = SH.route_plain(cap["cand_route"], cap["nsel"] * M, cap["ring"], 4, me,
                             eng.exchange_cap)
    assert torch.equal(out, o) and torch.equal(ring, r)
    assert int(lens[1]) == int((r[:, 0] < 4).sum())
    for d in range(4):
        n = min(int(o[d]), eng.exchange_cap)
        lo = d * eng.exchange_cap
        assert torch.equal(wire[lo:lo + n], w[lo:lo + n])


def _k4s_forms_equal_plain(cuda, cases, **kw):
    """K4s on kinase pinned to sig (step 60, shard 1's inputs; ``kw`` to
    the engine) in each form of ``cases`` (rows a block, from sig_coords'
    coordinates or decoding the sig words), bit for bit against
    expand_sharded_plain: every candidate word, t_best, the pending
    multiset, the surviving and pending counts and the goal."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import step as S
    from mpi_pastar_msa_tpu_torch.search.engine import SigTable

    _, _, eng, _, cap, _ = _sharded_capture(cuda, layout="sig", capacity=1 << 23, **kw)
    sh, st, me, M = cap["sh"], cap["sh"].st, 1, cap["sh"].st.M
    n_sel = int(cap["state0"][2])
    assert n_sel > 0 and M == 31
    assert (cap["h3"] is None) == (not eng.cubes_split)
    tab = SigTable(cap["t_sig"].clone(), cap["t_best0"].clone(), cap["t_sig"].clone())
    goal, cand, pending, n_valid = SH.expand_sharded_plain(st, tab, cap["sel"], n_sel, eng.ub,
                                                           cap["h3"], eng.own, 4, me)
    coords = SH.sig_coords_plain(st, cap["t_sig"], cap["sel"], n_sel, st.B).to(cuda)
    for rows, with_coords in cases:
        co = coords if with_coords else None
        bufs = S.StepBuffers.select_only(st, cuda)
        bufs.sel, bufs.state = cap["sel"], cap["state0"].clone()
        bufs.run = torch.ones(1, dtype=torch.int32, device=cuda)
        bufs.pend = torch.empty_like(sh.bufs.pend)
        bufs.params = sh.bufs.params
        t = SigTable(cap["t_sig"], cap["t_best0"].clone(), cap["t_sig"])
        ctr, got = cap["ctr0"].clone(), torch.empty_like(sh.cand)
        S.expand_sharded_cuda(st, t, bufs, ctr, eng.ub, cap["h3"], got, sh.R, eng.hash_params,
                              4, me, coords=co, rows=rows)
        torch.cuda.synchronize()
        n_pend = int(bufs.state[6])
        assert torch.equal(got[:n_sel * M], cand[:n_sel * M]), rows
        assert torch.equal(t.t_best[:st.C], tab.t_best[:st.C]), rows
        assert sorted(map(tuple, bufs.pend[sh.R:sh.R + n_pend].tolist())) == sorted(
            map(tuple, pending.tolist())), rows
        assert (int(bufs.state[5]), n_pend) == (n_valid, pending.shape[0]), rows
        assert int(ctr[0]) == min(goal, int(cap["ctr0"][0])), rows


def test_k4s_forms_equal_plain(cuda):
    """K4s with the cubes split (h3 from K12): the warp-strided form (rows
    0) and the rows form at 1, 2, 4 and 8 rows a block, from sig_coords'
    coordinates and decoding the sig words, bit for bit against
    expand_sharded_plain."""
    _k4s_forms_equal_plain(cuda, ((0, False), (1, True), (2, True), (2, False), (4, True),
                                  (8, False)))


def test_k4s_own_cubes_equal_plain(cuda):
    """K4s with the cubes not split (shard_cubes False: no h3, each shard
    reads its own cubes' triangles and corners, no sig_coords): the
    warp-strided form and the rows form at 1, 2, 4 and 8 rows a block,
    decoding the sig words, bit for bit against expand_sharded_plain."""
    _k4s_forms_equal_plain(cuda, ((0, False), (1, False), (2, False), (4, False), (8, False)),
                           shard_cubes=False)


def test_k12_and_coords_equal_plain(cuda):
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    rng = np.random.default_rng(5)
    S, n, T = 30, 5, 3
    cubes = torch.from_numpy(rng.integers(0, 1000, (T, S, S, S)).astype(np.int32)).to(cuda)
    tri = torch.tensor([[0, 1, 2], [1, 3, 4], [0, 2, 4]], dtype=torch.int32, device=cuda)
    coords = torch.from_numpy(rng.integers(-2, S + 3, (777, n)).astype(np.int32)).to(cuda)
    for Tl in (0, 1, 3):
        got = SH._tri_partial_cuda(coords, cubes[:Tl], tri[:Tl] if Tl else None, n, S)
        want = SH.tri_partial_plain(coords, cubes[:Tl], tri[:Tl], 31, S)
        assert torch.equal(got, want)
    _, _, eng, _, _, shards = _sharded_capture(cuda, "test2.fasta", at=5)
    for sh in shards:  # the finished tables: decode a list of open slots
        st = sh.st
        slots = torch.nonzero(sh.tab.t_sig[:st.C] != -1)[:, 0][:st.B].to(torch.int32)
        sel = torch.zeros((st.B, 2), dtype=torch.int32, device=cuda)
        sel[:slots.numel(), 0] = slots
        state = torch.zeros(16, dtype=torch.int64, device=cuda)
        state[2] = slots.numel()
        out = torch.empty((st.B, st.n), dtype=torch.int32, device=cuda)
        bitw = torch.tensor(st.bitw, dtype=torch.int32, device=cuda)
        _kernels.launch("sig_coords", sh.tab.t_sig.data_ptr(), sel.data_ptr(),
                        state[2:3].data_ptr(), bitw.data_ptr(), st.n, st.bbits, st.B,
                        out.data_ptr(), None, torch.cuda.current_stream().cuda_stream)
        assert torch.equal(out, SH.sig_coords_plain(st, sh.tab.t_sig, sel, slots.numel(), st.B))


def test_k7_hop_mode_equals_plain(cuda):
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import step as S

    _, problem, eng, res, _, shards = _sharded_capture(cuda, "PF08184.fasta", at=5)
    path = list(res.closed) + [(0, 0, 0), (1, 1, 0)]
    before = _kernels.launches["path_walk_hops"]
    for sh in shards:
        for coord in path:
            for hops in (1, 8):
                got = S.walk_hops_cuda(sh.st, sh.tab, coord, hops).cpu()
                assert torch.equal(got, SH.walk_hops_plain(sh.st, sh.tab, coord, hops))
    assert _kernels.launches["path_walk_hops"] == before + 2 * len(path) * len(shards)


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_walk_shards_equals_plain(cuda, layout):
    """path_walk_shards on the finished tables of test2 on 4 shards of one
    card (each owner hash) against walk_shards_plain and the host driver's
    walk in rounds: the same masks, coordinate and rounds, from the goal
    and from nodes of the path, and at one hop a round; one launch a
    walk."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    gold = json.load(open(os.path.join(HERE, "goldens.json")))["test2.fasta"]
    problem = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    for ht in ("FZORDER", "PZORDER", "FSUM", "PSUM"):
        eng = SH.ShardedFrontierSearch(problem, devices=[cuda] * 4, layout=layout,
                                       hash_type=ht, driver="host")
        res = eng.run()
        assert res.g == gold["optimal_g"]
        tabs = [sh.tab for sh in sorted(eng.shards, key=lambda sh: sh.me)]
        masks, rounds = eng._walk(eng.shards)
        starts = [tuple(int(v) for v in problem.final_coord)] + list(res.closed)[5::7]
        for start in starts:
            for hops in (SH.WALK_HOPS, 1):
                want = SH.walk_shards_plain(eng.st, tabs, start, layout, eng.own, hops)
                before = _kernels.launches["path_walk_shards"]
                got = SH.walk_shards_cuda(eng.st, tabs, start, layout, eng.hash_params, hops)
                assert _kernels.launches["path_walk_shards"] == before + 1
                assert got == want, (ht, start, hops)
        assert SH.walk_shards_plain(eng.st, tabs, starts[0], layout, eng.own)[::2] == (
            masks, rounds)


INFP = 0x7FFFFFFF  # search/engine.py's empty f


def _k11_inputs(cuda, counts, me, cap, ccar, f_range, seed, ndev=4, M=1):
    """Synthetic K11 inputs with ``counts[d]`` remote rows for destination
    d, split at random between the listed lanes and the carry ring, among
    lanes that stay (dest ndev) and empty ring rows; lanes past the listed
    ones hold remote rows that the kernel must not read.  Returns (cand,
    n_lanes, carry, nsel on the card)."""
    rng = np.random.default_rng(seed)
    dest = np.concatenate([np.full(c, d) for d, c in enumerate(counts)]).astype(np.int64)
    in_ring = rng.random(dest.size) < min(0.3, ccar / max(dest.size, 1))
    in_ring[np.cumsum(in_ring) > ccar] = False
    lane_dest = np.concatenate([dest[~in_ring], np.full(dest.size // 3 + 5, ndev)])
    rng.shuffle(lane_dest)
    n_lanes = -(-lane_dest.size // M) * M
    lanes_cap = n_lanes + 3 * M
    cand = np.zeros((lanes_cap, 4), np.int32)
    cand[:, 0] = ndev
    cand[:lane_dest.size, 0] = lane_dest
    cand[n_lanes:, 0] = 0  # past the listed lanes: never routed
    carry = np.tile(np.array([ndev, INFP, 0, -1], np.int32), (ccar, 1))
    ring_at = rng.permutation(ccar)[:int(in_ring.sum())]
    carry[ring_at, 0] = dest[in_ring]
    for t, live in ((cand, slice(None)), (carry, ring_at)):
        k = t[live].shape[0]
        t[live, 1] = np.where(t[live, 0] < ndev, rng.integers(0, f_range, k), t[live, 1])
        t[live, 2] = np.where(t[live, 0] < ndev, rng.integers(0, 1 << 20, k), t[live, 2])
        t[live, 3] = np.where(t[live, 0] < ndev, rng.integers(0, 1 << 30, k), t[live, 3])
    nsel = torch.tensor(n_lanes // M, dtype=torch.int64, device=cuda)
    return (torch.from_numpy(cand).to(cuda), n_lanes, torch.from_numpy(carry).to(cuda), nsel)


K11_CASES = [
    ("empty_and_one", (0, 1, 0, 0), 8, 64, 1000),
    ("ties", (300, 0, 0, 290), 128, 512, 1),
    ("warp_edges", (31, 32, 0, 33), 16, 64, 50),
    ("kinase_sizes", (636, 1024, 0, 257), 512, 2048, 1 << 20),
    ("shared_limit", (8192, 8193, 0, 5), 7936, 15872, 1 << 16),
    ("halves_limit", (16384, 16385, 0, 300), 7936, 15872, 1 << 16),
    ("whole_shard", (31744, 0, 0, 1), 7936, 15872, 1 << 20),
    ("spill_cap_1", (50, 40, 0, 30), 1, 256, 7),
    ("ring_overflow", (200, 300, 0, 100), 4, 32, 1 << 10),
]

# each K11_CASES destination's block barriers in route_pack's sort (the
# counts tests/test_torch_sharded.py::K11_SHAPES gives the emulation): none
# on one warp (up to 256 keys), 3 at 257-512, 4 at 513-1,024 (the fsort
# range's, the merge rounds', the end's), 6 at 8,192, 15 for the halves
# (8,193-16,384), 8 in device memory (16,385-32,768)
K11_BARRIERS = {"empty_and_one": (0, 0, 0, 0), "ties": (3, 0, 0, 3), "warp_edges": (0, 0, 0, 0),
                "kinase_sizes": (4, 4, 0, 3), "shared_limit": (6, 15, 0, 0),
                "halves_limit": (15, 8, 0, 3), "whole_shard": (8, 0, 0, 0),
                "spill_cap_1": (0, 0, 0, 0), "ring_overflow": (0, 3, 0, 0)}


def _k11_run(cuda, case, counts, cap, ccar, f_range, ragged, pack=None):
    """One synthetic K11 case (_k11_inputs, me = 2 of 4 shards, the ragged
    send counts random but for this shard's) through route_count and
    route_pack (``pack``: another build's C entry in place of the port's),
    twice on the same buffers (the count buffers in turns, the carry's
    word all its rows: its live rows lie anywhere; the new ring's word
    first its whole length, a buffer of unknown contents), each time
    against route_plain bit for bit: out, the new ring, its word and the
    wire rows sent.  Returns the plain out."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    ndev, me, M = 4, 2, 1
    cand, n_lanes, carry, nsel = _k11_inputs(cuda, counts, me, cap, ccar, f_range, len(case))
    lanes_cap = cand.shape[0]
    seg = 1 << max(1, (lanes_cap + ccar - 1).bit_length())
    Smat = None
    if ragged:
        rng = np.random.default_rng(7)
        Sm = rng.integers(0, 3 * cap, (ndev, ndev)).astype(np.int32)
        Sm[me] = counts
        Smat = torch.from_numpy(Sm).to(cuda)
    w_p, r_p, o_p = SH.route_plain(cand, n_lanes, carry, ndev, me, cap, Smat)
    assert [int(v) for v in o_p[:ndev]] == list(counts)
    A = SH.route_sizes((Smat.cpu().numpy() if ragged
                        else np.tile(np.array(counts), (ndev, 1))), ndev, cap, ragged)[me]
    base = np.cumsum(A) - A if ragged else np.arange(ndev) * cap
    sent = torch.cat([torch.arange(int(b), int(b) + int(a)) for a, b in zip(A, base)]
                     ).long().to(cuda)
    keys = torch.empty(2 * ndev * seg, dtype=torch.int64, device=cuda)
    out = torch.empty(ndev + 3, dtype=torch.int32, device=cuda)
    wire = torch.zeros((max(ndev * cap, lanes_cap + ccar), 3), dtype=torch.int32, device=cuda)
    ring = torch.empty_like(carry)
    lens = torch.tensor([ccar, ccar], dtype=torch.int32, device=cuda)  # carry's, ring's
    tally = torch.zeros((2, ndev + 1), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for p in range(2):
        _kernels.launch("route_count", cand.data_ptr(), carry.data_ptr(), lens[0].data_ptr(),
                        nsel.data_ptr(), M, lanes_cap, ccar, ndev, seg, tally[p].data_ptr(),
                        tally[1 - p].data_ptr(), out.data_ptr(), keys.data_ptr(), None, stream)
        args = (cand.data_ptr(), carry.data_ptr(), nsel.data_ptr(), M, ccar, ndev, me, cap,
                None if Smat is None else Smat.data_ptr(), seg, tally[p].data_ptr(),
                out.data_ptr(), keys.data_ptr(), wire.data_ptr(), ring.data_ptr(),
                lens[1].data_ptr(), None, stream)
        if pack is None:
            _kernels.launch("route_pack", *args)
        else:
            assert pack(*args) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, o_p), (out.tolist(), o_p.tolist())
        assert torch.equal(ring, r_p)
        assert int(lens[1]) == int((r_p[:, 0] < ndev).sum())
        assert torch.equal(wire[sent], w_p[sent])
    return o_p


@pytest.mark.parametrize("case,counts,cap,ccar,f_range", K11_CASES)
@pytest.mark.parametrize("ragged", [False, True])
def test_k11_equals_plain_synthetic(cuda, case, counts, cap, ccar, f_range, ragged):
    """K11 (route_count, route_pack) against route_plain bit for bit: out,
    the new ring and the wire rows sent, twice on the same buffers, under
    the dense and the ragged allowance; segments on both sides of a warp's
    keys and of each shared-memory limit (two buffers, the halves), ties
    broken by position, spills with cap 1 and a ring too small for them."""
    o_p = _k11_run(cuda, case, counts, cap, ccar, f_range, ragged)
    ndev = 4
    if case == "spill_cap_1":
        assert int(o_p[ndev + 1]) == 0 and int(o_p[ndev + 2]) < INFP
    if case == "ring_overflow":
        assert int(o_p[ndev + 1]) > 0


@pytest.fixture(scope="module")
def k11_barrier_build(tmp_path_factory):
    """route_pack.cu built with -DK11_BARRIERS: its route_pack and
    route_pack_barriers (each destination's block barriers, last launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    lib = str(tmp_path_factory.mktemp("k11") / "libroute_pack_barriers.so")
    subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-DK11_BARRIERS", "-o", lib,
                    os.path.join(_kernels.CSRC, "route_pack.cu")], check=True)
    dll = ctypes.CDLL(lib)
    pack, barriers = dll.route_pack, dll.route_pack_barriers
    pack.argtypes, pack.restype = _kernels.SIGNATURES["route_pack"], ctypes.c_int
    barriers.argtypes, barriers.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    return pack, barriers


@pytest.mark.parametrize("case,counts,cap,ccar,f_range", K11_CASES)
def test_k11_barriers_counted(cuda, k11_barrier_build, case, counts, cap, ccar, f_range):
    """The K11_BARRIERS build routes as route_plain, and each destination's
    sort executes the block barriers of K11_BARRIERS."""
    pack, barriers = k11_barrier_build
    _k11_run(cuda, case, counts, cap, ccar, f_range, True, pack)
    got = (ctypes.c_int * 4)()
    assert barriers(ctypes.cast(got, ctypes.c_void_p), 4) == 0
    assert tuple(got) == K11_BARRIERS[case]


# --- the sharded engine on key rows (the packed and unpacked layouts) on
# one card: K9s, K11 on key rows, K10 on the received rows, K7's hop mode
# and keyrow_coords against their plain versions


def _keyrow_sharded_capture(cuda, name, layout, at, **kw):
    """A sharded search of ``layout`` on [cuda] * 4 through
    ShardedFrontierSearch.run under the host driver, with shard 1's inputs
    and outputs of K9s, K11 and K10 at step ``at``; ``name`` a golden input
    or a tuple of sequences (then no golden)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import step as TS

    if isinstance(name, tuple):
        gold, problem = None, Problem(name)
    else:
        gold = json.load(open(os.path.join(HERE, "goldens.json")))[name]
        problem = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    cap, shards, step = {}, [], [0]
    methods = {m: getattr(SH._Shard, m) for m in ("select", "expand", "count", "pack")}
    insert = TS.insert_pending_cuda
    clone = lambda tab: type(tab)(*(getattr(tab, f).clone() for f in tab.__dataclass_fields__))

    def on(sh):
        return step[0] == at and sh.me == 1

    def select(sh):
        step[0] += sh.me == 0
        if sh not in shards:
            shards.append(sh)
        return methods["select"](sh)

    def expand(sh, eng, h3):
        if on(sh):
            cap.update(sh=sh, eng=eng, h3=None if h3 is None else h3.clone(), tab0=clone(sh.tab),
                       sel=sh.bufs.sel.clone(), state0=sh.bufs.state.clone(),
                       ctr0=sh.ctr.clone())
        methods["expand"](sh, eng, h3)
        if on(sh):
            n_pend = int(sh.bufs.state[6])
            cap.update(cand=sh.cand.clone(), tab1=clone(sh.tab),
                       pend=sh.bufs.pend[sh.R:sh.R + n_pend].clone(),
                       state1=sh.bufs.state.clone(), ctr1=sh.ctr.clone())

    def count(sh, eng):
        if on(sh):
            cap.update(ring=sh.ring.clone(), nsel=int(sh.bufs.state[2]))
        return methods["count"](sh, eng)

    def pack(sh, eng, S_all):
        methods["pack"](sh, eng, S_all)
        if on(sh):
            cap.update(S=None if S_all is None else S_all.clone(), wire=sh.wire.clone(),
                       ring1=sh.ring.clone(), route_out=sh.route_out.clone())

    def insert_pending(st, tab, bufs, ctr, fill, pend_at, recv, **kw2):
        me = "sh" in cap and on(cap["sh"]) and tab is cap["sh"].tab
        if me:
            n, n_front = int(bufs.state[6]), int(recv[0])
            at = pend_at - n_front
            cap.update(k10_tab0=clone(tab), k10_ctr0=ctr.clone(), k10_state0=bufs.state.clone(),
                       k10_rows=bufs.pend[at:at + n].clone(), n_front=n_front, fill=fill)
        insert(st, tab, bufs, ctr, fill, pend_at, recv, **kw2)
        if me:
            cap.update(k10_tab1=clone(tab), k10_ctr1=ctr.clone(), k10_state1=bufs.state.clone())

    try:
        for m, fn in (("select", select), ("expand", expand), ("count", count), ("pack", pack)):
            setattr(SH._Shard, m, fn)
        TS.insert_pending_cuda = insert_pending
        _kernels.reset_counts()
        eng = SH.ShardedFrontierSearch(problem, devices=[cuda] * 4, layout=layout,
                                       driver="host", **kw)
        res = eng.run()
    finally:
        for m, fn in methods.items():
            setattr(SH._Shard, m, fn)
        TS.insert_pending_cuda = insert
    return gold, problem, eng, res, cap, shards


KEYROW_SHARDED = ("select_best", "keyrow_expand_sharded", "route_count_rows", "route_pack_rows",
                  "keyrow_insert_recv", "path_walk_hops")


@pytest.mark.parametrize("exchange", ["ragged", "dense"])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("name", ["PF08184.fasta", "test2.fasta"])
def test_sharded_keyrow_on_one_card(cuda, name, layout, exchange):
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment

    gold, problem, eng, res, cap, shards = _keyrow_sharded_capture(cuda, name, layout, 3,
                                                                   exchange=exchange)
    assert eng.layout == layout and eng.exchange == exchange
    assert res.g == gold["optimal_g"]
    assert build_alignment(problem, res.closed) == gold["alignment"]
    want = list(KEYROW_SHARDED)
    if layout == "unpacked":
        want[0] = "select_best_unpacked"
    elif eng.cubes_split:
        want += ["keyrow_coords", "tri_partial"]
    for k in want:
        assert _kernels.launches[k] > 0, k
    for k in ("keyrow_expand", "keyrow_insert", "sig_expand_sharded", "sig_probe"):
        assert _kernels.launches[k] == 0, k


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_k9s_k11_rows_k10_recv_equal_plain(cuda, layout):
    """On a random input of 4 x 12-16 residues (batch 16, FSUM with no
    shift: a wide, migrating frontier) pinned to ``layout`` on four shards
    of one card, shard 1's step 6 (6 rows received from the other
    shards): K9s against its plain
    version (candidate rows, t_best after the round-0 match, the pending
    entries as a multiset, the surviving lanes, the goal); K11 on key rows
    as the run launched it and under the dense allowance (out, new ring,
    rows sent); K10 over the received rows and the self-owned lanes against
    insert_pending_plain and finish_plain: every table tensor, the claim
    words, the 14 counters and the rounds."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    rs = np.random.RandomState(31)
    seqs = tuple("".join(rs.choice(list(AMINO), size=rs.randint(12, 17))) for _ in range(4))
    _, _, eng, _, cap, _ = _keyrow_sharded_capture(cuda, seqs, layout, 6, batch=16,
                                                   hash_shift=0)
    sh, st, me, M = cap["sh"], cap["sh"].st, 1, cap["sh"].st.M
    n_sel = int(cap["state0"][2])
    assert n_sel > 0 and cap["n_front"] > 0
    tab = type(cap["tab0"])(*(getattr(cap["tab0"], f).clone()
                              for f in cap["tab0"].__dataclass_fields__))
    goal, cand, pending, n_valid = SH.expand_keyrow_sharded_plain(
        st, tab, layout, cap["sel"], n_sel, eng.ub, cap["h3"], eng.own, 4, me, sh.tag_base)
    L = n_sel * M
    assert torch.equal(cand[:L], cap["cand"][:L])
    for f in tab.__dataclass_fields__:
        assert torch.equal(getattr(tab, f)[:st.C], getattr(cap["tab1"], f)[:st.C]), f
    srt = lambda t: sorted(map(tuple, t.tolist()))
    assert srt(pending) == srt(cap["pend"])
    assert n_valid == int(cap["state1"][5]) and pending.shape[0] == int(cap["state1"][6])
    assert min(goal, int(cap["ctr0"][0])) == int(cap["ctr1"][0])
    # K11 on key rows, as launched (the run's allowance), then dense
    fill = sh.fill
    w, r, o = SH.route_plain(cap["cand"], cap["nsel"] * M, cap["ring"], 4, me, eng.exchange_cap,
                             cap["S"], fill)
    assert torch.equal(cap["route_out"], o) and torch.equal(cap["ring1"], r)
    A = SH.route_sizes(cap["S"].cpu().numpy() if cap["S"] is not None else
                       o[:4].long().repeat(4, 1).cpu().numpy(), 4, eng.exchange_cap,
                       cap["S"] is not None)[me]
    if cap["S"] is not None:
        assert torch.equal(cap["wire"][:int(A.sum())], w[:int(A.sum())])
    # K10 over [received; self-owned]
    tab = type(cap["k10_tab0"])(*(getattr(cap["k10_tab0"], f).clone()
                                  for f in cap["k10_tab0"].__dataclass_fields__))
    ctr = cap["k10_ctr0"].clone()
    s0 = cap["k10_state0"]
    ovf, reopen, rounds, un, tail = SH.insert_pending_plain(st, tab, layout, cap["k10_rows"],
                                                            cap["n_front"])
    state = [0, int(s0[1]), int(s0[2]), int(s0[3]) + reopen, int(s0[4])]
    SH.finish_plain(ctr, state, cap["fill"], int(s0[5]), ovf, rounds, un, tail)
    for f in tab.__dataclass_fields__:
        assert torch.equal(getattr(tab, f)[:st.C], getattr(cap["k10_tab1"], f)[:st.C]), f
    assert torch.equal(ctr, cap["k10_ctr1"]), (ctr.tolist(), cap["k10_ctr1"].tolist())
    assert int(cap["k10_state1"][7]) == rounds


def _k11_rows_inputs(cuda, counts, cap, ccar, f_range, seed, layout, W=3, ndev=4):
    """_k11_inputs on key rows: rows of 2 + W + 4 (packed) or 2 + W + 5
    (unpacked) words, random payloads, unpacked f from -f_range / 4 up;
    the empty rows of the layout (sharded.keyrow_fill's)."""
    from mpi_pastar_msa_tpu_torch.search.engine import INF

    cand4, n_lanes, carry4, nsel = _k11_inputs(cuda, counts, 2, cap, ccar, f_range, seed)
    pw = W + (4 if layout == "packed" else 5)
    empty = INFP if layout == "packed" else INF
    fill = [ndev, empty] + [-1] * W + [0] * (pw - W)
    rng = np.random.default_rng(seed + 1)

    def widen(t4):
        t = t4.cpu().numpy()
        rows = np.tile(np.array(fill, np.int64), (t.shape[0], 1))
        rows[:, 0] = t[:, 0]
        live = t[:, 0] < ndev
        f = t[:, 1].astype(np.int64)
        if layout == "unpacked":
            f = f - f_range // 4
        rows[live, 1] = f[live]
        rows[live, 2:] = rng.integers(-2**31, 2**31 - 1, (int(live.sum()), pw))
        return torch.from_numpy(rows.astype(np.int32)).to(cuda)

    return widen(cand4), n_lanes, widen(carry4), nsel, fill


@pytest.mark.parametrize("case,counts,cap,ccar,f_range",
                         [c for c in K11_CASES if c[0] != "whole_shard"])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_k11_rows_equal_plain_synthetic(cuda, layout, case, counts, cap, ccar, f_range, ragged):
    """K11 on key rows (route_count_rows, route_pack_rows) against
    route_plain bit for bit: out, the new ring, its word and the wire rows
    sent, twice on the same buffers, under both allowances; unpacked rows
    with negative f; spills with cap 1 and a ring too small for them.
    Then steps on two ring buffers in turns, as a shard's, each step's
    carry the ring the last wrote, with its word, under the dense
    allowance at caps that make the ring grow, empty and grow again (the
    empty row refilled over only the rows the buffer held live): every
    word of each new ring, its word, out and the rows sent."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    ndev, me, M = 4, 2, 1
    cand, n_lanes, carry, nsel, fill = _k11_rows_inputs(cuda, counts, cap, ccar, f_range,
                                                        len(case), layout)
    width = cand.shape[1]
    lanes_cap = cand.shape[0]
    seg = 1 << max(1, (lanes_cap + ccar - 1).bit_length())
    Smat = None
    if ragged:
        rng = np.random.default_rng(7)
        Sm = rng.integers(0, 3 * cap, (ndev, ndev)).astype(np.int32)
        Sm[me] = counts
        Smat = torch.from_numpy(Sm).to(cuda)
    w_p, r_p, o_p = SH.route_plain(cand, n_lanes, carry, ndev, me, cap, Smat, fill)
    A = SH.route_sizes((Smat.cpu().numpy() if ragged
                        else np.tile(np.array(counts), (ndev, 1))), ndev, cap, ragged)[me]
    base = np.cumsum(A) - A if ragged else np.arange(ndev) * cap
    sent = torch.cat([torch.arange(int(b), int(b) + int(a)) for a, b in zip(A, base)]
                     ).long().to(cuda)
    keys = torch.empty(2 * ndev * seg, dtype=torch.int64, device=cuda)
    out = torch.empty(ndev + 3, dtype=torch.int32, device=cuda)
    wire = torch.zeros((max(ndev * cap, lanes_cap + ccar), width - 2), dtype=torch.int32,
                       device=cuda)
    ring = torch.empty_like(carry)
    stream = torch.cuda.current_stream().cuda_stream
    tally = torch.zeros((2, ndev + 1), dtype=torch.int32, device=cuda)

    def step(p, cap, carry, carry_len, ring, ring_len, S=None):
        _kernels.launch("route_count_rows", cand.data_ptr(), carry.data_ptr(),
                        carry_len.data_ptr(), nsel.data_ptr(), M, lanes_cap, ccar, ndev, seg,
                        width, 3, fill[1], tally[p].data_ptr(), tally[1 - p].data_ptr(),
                        out.data_ptr(), keys.data_ptr(), None, stream)
        _kernels.launch("route_pack_rows", cand.data_ptr(), carry.data_ptr(), nsel.data_ptr(), M,
                        ccar, ndev, me, cap, None if S is None else S.data_ptr(), seg, width, 3,
                        fill[1], tally[p].data_ptr(), out.data_ptr(), keys.data_ptr(),
                        wire.data_ptr(), ring.data_ptr(), ring_len.data_ptr(), None, stream)
        torch.cuda.synchronize()

    # the carry's live rows lie anywhere (its word: every row), the new ring
    # is of unknown contents (its word: its whole length)
    lens = torch.tensor([ccar, ccar], dtype=torch.int32, device=cuda)
    for p in range(2):
        step(p, cap, carry, lens[0], ring, lens[1], Smat)
        assert torch.equal(out, o_p), (out.tolist(), o_p.tolist())
        assert torch.equal(ring, r_p)
        assert int(lens[1]) == int((r_p[:, 0] < ndev).sum())
        assert torch.equal(wire[sent], w_p[sent])
    if case == "ring_overflow":
        assert int(o_p[ndev + 1]) > 0
    # two rings in turns; a cap that drains the ring, and cap 1 that fills it
    drain = max(counts) + ccar
    wire = torch.zeros((ndev * drain, width - 2), dtype=torch.int32, device=cuda)
    rings = [ring, torch.empty_like(carry)]
    words = torch.tensor([int(lens[1]), ccar], dtype=torch.int32, device=cuda)
    kept = []
    for t, c in enumerate((1, drain, cap, 1, drain, 1)):
        a, b = t % 2, 1 - t % 2
        w_p, r_p, o_p = SH.route_plain(cand, n_lanes, rings[a], ndev, me, c, None, fill)
        step(t % 2, c, rings[a], words[a], rings[b], words[b])
        live = int((r_p[:, 0] < ndev).sum())
        assert torch.equal(out, o_p), (t, out.tolist(), o_p.tolist())
        assert torch.equal(rings[b], r_p), t
        assert int(words[b]) == live, (t, int(words[b]), live)
        for d in range(ndev):
            n = min(int(o_p[d]), c)
            assert torch.equal(wire[d * c:d * c + n], w_p[d * c:d * c + n]), (t, d)
        kept.append(live)
    assert kept[1] == 0 and kept[4] == 0, kept
    if sum(max(c - 1, 0) for c in counts):  # cap 1 spills: the ring grows again
        assert min(kept[0], kept[3], kept[5]) > 0, kept


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_k7_hop_mode_keyrow_and_coords_equal_plain(cuda, layout):
    """K7's hop mode on every shard's finished key-row table from every path
    node (and nodes no shard holds), against walk_hops_plain; on the packed
    tables keyrow_coords against keyrow_coords_plain on a list of stored
    slots."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import step as TS

    _, problem, eng, res, _, shards = _keyrow_sharded_capture(cuda, "PF08184.fasta", layout, 5)
    path = list(res.closed) + [(0, 0, 0), (1, 1, 0), (999, 0, 0)]
    before = _kernels.launches["path_walk_hops"]
    for sh in shards:
        for coord in path:
            for hops in (1, 8):
                got = TS.walk_hops_cuda(sh.st, sh.tab, coord, hops, layout).cpu()
                assert torch.equal(got, SH.walk_hops_plain(sh.st, sh.tab, coord, hops, layout))
    assert _kernels.launches["path_walk_hops"] == before + 2 * len(path) * len(shards)
    if layout != "packed":
        return
    for sh in shards:
        st = sh.st
        slots = torch.nonzero(sh.tab.t_key[:st.C, 0] != -1)[:, 0][:st.B].to(torch.int32)
        sel = torch.zeros((st.B, 2), dtype=torch.int32, device=cuda)
        sel[:slots.numel(), 0] = slots
        state = torch.zeros(16, dtype=torch.int64, device=cuda)
        state[2] = slots.numel()
        out = torch.empty((st.B, st.n), dtype=torch.int32, device=cuda)
        _kernels.launch("keyrow_coords", sh.tab.t_key.data_ptr(), sh.tab.t_key.shape[1],
                        sel.data_ptr(), state[2:3].data_ptr(), st.n, st.B, out.data_ptr(),
                        None, torch.cuda.current_stream().cuda_stream)
        assert torch.equal(out, SH.keyrow_coords_plain(st, sh.tab.t_key, sel, slots.numel(),
                                                       st.B))


# --- the sharded loop on the card (csrc/shard_loop.cu, K6s): consensus,
# exchange and walk_advance against their plain versions, and a chunk
# graph of the whole mesh against the host driver


def _loop_reports(rng, ndev, cap, unpacked, case, nb=5, f0=1000):
    """Random reports (ndev, 7 + ndev + 3) int64 as _Shard.report gives
    them; ``case`` as tests/test_torch_sharded_loop.py's."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search.engine import INF

    rep = np.zeros((ndev, SH.R_ROUTE + ndev + 3), np.int64)
    rep[:, SH.R_GOAL] = np.where(rng.random(ndev) < 0.5, INF, rng.integers(f0, f0 + 400, ndev))
    rep[:, SH.R_NOPEN] = rng.integers(0, 5000, ndev)
    rep[:, SH.R_NSEL] = rng.integers(0, 64, ndev)
    rep[:, SH.R_REOPEN] = rng.integers(0, 5, ndev)
    rep[:, SH.R_FMIN] = np.where(rng.random(ndev) < 0.2, INF, rng.integers(f0, f0 + 300, ndev))
    route = rep[:, SH.R_ROUTE:]
    route[:, :ndev] = rng.integers(0, 3 * cap, (ndev, ndev))
    route[:, ndev] = rng.integers(0, 5 * cap, ndev)
    ring = (rng.integers(f0 - 50, f0 + 300, ndev) if unpacked
            else (rng.integers(0, 300, ndev) << nb) | rng.integers(1, 1 << nb, ndev))
    empty = INF if unpacked else INFP
    route[:, ndev + 2] = np.where(rng.random(ndev) < 0.3, empty, ring)
    if case == "empty_ring":
        route[:, ndev + 2] = empty
    if case == "table_ovf":
        rep[rng.integers(ndev), SH.R_OVF] = 3
    if case == "carry_ovf":
        route[rng.integers(ndev), ndev + 1] = 2
    return rep


@pytest.mark.parametrize("case", ["plain", "table_ovf", "carry_ovf", "empty_ring", "stopped"])
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_consensus_kernel_equals_plain(cuda, layout, ragged, case):
    """consensus on 1, 2, 4, 8, 31 and 32 shards (every shard a target, and
    on 4 and 8 shards some targets only: one card's shards of several)
    against consensus_plain on the same card tensors, bit for bit: the
    consensus vector, every target's counters, state, received count and
    flag, and the run flag; twice in a row (the telemetry adds up); the
    reports gathered (one row a shard) or read where they lie (each
    shard's counters, state and route out, three addresses a shard)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search import step as TS

    rng = np.random.default_rng(7)
    for ndev, local, gathered in ((1, [0], True), (2, [0, 1], True), (4, [0, 1, 2, 3], True),
                                  (4, [1, 3], True), (32, list(range(32)), True),
                                  (4, [2, 0, 3, 1], False), (32, list(range(32)), False),
                                  (8, list(range(8)), True), (8, [6, 1, 4], True),
                                  (8, [7, 0, 5, 2, 3, 6, 1, 4], False), (8, [6, 1, 4], False),
                                  (4, [3], False), (31, list(range(31)), True),
                                  (31, list(range(30, -1, -1)), False), (1, [0], False),
                                  (2, [1, 0], False)):
        cap, nb, f0 = 40, 5, 1000
        outs = []
        reps = [_loop_reports(rng, ndev, cap, layout == "unpacked", case) for _ in range(2)]
        state0 = rng.integers(0, 500, (ndev, TS.STATE_WORDS))
        ctr0 = rng.integers(0, 100, (ndev, 14))
        for use_kernel in (True, False):
            words = [(torch.as_tensor(ctr0[me], device=cuda),
                      torch.as_tensor(state0[me], device=cuda),
                      torch.zeros(ndev + 3, dtype=torch.int32, device=cuda),
                      torch.zeros(1, dtype=torch.int32, device=cuda),
                      torch.zeros(1, dtype=torch.int32, device=cuda)) for me in range(ndev)]
            tg = [(c, s, r, g, me) for me, (c, s, _, r, g) in enumerate(words) if me in local]
            tg.sort(key=lambda t: local.index(t[4]))
            cons = SH.fresh_cons(ndev, cuda)
            run = torch.full((1,), int(case != "stopped"), dtype=torch.int32, device=cuda)
            tgt = SH.target_table(tg, cuda)
            for rep in reps:
                reports = torch.as_tensor(rep, device=cuda)
                if not gathered:  # each report's words where they lie
                    for me, (ctr, state, out, _, _) in enumerate(words):
                        ctr[0], ctr[6] = reports[me, SH.R_GOAL], reports[me, SH.R_OVF]
                        state[:5] = reports[me, 2:SH.R_ROUTE]
                        out.copy_(reports[me, SH.R_ROUTE:])
                    reports = [w[:3] for w in words]
                args = (ndev, cap, ragged, layout, nb, f0, 777, run)
                if use_kernel:
                    SH.consensus_cuda(SH.report_table(reports), *args, tgt, cons)
                else:
                    SH.consensus_plain(reports, *args, tg, cons)
            torch.cuda.synchronize()
            outs.append([cons, run] + [t for x in tg for t in x[:4]])
        for a, b in zip(*outs):
            assert torch.equal(a, b), (ndev, local, gathered, a.tolist(), b.tolist())


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_exchange_kernel_equals_plain(cuda, ragged):
    """exchange against exchange_plain on random sizes and wires of 3, 7
    (kinase's packed wire), 9, 13 and 16 (EXCHANGE_ROW_WORDS) words a row,
    on 2, 3, 4, 8, 31 and 32 shards, on some of the receivers: a receiver's
    flag 0, a second receiver with its flag at 1 that gets rows at every
    row width, and in the cases of three receivers or more a last one that
    gets 0 rows from every sender."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    rng = np.random.default_rng(3)
    for ndev, pw, cap, recv_me in ((4, 3, 50, [0, 1, 2, 3]), (4, 13, 200, [3, 1]),
                                   (2, 9, 7, [0, 1]), (32, 3, 5, list(range(32))),
                                   (4, 7, 600, [0, 1, 2, 3]), (8, 7, 40, list(range(8))),
                                   (31, 7, 9, list(range(0, 31, 2))), (3, 13, 30, [0, 1, 2]),
                                   (4, 16, 100, [2, 0, 3]), (2, 16, 9, [1, 0])):
        counts = rng.integers(0, 3 * cap, (ndev, ndev))
        if len(recv_me) >= 3:
            counts[:, recv_me[-1]] = 0  # nothing for the last receiver
        A = SH.route_sizes(counts, ndev, cap, ragged)
        assert A[:, recv_me[1]].sum() > 0, (ndev, pw)  # flag 1 and rows to copy
        R = ndev * cap
        cons = SH.fresh_cons(ndev, cuda)
        SH.cons_sizes(cons, ndev)[:] = torch.as_tensor(A, device=cuda)
        wires = [torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (max(R, 3 * cap * ndev), pw)),
                                 dtype=torch.int32, device=cuda) for _ in range(ndev)]
        outs = []
        for use_kernel in (True, False):
            pends = [torch.full((R + 64, pw), -5, dtype=torch.int32, device=cuda)
                     for _ in recv_me]
            flags = [torch.ones(1, dtype=torch.int32, device=cuda) for _ in recv_me]
            flags[0].zero_()
            if use_kernel:
                SH.exchange_cuda(cons, ndev, cap, ragged, R, pw,
                                 SH.exchange_table(wires, pends, flags, recv_me))
            else:
                SH.exchange_plain(cons, ndev, cap, ragged, R, wires, pends, flags, recv_me)
            torch.cuda.synchronize()
            outs.append(pends)
        for a, b in zip(*outs):
            assert torch.equal(a, b), (ndev, pw, recv_me)
        assert (outs[0][0] == -5).all() and (outs[0][1] != -5).any()
        assert len(recv_me) < 3 or (outs[0][-1] == -5).all()


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("pw", [7, 13])
def test_exchange_kernel_received_equals_plain(cuda, ndev, pw):
    """exchange with ``received`` (a rank of a ProcessMesh: sender i's rows
    at row i cap of the rank's buffer after the dense all-to-all) against
    exchange_plain on the same buffer and against exchange_plain over the
    senders' own wires, every rank a receiver (one launch a rank, as each
    rank's graph holds it), random dense sizes and wires, bit for bit; a
    ragged launch with ``received`` is refused."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.parallel.mesh import LocalMesh

    rng = np.random.default_rng(ndev * 10 + pw)
    cap = 300
    counts = rng.integers(0, 2 * cap, (ndev, ndev))
    A = SH.route_sizes(counts, ndev, cap, False)
    R = ndev * cap
    cons = SH.fresh_cons(ndev, cuda)
    SH.cons_sizes(cons, ndev)[:] = torch.as_tensor(A, device=cuda)
    wires = [torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (R + 5 * cap, pw)),
                             dtype=torch.int32, device=cuda) for _ in range(ndev)]
    recv = LocalMesh([cuda] * ndev).all_to_all([w[:R].view(ndev, cap, pw) for w in wires])
    recv = [r.view(R, pw) for r in recv]
    for r in range(ndev):
        flag = torch.ones(1, dtype=torch.int32, device=cuda)
        outs = []
        for way in ("kernel", "plain", "senders"):
            pend = torch.full((R + 64, pw), -5, dtype=torch.int32, device=cuda)
            if way == "kernel":
                SH.exchange_cuda(cons, ndev, cap, False, R, pw,
                                 SH.exchange_table([recv[r]] * ndev, [pend], [flag], [r]),
                                 received=True)
            elif way == "plain":
                SH.exchange_plain(cons, ndev, cap, False, R, [recv[r]] * ndev, [pend], [flag],
                                  [r], received=True)
            else:
                SH.exchange_plain(cons, ndev, cap, False, R, wires, [pend], [flag], [r])
            torch.cuda.synchronize()
            outs.append(pend)
        assert A[:, r].sum() > 0 and (outs[0] != -5).any()
        for o in outs[1:]:
            assert torch.equal(outs[0], o), (ndev, pw, r)
    xtab = SH.exchange_table([recv[0]] * ndev, [pend], [flag], [0])
    with pytest.raises(ValueError):
        SH.exchange_cuda(cons, ndev, cap, True, R, pw, xtab, received=True)


@pytest.mark.parametrize("form", ["buffer", "by_address", "graph"])
@pytest.mark.parametrize("stop", WALK_STOPS)
@pytest.mark.parametrize("n,hops,ndev", WALK_SHAPES)
def test_walk_advance_kernel_equals_plain(cuda, n, hops, ndev, stop, form):
    """walk_advance against walk_advance_plain over the rounds of a seeded
    walk until its flag clears, and two rounds more: masks, coordinate,
    counts and flag bit for bit after every round, at three shapes and
    every stop.  The runs are the rows of one buffer, or each shard's own
    tensor (the several-card walk's form: the kernel reads each by its
    address), or (``graph``) the rows of one buffer that a kernel ahead of
    walk_advance writes from the staged rounds, every round captured into
    one CUDA graph with a copy of the walk state after it, replayed once:
    each walk_advance node's one incoming edge is then a programmatic edge
    from that kernel."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.search.step import _capture
    from mpi_pastar_msa_tpu_torch.utils.graph import last_node_edges

    state, runs = walk_case(7 * n + hops + ndev, n, hops, ndev, stop)
    rounds = runs + [np.zeros_like(runs[0])] * 2
    plain = [torch.from_numpy(a.copy()) for a in state]
    want = []
    for out in rounds:
        SH.walk_advance_plain(torch.from_numpy(out), hops, n, *plain)
        want.append(torch.cat([t.clone() for t in plain]))
    kern = [torch.from_numpy(a.copy()).to(cuda) for a in state]
    got = torch.zeros((len(rounds), want[0].numel()), dtype=torch.int32, device=cuda)
    words = np.cumsum([0] + [t.numel() for t in kern])

    def snapshot(k):
        for t, lo, hi in zip(kern, words[:-1], words[1:]):
            got[k, lo:hi].copy_(t)

    if form == "graph":
        staged = torch.from_numpy(np.stack(rounds)).to(cuda)
        buf = torch.zeros((ndev, hops + n + 1), dtype=torch.int32, device=cuda)
        wtab = SH.run_table(buf, hops, n)
        zero = torch.zeros((), dtype=torch.int32, device=cuda)
        # the C entry's first call loads its library: not in the capture
        SH.walk_advance_cuda(wtab, hops, n, *[t.clone() for t in kern])
        torch.cuda.synchronize()
        edges = []

        def fn():
            for k in range(len(rounds)):
                torch.add(staged[k], zero, out=buf)
                SH.walk_advance_cuda(wtab, hops, n, *kern)
                edges.append(last_node_edges(torch.cuda.current_stream()))
                snapshot(k)

        graph = _capture(fn)
        graph.replay()
        torch.cuda.synchronize()
        assert all(e == [("kernel", "programmatic", e[0][2])] for e in edges), edges
    else:
        bufs = ([torch.zeros(hops + n + 1, dtype=torch.int32, device=cuda)
                 for _ in range(ndev)] if form == "by_address" else
                torch.zeros((ndev, hops + n + 1), dtype=torch.int32, device=cuda))
        wtab = SH.run_table(bufs, hops, n)
        for k, out in enumerate(rounds):
            for i in range(ndev):
                bufs[i].copy_(torch.from_numpy(out[i]))
            SH.walk_advance_cuda(wtab, hops, n, *kern)
            snapshot(k)
        torch.cuda.synchronize()
    for k, w in enumerate(want):
        assert torch.equal(got[k].cpu(), w), (k, len(runs))
    assert int(want[-1][-1]) == 0


def _loop_words(eng):
    """Every tensor a shard's step leaves that does not depend on the order
    lanes run in (tests/test_torch_sharded_loop.py's shard_words)."""
    from mpi_pastar_msa_tpu_torch.search import step as TS

    out = []
    for sh in eng.shards:
        out += [(f"{sh.me}.{f}", getattr(sh.tab, f)) for f in sh.tab.__dataclass_fields__]
        out += [(f"{sh.me}.{k}", t) for k, t in (
            ("ctr", sh.ctr), ("state", sh.state[:TS.STATE_CNT]), ("ring0", sh.rings[0]),
            ("ring1", sh.rings[1]), ("cur", torch.tensor(sh.cur)), ("recv", sh.recv),
            ("go", sh.go), ("route_out", sh.route_out), ("cand", sh.cand), ("wire", sh.wire),
            ("ring_len", sh.ring_len), ("tally", sh.tally))]
    return out + [("cons", eng.cards[0].cons)]


def _drivers(cuda, problem, devices=None, **kw):
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    runs = []
    for driver in ("chunked", "host"):
        eng = SH.ShardedFrontierSearch(problem, devices=devices or [cuda] * 4, driver=driver,
                                       **kw)
        try:
            res = eng.run()
        except RuntimeError as e:
            assert "max_steps exceeded" in str(e)
            res = None
        torch.cuda.synchronize()
        runs.append((eng, res))
    return runs


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
@pytest.mark.parametrize("name", ["PF08184.fasta", "test2.fasta"])
def test_sharded_graph_chunks_equal_host_driver(cuda, name, layout):
    """PF08184 and test2 on [cuda] * 4 in chunks of 16 steps, each one CUDA
    graph (the run stops inside one), against the host driver: the golden
    g, the same result, stats and every table tensor bit for bit; the
    walk, one launch of path_walk_shards on one card, gives the host
    walk's masks and rounds in one read."""
    gold = json.load(open(os.path.join(HERE, "goldens.json")))[name]
    problem = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    _kernels.reset_counts()
    (ce, cr), (he, hr) = _drivers(cuda, problem, layout=layout, chunk_steps=16)
    assert cr.g == hr.g == gold["optimal_g"]
    assert (cr.closed, cr.steps, cr.shard_stats) == (hr.closed, hr.steps, hr.shard_stats)
    for (k, a), (_, b) in zip(_loop_words(ce), _loop_words(he)):
        assert torch.equal(a, b), k
    cs = ce.last_stats
    assert cs["driver"] == "chunked" and cs["graph_replays"] == 16 * cs["host_reads"]
    assert cs["host_reads"] == -(-cr.steps // 16) and cs["graph_captures"] == 2
    assert cs["walk_form"] == "launch" and cs["walk_reads"] == 1
    assert cs["walk_rounds"] == he.last_stats["walk_rounds"]
    for k in ("consensus", "exchange", "path_walk_shards"):
        assert _kernels.launches[k] > 0, k
    assert _kernels.launches["walk_advance"] == 0


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_sharded_graph_chunks_of_7_equal_host_driver(cuda, layout):
    """A random input whose one-row wire spills into the carry rings, 43
    steps on [cuda] * 4, ragged, in chunks of 7 replays of the two step
    graphs (the run stops in mid-chunk, at an odd step), against the host
    driver: the optimum, the same result and every table tensor and ring
    bit for bit; two captures, 7 replays a host read."""
    rs = np.random.RandomState(31)
    problem = Problem(tuple("".join(rs.choice(list(AMINO), size=rs.randint(12, 17)))
                            for _ in range(4)))
    (ce, cr), (he, hr) = _drivers(cuda, problem, layout=layout, exchange_cap=1,
                                  hash_type="FZORDER", hash_shift=0, batch=16, chunk_steps=7,
                                  exchange="ragged")
    assert cr.steps == hr.steps == 43 and (cr.g, cr.shard_stats) == (hr.g, hr.shard_stats)
    assert ce.last_stats["peak_carry"] == he.last_stats["peak_carry"] > 0
    for (k, a), (_, b) in zip(_loop_words(ce), _loop_words(he)):
        assert torch.equal(a, b), k
    cs = ce.last_stats
    assert cs["graph_captures"] == 2 and cs["host_reads"] == -(-43 // 7)
    assert cs["graph_replays"] == 7 * cs["host_reads"]


def test_sharded_kinase_graph_chunk_equals_host_driver(cuda):
    """Kinase on [cuda] * 4 (JAX's packed at 2^21, ragged): one 64-step
    chunk as one CUDA graph against 64 steps of the host driver, every
    table tensor, ring, counter and telemetry word bit for bit."""
    gold = json.load(open(os.path.join(HERE, "goldens.json")))["kinase.fasta"]
    problem = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    (ce, _), (he, _) = _drivers(cuda, problem, chunk_steps=64, max_steps=64)
    assert ce.layout == "packed" and ce.exchange == "ragged"
    assert ce.last_stats["steps"] == he.last_stats["steps"] == 64
    assert ce.last_stats["graph_replays"] == 64 and ce.last_stats["graph_captures"] == 2
    assert ce.last_stats["host_reads"] == 1 and he.last_stats["host_reads"] == 64
    for (k, a), (_, b) in zip(_loop_words(ce), _loop_words(he)):
        assert torch.equal(a, b), k


def test_sharded_rank_form_kinase_chunk_equals_host_driver(cuda, monkeypatch):
    """Kinase on [cuda] * 4 in the rank form (``_rank_form`` replaced: a
    card a shard, the mesh's collectives as copies, the step graph a
    ProcessMesh rank captures), packed at 2^21, dense: one 256-step chunk,
    256 replays of each rank's two parity graphs (all four ranks in one
    graph a parity on this card), against 256 steps of the host driver's
    card form, every table tensor, ring, counter and telemetry word bit
    for bit; every rank's consensus vector the same; one host read; the
    loop kernels launched, the exchange from the received blocks."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    gold = json.load(open(os.path.join(HERE, "goldens.json")))["kinase.fasta"]
    problem = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    kw = dict(chunk_steps=256, max_steps=256, exchange="dense")
    with monkeypatch.context() as m:
        m.setattr(SH, "_rank_form", lambda mesh: True)
        _kernels.reset_counts()
        ce = SH.ShardedFrontierSearch(problem, devices=[cuda] * 4, driver="chunked", **kw)
        with pytest.raises(RuntimeError, match="max_steps exceeded"):
            ce.run()
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
    he = SH.ShardedFrontierSearch(problem, devices=[cuda] * 4, driver="host", **kw)
    with pytest.raises(RuntimeError, match="max_steps exceeded"):
        he.run()
    torch.cuda.synchronize()
    assert ce.layout == "packed" and not ce.card_form and he.card_form
    assert len(ce.cards) == 4 and ce.cards[0].recv is not None
    cs = ce.last_stats
    assert cs["steps"] == he.last_stats["steps"] == 256
    assert cs["graph_captures"] == 2 and cs["graph_replays"] == 256 and cs["host_reads"] == 1
    for (k, a), (_, b) in zip(_loop_words(ce), _loop_words(he)):
        assert torch.equal(a, b), k
    assert all(torch.equal(c.cons, ce.cards[0].cons) for c in ce.cards)
    for k in ("consensus", "exchange"):
        assert counts[k] > 0, k


def test_sharded_rank_form_kinase_ragged_chunk_equals_host_driver(cuda, monkeypatch):
    """Kinase on [cuda] * 4 in the rank form (``_rank_form`` replaced: the
    step graph a ProcessMesh rank captures), packed at 2^21, ragged (auto
    on cards): one 256-step chunk, every rank's exchange reading the
    senders' wires by address (the mesh's ``map_peers``; no received
    blocks), against 256 steps of the host driver in the same form and of
    the host driver's card form, every table tensor, ring, counter and
    telemetry word bit for bit; one host read for the chunk, none inside
    the host driver's steps (one a step)."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    gold = json.load(open(os.path.join(HERE, "goldens.json")))["kinase.fasta"]
    problem = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    kw = dict(chunk_steps=256, max_steps=256)
    runs = {}
    with monkeypatch.context() as m:
        m.setattr(SH, "_rank_form", lambda mesh: True)
        for driver in ("chunked", "host"):
            _kernels.reset_counts()
            eng = SH.ShardedFrontierSearch(problem, devices=[cuda] * 4, driver=driver, **kw)
            with pytest.raises(RuntimeError, match="max_steps exceeded"):
                eng.run()
            torch.cuda.synchronize()
            runs[driver] = (eng, dict(_kernels.launches))
    card = SH.ShardedFrontierSearch(problem, devices=[cuda] * 4, driver="host", **kw)
    with pytest.raises(RuntimeError, match="max_steps exceeded"):
        card.run()
    torch.cuda.synchronize()
    (ce, counts), (he, _) = runs["chunked"], runs["host"]
    assert ce.layout == "packed" and ce.exchange == he.exchange == "ragged"
    assert not ce.card_form and not he.card_form and card.card_form
    assert len(ce.cards) == 4 and ce.cards[0].recv is None and len(ce.wires) == 4
    cs = ce.last_stats
    assert cs["steps"] == he.last_stats["steps"] == card.last_stats["steps"] == 256
    assert cs["graph_captures"] == 2 and cs["graph_replays"] == 256 and cs["host_reads"] == 1
    assert he.last_stats["host_reads"] == 256
    for other in (he, card):
        for (k, a), (_, b) in zip(_loop_words(ce), _loop_words(other)):
            assert torch.equal(a, b), k
    assert all(torch.equal(c.cons, ce.cards[0].cons) for c in ce.cards)
    for k in ("consensus", "exchange"):
        assert counts[k] > 0, k


def test_ipc_exchange_two_processes_one_card(cuda):
    """Two processes on one card (tools/ipc_exchange_check.py --one-card,
    gloo for the handles): each exports its wire, maps the other's through
    CUDA IPC (``ProcessMesh.map_peers``) and runs ``exchange`` from the
    mapped wire, ragged, bit for bit with ``exchange_plain`` on the rows
    rebuilt from the seeds, in every case; the mappings closed behind a
    barrier."""
    outs = run_ranks([sys.executable, os.path.join("tools", "ipc_exchange_check.py"),
                      "--one-card"])
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}"
        line = next(l for l in out.splitlines() if l.startswith("IPC_CHECK "))
        r = json.loads(line.split(" ", 1)[1])
        assert r["rank"] == rank and r["device"] == "cuda:0" and r["max_abs_err"] == 0
        assert all(c["max_abs_err"] == 0 and c["rows"] > 0 for c in r["cases"])
        assert r["launches"] > 0


def test_process_mesh_ragged_late_rank(cuda):
    """A ProcessMesh of NCCL ranks, a card each (two or more; skipped
    below), kinase's first 256 steps with the ragged exchange
    (tests/process_mesh_late.py): rank 1 late by 200,000 clock cycles
    before its pack and before its exchange, captured into its step
    graphs, leaves every rank's words equal to the run without the delay
    and to the host driver's (a hash a rank); the step's collectives alone
    order the reads of the peers' mapped wires."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more (NCCL takes one rank a card)")
    world = min(n, 4)
    outs = run_ranks([sys.executable, os.path.join("tests", "process_mesh_late.py")], world)
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}"
        runs = [json.loads(l.split(" ", 1)[1]) for l in out.splitlines()
                if l.startswith("LATE_RUN ")]
        assert [(r["driver"], r["cycles"] > 0) for r in runs] == [
            ("host", False), ("chunked", False), ("chunked", True)]
        assert all(r["exchange"] == "ragged" and r["steps"] == 256 for r in runs)
        assert runs[1]["host_reads"] == runs[2]["host_reads"] == 1
        assert len({r["hash"] for r in runs}) == 1, f"rank {rank}: {runs}"


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_sharded_graph_overflow_retries_equal_host_driver(cuda, layout):
    """A table of 16 slots a shard on [cuda] * 4 overflows inside a chunk
    graph: the run reads the kind from the consensus vector and retries at
    twice the capacity with a new graph, as the host driver does; the
    retries, the result and the last run's tables equal; the last run
    captures its two step graphs and replays 8 a host read."""
    rs = np.random.RandomState(31)
    problem = Problem(tuple("".join(rs.choice(list(AMINO), size=rs.randint(12, 17)))
                            for _ in range(4)))
    (ce, cr), (he, hr) = _drivers(cuda, problem, layout=layout, capacity=16, batch=16,
                                  hash_shift=0, chunk_steps=8)
    assert ce.retries == he.retries and ce.retries and ce.retries[0][0] == "table"
    assert cr.g == hr.g and (cr.steps, cr.shard_stats) == (hr.steps, hr.shard_stats)
    for (k, a), (_, b) in zip(_loop_words(ce), _loop_words(he)):
        assert torch.equal(a, b), k
    cs = ce.last_stats
    assert cs["graph_captures"] == 2 and cs["graph_replays"] == 8 * cs["host_reads"]


# --- the several-card step: two cards of one card (the grouping replaced),
# and every card of the machine


def _split(monkeypatch, groups):
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH

    monkeypatch.setattr(SH, "_card_groups", lambda devices: groups)


def _equal_drivers(ce, cr, he, hr, gold=None, chunk=None):
    """The chunked run against the host run: the result, stats and every
    table word; both cards' vectors equal; with ``gold`` its g and
    alignment; with ``chunk`` one host read a chunk."""
    from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment

    if gold is not None:
        assert cr.g == gold["optimal_g"]
        assert build_alignment(ce.problem, cr.closed) == gold["alignment"]
    if cr is not None:
        assert (cr.g, cr.closed, cr.steps, cr.shard_stats) == (
            hr.g, hr.closed, hr.steps, hr.shard_stats)
    for (k, a), (_, b) in zip(_loop_words(ce), _loop_words(he)):
        assert torch.equal(a, b), k
    assert all(torch.equal(c.cons.cpu(), ce.cards[0].cons.cpu()) for c in ce.cards)
    cs = ce.last_stats
    assert cs["driver"] == "chunked" and cs["card_form"] and cs["graph_captures"] == 2
    if chunk is not None:
        assert cs["host_reads"] == -(-cs["steps"] // chunk)
        assert cs["graph_replays"] == chunk * cs["host_reads"]


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
@pytest.mark.parametrize("name", ["PF08184.fasta", "test2.fasta"])
def test_sharded_split_cards_equal_host_driver(cuda, monkeypatch, name, layout):
    """[cuda] * 4 grouped into two cards (0, 1 | 2, 3): the chunked
    driver's several-card step (a stream a card joined by events, the
    gathers as copies, a snapshot of the reports, a consensus and an
    exchange a card, all in one graph a ring parity) in chunks of 16
    against the host driver's rank form on the same mesh: the golden
    g and alignment, the same result and every table word bit for bit; the
    loop kernels launched."""
    gold = json.load(open(os.path.join(HERE, "goldens.json")))[name]
    problem = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    _split(monkeypatch, [[0, 1], [2, 3]])
    _kernels.reset_counts()
    (ce, cr), (he, hr) = _drivers(cuda, problem, layout=layout, chunk_steps=16)
    assert len(ce.cards) == 2 and not he.card_form
    _equal_drivers(ce, cr, he, hr, gold, 16)
    for k in ("consensus", "exchange", "walk_advance"):
        assert _kernels.launches[k] > 0, k


def test_sharded_kinase_split_cards_chunk_equals_host_driver(cuda, monkeypatch):
    """Kinase on [cuda] * 4 grouped into three cards (0 | 1, 2 | 3),
    packed at 2^21, ragged: one 64-step chunk of the several-card step
    against 64 steps of the host driver's rank form, every table word."""
    gold = json.load(open(os.path.join(HERE, "goldens.json")))["kinase.fasta"]
    problem = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    _split(monkeypatch, [[0], [1, 2], [3]])
    (ce, _), (he, _) = _drivers(cuda, problem, chunk_steps=64, max_steps=64)
    assert ce.layout == "packed" and ce.exchange == "ragged" and len(ce.cards) == 3
    assert ce.last_stats["steps"] == he.last_stats["steps"] == 64
    _equal_drivers(ce, None, he, None, chunk=64)


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_sharded_across_cards_equal_host_driver(cuda, layout):
    """Four shards round-robin over every card of the machine (two or
    more; skipped below): PF08184 chunked (one graph a parity spanning the
    cards, peer reads) in chunks of 16 against the host driver on the same
    cards: the golden g and alignment, every table word."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    gold = json.load(open(os.path.join(HERE, "goldens.json")))["PF08184.fasta"]
    problem = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    devices = [torch.device("cuda", i % n) for i in range(4)]
    (ce, cr), (he, hr) = _drivers(cuda, problem, devices=devices, layout=layout,
                                  chunk_steps=16)
    assert len(ce.cards) == min(n, 4) and not he.card_form
    _equal_drivers(ce, cr, he, hr, gold, 16)


@pytest.mark.parametrize("cycles", [0, 200_000])
def test_walk_loop_across_cards_with_late_peers(cuda, cycles, monkeypatch):
    """The walk's device loop on four shards round-robin over every card
    (two or more; skipped below), kinase searched to its end (85 rounds
    of the walk), with every
    shard off the first card starting its walk of a round ``cycles`` clock
    cycles late (torch.cuda._sleep ahead of path_walk_hops, captured into
    the round's graph with it, about 0.1 ms at 200,000): the host walk's
    masks and rounds over every round, and each walk_advance node's one
    incoming edge a full edge from the empty node after every card's runs
    (utils/graph.py::join_full), no programmatic edge across the cards."""
    from mpi_pastar_msa_tpu_torch.parallel import sharded as SH
    from mpi_pastar_msa_tpu_torch.utils.graph import last_node_edges

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    gold, problem = golden_problem("kinase.fasta")
    eng = SH.ShardedFrontierSearch(problem, devices=[torch.device("cuda", i % n)
                                                     for i in range(4)], driver="chunked")
    assert eng.run().g == gold["optimal_g"] and len(eng.cards) == min(n, 4)
    masks, rounds = eng._walk(eng.shards)
    first = eng.cards[0].dev

    def late(walk):
        def go(*args, **kw):
            torch.cuda._sleep(cycles)
            return walk(*args, **kw)
        return go

    if cycles:
        for sh in eng.shards:
            if sh.dev != first:
                monkeypatch.setattr(sh, "walk_hops", late(sh.walk_hops))
    edges, advance = [], SH.walk_advance_cuda

    def recorded(*args):
        advance(*args)
        if torch.cuda.is_current_stream_capturing():
            edges.append(last_node_edges(torch.cuda.current_stream()))

    monkeypatch.setattr(SH, "walk_advance_cuda", recorded)
    got, got_rounds, reads = eng._walk_loop(eng.shards)
    assert (got, got_rounds) == (masks, rounds) and rounds > 2 * SH.WALK_ROUNDS
    assert reads == -(-rounds // SH.WALK_ROUNDS)
    assert len(edges) == len(eng.cards)
    assert all(e == [("empty", "full", 0)] for e in edges), edges
