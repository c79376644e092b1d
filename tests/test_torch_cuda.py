"""Tests that need the card (marker ``cuda``): the hand-written CUDA kernels
(K1 pair wavefront, K2 triple cubes) against their plain PyTorch versions,
and the port's main path and its table layouts on the GPU.
They skip on a host without a CUDA device.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import json
import os

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
    assert _kernels.launches == {"pair_wavefront": 1, "triple_wavefront": 1}
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
