"""Port frontier engine end to end on the CPU: the golden optimum g,
similarity and byte-identical alignment on test / test2 / PF08184 (inputs
rebuilt from tests/goldens.json), overflow regrow, chunk-size independence,
and the insert's settle-once semantics."""
import json
import os

import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.heuristic.hpair import HPairHeuristic
from mpi_pastar_msa_tpu_torch.search import engine as TE
from mpi_pastar_msa_tpu_torch.search.backtrace import build_alignment, similarity

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))


def golden_problem(name):
    return Problem(tuple(r.replace("-", "") for r in GOLD[name]["alignment"]))


@pytest.mark.parametrize("name", ["test.fasta", "test2.fasta", "PF08184.fasta"])
def test_goldens(name):
    gold = GOLD[name]
    p = golden_problem(name)
    eng = TE.FrontierSearch(p, HPairHeuristic.build(p, "cpu"), device="cpu",
                            triples="off")
    assert eng.layout == "sig"
    res = eng.run()
    assert res.g == gold["optimal_g"]
    al = build_alignment(p, res.closed)
    assert al == gold["alignment"]
    assert f"{similarity(al):.2f}" == f"{gold['similarity_pct']:.2f}"
    # per-path-node g is the exact prefix cost and ends at the optimum
    assert res.closed[tuple(int(v) for v in p.final_coord)][0] == res.g
    assert res.nodes_expanded >= len(res.closed)
    assert res.shard_stats[0][2] >= len(res.closed)  # closed count


def test_overflow_autoregrow():
    p = golden_problem("PF08184.fasta")
    eng = TE.FrontierSearch(p, HPairHeuristic.build(p, "cpu"), device="cpu",
                            batch=64, capacity=1 << 5, triples="off")
    res = eng.run()
    assert res.g == 24450
    assert eng.regrown and eng.st.C > (1 << 5)


def test_trajectory_independent_of_chunk_size():
    p = golden_problem("test2.fasta")
    h = HPairHeuristic.build(p, "cpu")
    runs = []
    for chunk in (1, 7, 64):
        eng = TE.FrontierSearch(p, h, device="cpu", batch=256,
                                capacity=1 << 16, chunk_steps=chunk,
                                triples="off")
        res = eng.run()
        runs.append((res.g, res.nodes_expanded, res.nodes_reopened, res.steps,
                     sorted(res.closed.items())))
    assert runs[0][0] == 45037
    assert runs[0] == runs[1] == runs[2]


def test_insert_settles_each_key_once():
    p = golden_problem("PF08184.fasta")
    h = HPairHeuristic.build(p, "cpu")
    eng = TE.FrontierSearch(p, h, device="cpu", batch=64, capacity=1 << 12,
                            triples="off")
    st = eng.st
    tab = eng._init_table()
    rs = np.random.RandomState(0)
    coords = torch.from_numpy(np.stack(
        [rs.randint(0, 60, size=300) for _ in range(3)], axis=1))
    coords = torch.cat([coords, coords[:100]])  # duplicates, same call
    words = torch.from_numpy(rs.randint(0, 1 << 20, size=400)) << st.nb
    home, sigb = TE._sig_encode(st, coords)
    ovf, reopen, acct = TE._insert_sig(st, tab, home, sigb, words | 1)
    assert int(ovf) == 0 and int(reopen) == 0 and int(acct[0]) == 400
    n_keys = len({tuple(c) for c in coords.tolist()})
    # one way per distinct key (+ the root), and every key decodes back
    occupied = torch.nonzero(tab.t_sig[: st.nbuck * st.ways] != -1)[:, 0]
    assert len(occupied) == n_keys + 1
    dec = TE._sig_decode(st, occupied, tab.t_sig[occupied])
    assert {tuple(c) for c in dec.tolist()} == (
        {tuple(c) for c in coords.tolist()} | {(0, 0, 0)})
    # t_best holds the min packed word per key; a second insert of larger
    # words changes nothing
    before = tab.t_best.clone()
    TE._insert_sig(st, tab, home, sigb, (words | 1) + (1 << (st.nb + 20)))
    assert torch.equal(tab.t_best, before)
    best = {}
    for c, w in zip(coords.tolist(), (words | 1).tolist()):
        best[tuple(c)] = min(best.get(tuple(c), 1 << 31), w)
    got = {tuple(c): int(tab.t_best[s]) for c, s in zip(dec.tolist(), occupied.tolist())}
    for k, w in best.items():
        assert got[k] == w
