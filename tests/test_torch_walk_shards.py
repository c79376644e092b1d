"""The sharded walk in one pass (parallel/sharded.py ``walk_shards_plain``,
the plain version of csrc/path_walk.cu's ``path_walk_shards``, which the
chunked driver runs where every shard's table lies on one card) on the
CPU: on the finished tables of PF08184 on 2 and 4 shards, sig, packed and
unpacked, under each owner hash, against the host driver's walk in rounds
(``_walk``) and the round form of the walk loop: the same masks, the same
rounds at the engine's hops a round and at fewer, and the origin reached;
a node its owner does not hold ends both walks, which raise, the one pass
stopping at that node with the masks before it.  Then the chunked driver's
one-launch walk on one card: one read, the rounds of the host driver."""
import json
import os

import pytest
import torch

from mpi_pastar_msa_tpu_torch.core.problem import Problem
from mpi_pastar_msa_tpu_torch.parallel import sharded as S
from mpi_pastar_msa_tpu_torch.search import engine as E

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))


def golden(name):
    return Problem(tuple(r.replace("-", "") for r in GOLD[name]["alignment"]))


def finished(layout, ndev, hash_type):
    eng = S.ShardedFrontierSearch(golden("PF08184.fasta"), devices=["cpu"] * ndev,
                                  layout=layout, capacity=1 << 14, driver="host",
                                  hash_type=hash_type)
    res = eng.run()
    assert res.g == GOLD["PF08184.fasta"]["optimal_g"]
    return eng


def tables(eng):
    return [sh.tab for sh in sorted(eng.shards, key=lambda sh: sh.me)]


@pytest.mark.parametrize("hash_type", ["FZORDER", "PZORDER", "FSUM", "PSUM"])
@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_walk_shards_plain_equals_host_walk(monkeypatch, layout, ndev, hash_type):
    eng = finished(layout, ndev, hash_type)
    final = [int(v) for v in eng.problem.final_coord]
    for hops in (S.WALK_HOPS, 3, 1):
        monkeypatch.setattr(S, "WALK_HOPS", hops)  # the round form's hops a round
        want, want_rounds = eng._walk(eng.shards)
        masks, coord, rounds = S.walk_shards_plain(eng.st, tables(eng), final, layout,
                                                   eng.own, hops)
        assert (masks, rounds) == (want, want_rounds) and not any(coord), hops
        assert eng._walk_loop(eng.shards, form="rounds")[:2] == (want, want_rounds), hops
    assert len(want) > 0 and rounds == len(want)  # a round a node at one hop a round


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_walk_shards_plain_broken_path(monkeypatch, layout):
    """A node of the path that its owner's lookup misses (the layout's
    lookup replaced): the host walk and the chunked walk in both forms
    raise; the one pass stops at that node, the masks before it emitted."""
    eng = finished(layout, 4, "FSUM")
    final = [int(v) for v in eng.problem.final_coord]
    want, _ = eng._walk(eng.shards)
    coord, path = list(final), []
    for m in want:
        path.append(tuple(coord))
        coord = [c - ((m >> d) & 1) for d, c in enumerate(coord)]
    cut = len(path) // 2
    fns = E._LAYOUT_FNS[layout]
    real = fns.lookup

    def lookup(st, tab, c):
        return None if tuple(int(v) for v in c) == path[cut] else real(st, tab, c)

    monkeypatch.setitem(E._LAYOUT_FNS, layout, fns._replace(lookup=lookup))
    masks, coord, rounds = S.walk_shards_plain(eng.st, tables(eng), final, layout, eng.own)
    assert masks == want[:cut] and tuple(coord) == path[cut] and rounds > 0
    with pytest.raises(RuntimeError, match="did not reach the origin"):
        eng._walk(eng.shards)
    for form in ("launch", "rounds"):
        with pytest.raises(RuntimeError, match="did not reach the origin"):
            eng._walk_loop(eng.shards, form=form)


@pytest.mark.parametrize("layout", ["sig", "packed", "unpacked"])
def test_chunked_walk_is_one_launch(layout):
    """The chunked driver on 4 shards of one device: the walk in one pass
    (``walk_form`` "launch"), one host read, the host driver's masks and
    rounds."""
    kw = dict(layout=layout, capacity=1 << 14, chunk_steps=16)
    ce = S.ShardedFrontierSearch(golden("PF08184.fasta"), devices=["cpu"] * 4,
                                 driver="chunked", **kw)
    cr = ce.run()
    he = S.ShardedFrontierSearch(golden("PF08184.fasta"), devices=["cpu"] * 4, driver="host",
                                 **kw)
    hr = he.run()
    cs, hs = ce.last_stats, he.last_stats
    assert ce.walk_form() == "launch" and cs["walk_form"] == "launch"
    assert hs["walk_form"] == "host"
    assert cs["walk_reads"] == 1 and hs["walk_reads"] == hs["walk_rounds"]
    assert cs["walk_rounds"] == hs["walk_rounds"] and cr.closed == hr.closed
