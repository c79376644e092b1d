"""Seeded walks for the tests of walk_advance (csrc/shard_loop.cu) and its
plain version: shared by the CPU tests (test_torch_sharded_loop.py) and
the card tests (test_torch_cuda.py).  NumPy only: no JAX, no torch."""
import numpy as np

WALK_SHAPES = [(2, 1, 1), (5, 8, 4), (24, 32, 32)]  # (N, hops, shards)
WALK_STOPS = ["origin", "empty", "room", "overfull", "off"]


def walk_case(seed, n, hops, ndev, stop):
    """A walk's start and its rounds' runs, from a seeded generator: the
    walk state (params, masks, wst, wrun) and, round after round until the
    ``stop`` it is built for, each shard's run of the round (ndev, hops + N
    + 1) int32, one shard's non-zero as path_walk_hops writes it: its masks
    from hop 0, each a subset of the coordinate's non-zero dimensions, then
    zeros, the coordinate it stopped at and the count.  ``origin``: the
    runs reach it; ``empty``: the third round emits nothing; ``room``: two
    rounds of ``hops`` masks fill the masks' room (2 hops + hops // 2);
    ``overfull``: the masks start with room for half a round (the rest is
    dropped); ``off``: the walk's flag is 0 on entry.  Returns (state,
    runs)."""
    rng = np.random.default_rng(seed)
    full = stop in ("room", "overfull")
    big = full or stop == "empty"  # no origin before the stop
    final = [int(v) for v in rng.integers(3 * hops + 1 if big else 3,
                                          3 * hops + 6 if big else 13, n)]
    mcap = {"room": 2 * hops + hops // 2, "overfull": 2 * hops}.get(stop, sum(final) + hops)
    state = [np.array(final + [9] * n, np.int32), np.zeros(mcap, np.int32),
             np.array([mcap - hops // 2 if stop == "overfull" else 0, 0], np.int32),
             np.array([int(stop != "off")], np.int32)]
    coord, runs = list(final), []
    for r in range(64):
        out = np.zeros((ndev, hops + n + 1), np.int32)
        owner = int(rng.integers(ndev))
        k = 0
        if not (stop == "empty" and r == 2):
            for k in range(hops if full else int(rng.integers(1, hops + 1))):
                live = [d for d in range(n) if coord[d] > 0]
                if not live:
                    break
                pick = rng.random(len(live)) < 0.7
                pick[int(rng.integers(len(live)))] = True
                m = sum(1 << d for d, q in zip(live, pick) if q)
                out[owner, k] = m
                coord = [coord[d] - ((m >> d) & 1) for d in range(n)]
            else:
                k += 1
        out[owner, hops:hops + n] = coord
        out[owner, hops + n] = k
        runs.append(out)
        if not any(coord) or (stop == "empty" and r == 2):
            break
    return state, runs
