"""Upper-bound estimation for search pruning.

A greedy (beam-1..k) descent from the origin to the goal yields a valid
alignment whose cost upper-bounds the optimal.  With an admissible heuristic,
every node on an optimal path satisfies f <= optimal <= UB, so the frontier
engine can prune any candidate with f > UB without losing optimality — this
caps the batched engine's frontier flood (strict best-first, as the
reference's priority queue enforces, never visits f > optimal either).
"""
from __future__ import annotations

import numpy as np

from ..core.cost import COST_TABLE, GAP_EXTENSION, GAP_GAP, GAP_OPEN
from ..core.problem import Problem
from ..heuristic.hpair import HPairHeuristic


def greedy_upper_bound(problem: Problem, heuristic: HPairHeuristic,
                       beam: int = 8) -> int:
    """Beam-search descent to the goal; returns the best complete-path cost.

    Each step extends every beam state by all 2^N-1 move masks and keeps the
    `beam` lowest-f children.  Terminates in at most sum(lengths) steps.
    """
    n = problem.n_seq
    pairs = problem.pairs()
    pw = np.array([int(heuristic.weight_i[x, y]) for x, y in pairs], dtype=np.int64)
    xs = np.array([x for x, _ in pairs])
    ys = np.array([y for _, y in pairs])
    final = problem.final_coord.astype(np.int64)
    enc = problem.encoded(problem.max_length + 1).astype(np.int64)
    tables = heuristic.tables

    M = (1 << n) - 1
    bits = np.zeros((M, n), dtype=np.int64)
    for m in range(1, M + 1):
        bits[m - 1] = [(m >> i) & 1 for i in range(n)]
    bx = bits[:, xs]
    by = bits[:, ys]
    both = (bx & by).astype(bool)
    E, O, GG = GAP_EXTENSION, GAP_OPEN, GAP_GAP
    # constant part per mask assuming O == E (exact for reference defaults);
    # the parenti-dependent distinction vanishes when O == E
    const_part = np.where(both, 0, np.where(~bx & ~by, GG, E)) @ pw

    def h_of(coords: np.ndarray) -> np.ndarray:
        """(K, N) -> (K,) heuristic values (fully vectorized)."""
        out = np.zeros(len(coords), dtype=np.int64)
        for k, (x, y) in enumerate(pairs):
            out += pw[k] * tables[k][coords[:, x], coords[:, y]].astype(np.int64)
        return out

    coords = np.zeros((1, n), dtype=np.int64)
    gs = np.zeros(1, dtype=np.int64)
    best_complete = None
    max_steps = int(final.sum()) + 1
    rng = np.arange(n)
    for _ in range(max_steps):
        K = len(coords)
        # edge cost of every (state, mask): match/mismatch term only where
        # both sequences advance
        ch = enc[rng[None, :], np.minimum(coords, problem.max_length)]  # (K, N)
        mm = COST_TABLE[ch[:, xs], ch[:, ys]].astype(np.int64)          # (K, P)
        edge = const_part[None, :] + (mm[:, None, :] * (both[None, :, :] * pw[None, None, :])).sum(axis=2)  # (K, M)
        child = coords[:, None, :] + bits[None, :, :]                   # (K, M, N)
        ok = np.all(child <= final[None, None, :], axis=2)              # (K, M)
        cand_coords = child[ok]
        cand_g = (gs[:, None] + edge)[ok]
        if len(cand_g) == 0:
            break
        # dedup by coordinate, keep min g
        order0 = np.lexsort((cand_g,) + tuple(cand_coords.T))
        cand_coords = cand_coords[order0]
        cand_g = cand_g[order0]
        first = np.ones(len(cand_g), dtype=bool)
        first[1:] = np.any(cand_coords[1:] != cand_coords[:-1], axis=1)
        cand_coords = cand_coords[first]
        cand_g = cand_g[first]

        at_goal = np.all(cand_coords == final[None, :], axis=1)
        if at_goal.any():
            gmin = int(cand_g[at_goal].min())
            best_complete = gmin if best_complete is None else min(best_complete, gmin)
        keep = ~at_goal
        cand_coords = cand_coords[keep]
        cand_g = cand_g[keep]
        if len(cand_g) == 0:
            break
        f = cand_g + h_of(cand_coords)
        order = np.argsort(f, kind="stable")[:beam]
        coords = cand_coords[order]
        gs = cand_g[order]
        if best_complete is not None and bool((gs >= best_complete).all()):
            break

    if best_complete is None:
        raise RuntimeError("greedy descent failed to reach the goal")
    return best_complete
