"""Exhaustive DAG shortest-path oracle for tiny inputs (JAX
``search/bruteforce.py``).

Independent of A*: computes the optimal weighted-SP alignment cost by dynamic
programming over the full edit lattice in topological (lexicographic) order.
Used only in tests to validate the serial, native and frontier engines.

NOTE: valid as a *cost* oracle whenever GapOpen == GapExtension (the reference
default, pastar/include/Cost.h:13), because edge costs are then independent of
the incoming move mask, so plain coordinates form a Markov state.
"""
from __future__ import annotations

import itertools

import numpy as np

from ..core.cost import COST_TABLE, GAP_EXTENSION, GAP_GAP, GAP_OPEN
from ..core.problem import Problem
from ..heuristic.hpair import HPairHeuristic


def optimal_cost(problem: Problem, heuristic: HPairHeuristic) -> int:
    if GAP_OPEN != GAP_EXTENSION:
        raise NotImplementedError("plain-coordinate DP needs GapOpen == GapExtension")
    n = problem.n_seq
    lens = [len(s) for s in problem.seqs]
    pairs = problem.pairs()
    pw = [int(heuristic.weight_i[x, y]) for x, y in pairs]
    enc = [np.frombuffer(s.encode("latin-1"), dtype=np.uint8).astype(np.int32)
           for s in problem.seqs]

    INF = np.iinfo(np.int64).max // 4
    dp = np.full([length + 1 for length in lens], INF, dtype=np.int64)
    dp[(0,) * n] = 0

    for coord in itertools.product(*[range(length + 1) for length in lens]):
        base = dp[coord]
        if base >= INF:
            continue
        mm = [int(COST_TABLE[enc[x][coord[x]] if coord[x] < lens[x] else 0,
                             enc[y][coord[y]] if coord[y] < lens[y] else 0])
              for x, y in pairs]
        for mask in range(1, 1 << n):
            child = tuple(coord[i] + ((mask >> i) & 1) for i in range(n))
            if any(child[i] > lens[i] for i in range(n)):
                continue
            cost = 0
            for k, (x, y) in enumerate(pairs):
                bx = (mask >> x) & 1
                by = (mask >> y) & 1
                if bx and by:
                    pc = mm[k]
                elif not (bx or by):
                    pc = GAP_GAP
                else:
                    pc = GAP_OPEN  # == GAP_EXTENSION by precondition
                cost += pc * pw[k]
            v = base + cost
            if v < dp[child]:
                dp[child] = v
    return int(dp[tuple(lens)])
