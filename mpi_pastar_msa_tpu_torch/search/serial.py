"""Serial A* oracle over the N-dimensional edit lattice (JAX
``search/serial.py``).

Correctness oracle for the frontier engine — semantics match the reference's
serial driver (ref: pastar/AStar.cpp:53-104) and open list (pastar/include/
PriorityList.h:84-122): best-first with decrease-key upserts, reopen support
(a closed node found again with smaller g is reopened), and termination when
the goal is *dequeued*.

Implementation is a lazy-deletion binary heap plus dicts (the Pythonic
equivalent of the reference's boost multi_index open list); successor
generation mirrors Node::getNeigh (ref: pastar/Node.cpp:206-248) with the
weighted affine pairCost (ref: pastar/Node.cpp:129-152).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.cost import COST_TABLE, GAP_EXTENSION, GAP_GAP, GAP_OPEN
from ..core.problem import Problem
from ..heuristic.hpair import HPairHeuristic


@dataclass
class SearchResult:
    g: int
    h: int
    f: int
    goal_parent_mask: int
    closed: Dict[Tuple[int, ...], Tuple[int, int]]  # coord -> (g, parenti)
    nodes_expanded: int
    nodes_reopened: int
    open_size: int


class SerialAStar:
    """``heuristic`` defaults to ``HPairHeuristic.build(problem)``, on the
    card."""

    def __init__(self, problem: Problem, heuristic: Optional[HPairHeuristic] = None):
        self.problem = problem
        self.h = heuristic if heuristic is not None else HPairHeuristic.build(problem)
        self.n = problem.n_seq
        self.pairs = problem.pairs()
        self.pair_w = [int(self.h.weight_i[x, y]) for x, y in self.pairs]
        self.final = tuple(int(v) for v in problem.final_coord)
        self.enc = [np.frombuffer(s.encode("latin-1"), dtype=np.uint8).astype(np.int32)
                    for s in problem.seqs]

    def _h(self, coord: Tuple[int, ...]) -> int:
        hv = 0
        for (x, y), t, w in zip(self.pairs, self.h.tables, self.pair_w):
            hv += int(t[coord[x], coord[y]]) * w
        return hv

    def _successors(self, coord: Tuple[int, ...], g: int, parenti: int):
        """Yield (child_coord, child_g, move_mask) for all legal move masks.

        Mirrors Node::getNeigh: per-pair substitution costs are read at the
        *current* position (seq[pos]), then each of the 2^N-1 masks accumulates
        the weighted pairCost (ref: pastar/Node.cpp:220-246).
        """
        n = self.n
        final = self.final
        # per-pair match/mismatch cost at this position
        mm = [int(COST_TABLE[self.enc[x][coord[x]] if coord[x] < len(self.enc[x]) else 0,
                             self.enc[y][coord[y]] if coord[y] < len(self.enc[y]) else 0])
              for (x, y) in self.pairs]
        for mask in range(1, (1 << n)):
            child = tuple(coord[i] + ((mask >> i) & 1) for i in range(n))
            if any(child[i] > final[i] for i in range(n)):
                continue
            costs = 0
            for k, (x, y) in enumerate(self.pairs):
                bx = (mask >> x) & 1
                by = (mask >> y) & 1
                if bx and by:
                    pc = mm[k]
                elif not bx and not by:
                    pc = GAP_GAP
                else:
                    s = y if bx else x
                    # gap-open iff sequence s's advance state changed vs the
                    # parent move (ref: pastar/Node.cpp:149-151)
                    pc = GAP_OPEN if ((parenti >> s) & 1) != ((mask >> s) & 1) else GAP_EXTENSION
                costs += pc * self.pair_w[k]
            yield child, g + costs, mask

    def run(self) -> SearchResult:
        problem = self.problem
        start = tuple(int(v) for v in problem.initial_coord)
        root_parenti = problem.root_parent_mask
        h0 = self._h(start)

        # open: coord -> (f, g, parenti); heap with lazy deletion
        open_best: Dict[Tuple[int, ...], Tuple[int, int, int]] = {start: (h0, 0, root_parenti)}
        heap: List[Tuple[int, Tuple[int, ...]]] = [(h0, start)]
        closed: Dict[Tuple[int, ...], Tuple[int, int]] = {}
        expanded = reopened = 0

        while heap:
            f, coord = heapq.heappop(heap)
            entry = open_best.get(coord)
            if entry is None or entry[0] != f:
                continue  # stale heap entry
            _, g, parenti = entry
            del open_best[coord]

            prev = closed.get(coord)
            if prev is not None:
                if g >= prev[0]:
                    continue
                reopened += 1
            closed[coord] = (g, parenti)
            expanded += 1

            if coord == self.final:
                hg = self._h(coord)
                return SearchResult(g=g, h=hg, f=g + hg, goal_parent_mask=parenti,
                                    closed=closed, nodes_expanded=expanded,
                                    nodes_reopened=reopened, open_size=len(open_best))

            for child, cg, mask in self._successors(coord, g, parenti):
                cprev = closed.get(child)
                if cprev is not None:
                    if cg >= cprev[0]:
                        continue
                    del closed[child]
                cf = cg + self._h(child)
                cur = open_best.get(child)
                # conditional_enqueue: keep the lower-f copy
                # (ref: pastar/include/PriorityList.h:104-113)
                if cur is None or cf < cur[0]:
                    open_best[child] = (cf, cg, mask)
                    heapq.heappush(heap, (cf, child))
        raise RuntimeError("open list exhausted without reaching the goal")
