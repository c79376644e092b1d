"""HPair heuristic: admissible lower bound from pairwise suffix tables.

h(c) = sum over pairs (x, y) of  suffix_table[x,y][c_x, c_y] * int(weight[x,y])
(ref: pastar/HeuristicHPair.cpp:73-86).  Admissible because each pairwise term
lower-bounds that pair's remaining cost, and the WSP objective is the weighted
sum of pair costs.

The tables come from the pair-wavefront kernel (K1) on the card, or from its
plain version on the CPU; the weights from the Altschul pipeline, whose Gotoh
fill runs on the same device (kernel K8 on the card, its plain version on the
CPU) and whose tree work stays on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..core.problem import Problem
from ..utils.device import resolve_device
from .pairwise import stack_pair_tables
from .wavefront import pair_tables
from .weights import altschul_rationale2


@dataclass(frozen=True)
class HPairHeuristic:
    problem: Problem
    tables: Tuple[np.ndarray, ...]      # per-pair suffix tables, (i<j) order
    weight_f: np.ndarray                # (N, N) float32 Altschul weights
    weight_i: np.ndarray                # (N, N) int32 truncated runtime weights

    @classmethod
    def build(cls, problem: Problem, device="cuda") -> "HPairHeuristic":
        """All pair tables (K1 on ``device``) plus the Altschul weights
        (their Gotoh fill, K8, on ``device``)."""
        dev = resolve_device(device)
        stacked = pair_tables(problem, dev).cpu().numpy()
        tables = tuple(
            stacked[k, : len(problem.seqs[x]) + 1, : len(problem.seqs[y]) + 1]
            for k, (x, y) in enumerate(problem.pairs())
        )
        wf, wi = altschul_rationale2(problem.seqs, dev)
        return cls(problem, tables, wf, wi)

    @classmethod
    def from_numpy(cls, problem: Problem, tables, weight_f,
                   weight_i) -> "HPairHeuristic":
        """Heuristic from NumPy state, e.g. the JAX package's
        ``HPairHeuristic`` fields, so both engines can run on identical
        inputs."""
        return cls(problem, tuple(np.asarray(t, dtype=np.int32) for t in tables),
                   np.asarray(weight_f, dtype=np.float32),
                   np.asarray(weight_i, dtype=np.int32))

    def calculate_h(self, coord) -> int:
        """Scalar h for one coordinate (ref: pastar/HeuristicHPair.cpp:73-86)."""
        c = np.asarray(coord)
        h = 0
        for (x, y), t in zip(self.problem.pairs(), self.tables):
            h += int(t[c[x], c[y]]) * int(self.weight_i[x, y])
        return h

    def stacked_tables(self) -> np.ndarray:
        """(P, Lmax+1, Lmax+1) int32 stack for device-side gathers."""
        return stack_pair_tables(list(self.tables), self.problem.max_length)

    def pair_weights_i(self) -> np.ndarray:
        """(P,) int32 weights in pair order."""
        return np.array([self.weight_i[x, y] for x, y in self.problem.pairs()], dtype=np.int32)
