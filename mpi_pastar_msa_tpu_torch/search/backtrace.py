"""Solution recovery: walk the closed set goal -> origin and render the alignment.

Host-side equivalent of the reference's backtrace + printing layer
(ref: pastar/backtrace.cpp:46-206).  The parent of a closed node is recovered
from its move mask: parent[i] = pos[i] - bit_i(mask) (ref: pastar/include/
Node.h:45, pastar/Coord.cpp:112-126).
"""
from __future__ import annotations

import shutil
import sys
from typing import Dict, List, Tuple

import numpy as np

from ..core.cost import COST_TABLE, GAP_EXTENSION, GAP_GAP, GAP_OPEN
from ..core.problem import Problem


def build_alignment(problem: Problem,
                    closed: Dict[Tuple[int, ...], Tuple[int, int]]) -> List[str]:
    """Reconstruct the N aligned strings from the closed dict
    (coord -> (g, parent_move_mask)); ref: pastar/backtrace.cpp:46-69."""
    n = problem.n_seq
    cols: List[List[str]] = [[] for _ in range(n)]
    coord = tuple(int(v) for v in problem.final_coord)
    origin = tuple(0 for _ in range(n))
    while coord != origin:
        g, mask = closed[coord]
        parent = tuple(coord[i] - ((mask >> i) & 1) for i in range(n))
        for i in range(n):
            if coord[i] != parent[i]:
                cols[i].append(problem.seqs[i][coord[i] - 1])
            else:
                cols[i].append("-")
        coord = parent
    return ["".join(reversed(c)) for c in cols]


def attach_path_g(problem: Problem, weight_i,
                  closed: Dict[Tuple[int, ...], Tuple[int, int]],
                  goal_g: int | None = None) -> Dict[Tuple[int, ...], Tuple[int, int]]:
    """Replace placeholder g values in a path-only closed dict with exact ones.

    The device engines' tables store (f << n) | parent per slot, not g, so the
    walked path arrives with g placeholders.  g is recomputed here by walking
    origin -> goal and accumulating the exact weighted edge costs — the same
    pairCost semantics as expansion (ref: pastar/Node.cpp:129-152,220-246:
    match/mismatch at the parent's position, GapOpen iff the sequence's
    advance state changed vs the parent's own move mask, GapGap when neither
    sequence moves).  If ``goal_g`` is given, the accumulated goal g is
    asserted against it.
    """
    n = problem.n_seq
    pairs = problem.pairs()
    pair_w = [int(weight_i[x, y]) for x, y in pairs]
    enc = [np.frombuffer(s.encode("latin-1"), dtype=np.uint8).astype(np.int32)
           for s in problem.seqs]

    # path ordered goal -> origin, then reversed
    chain: List[Tuple[Tuple[int, ...], int]] = []
    coord = tuple(int(v) for v in problem.final_coord)
    origin = tuple(0 for _ in range(n))
    while coord != origin:
        mask = closed[coord][1]
        chain.append((coord, mask))
        coord = tuple(coord[i] - ((mask >> i) & 1) for i in range(n))
    chain.reverse()

    g = 0
    parent = origin
    parent_mask = problem.root_parent_mask
    out = dict(closed)
    for coord, mask in chain:
        edge = 0
        for k, (x, y) in enumerate(pairs):
            bx = (mask >> x) & 1
            by = (mask >> y) & 1
            if bx and by:
                pc = int(COST_TABLE[enc[x][parent[x]] if parent[x] < len(enc[x]) else 0,
                                    enc[y][parent[y]] if parent[y] < len(enc[y]) else 0])
            elif not bx and not by:
                pc = GAP_GAP
            else:
                s = y if bx else x
                pc = GAP_OPEN if ((parent_mask >> s) & 1) != ((mask >> s) & 1) else GAP_EXTENSION
            edge += pc * pair_w[k]
        g += edge
        out[coord] = (g, mask)
        parent, parent_mask = coord, mask
    if goal_g is not None and chain and g != goal_g:
        raise RuntimeError(f"path g reconstruction mismatch: {g} != {goal_g}")
    return out


def similarity(alignment: List[str]) -> float:
    """Pairwise char-equality percentage (ref: pastar/backtrace.cpp:135-165)."""
    n = len(alignment)
    total = equal = 0
    for col in zip(*alignment):
        for i in range(n):
            for j in range(i + 1, n):
                total += 1
                if col[i] == col[j]:
                    equal += 1
    return (equal * 100) / float(total)


def format_alignment(alignment: List[str], width: int | None = None) -> str:
    """Wrapped alignment text (ref: pastar/backtrace.cpp:171-191)."""
    if width is None:
        width = shutil.get_terminal_size((80, 24)).columns - 1 if sys.stdout.isatty() else 1 << 30
    out: List[str] = []
    L = len(alignment[0])
    for start in range(0, L, width):
        out.append("")
        for row in alignment:
            out.append(row[start:start + width])
    return "\n".join(out)
