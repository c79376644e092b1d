"""All-pairs pairwise suffix-alignment DP tables — the HPair heuristic base.

Semantics match the reference's backward DP (ref: pastar/PairAlign.cpp:137-171):
``table[i, j]`` = optimal cost of aligning suffixes s1[i:] and s2[j:] under the
PAM250 distance + affine bookkeeping, computed from the ends toward (0, 0).
Because GapOpen == GapExtension == 30 in the reference cost model
(pastar/include/Cost.h:13) the recurrence's gap-direction memory never changes
the numbers, but we keep the full affine recurrence (direction matrix) so
non-degenerate gap configurations stay correct.

``suffix_table_numpy`` is the anti-diagonal vectorised NumPy version: the
port's host oracle for the wavefront kernel in ``heuristic/wavefront.py``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.cost import COST_TABLE, GAP_EXTENSION, GAP_OPEN

_NOGAP, _GAPX, _GAPY = 0, 1, 2  # direction codes (ref: pastar/include/PairAlign.h)


def suffix_table_numpy(s1: str, s2: str) -> np.ndarray:
    """(len1+1, len2+1) int32 suffix-alignment cost table.

    Anti-diagonal sweep: cell (i, j) depends on (i+1, j), (i, j+1), (i+1, j+1),
    so all cells with equal i+j are independent — one vector op per diagonal.
    """
    n1, n2 = len(s1), len(s2)
    a = np.frombuffer(s1.encode("latin-1"), dtype=np.uint8).astype(np.int32)
    b = np.frombuffer(s2.encode("latin-1"), dtype=np.uint8).astype(np.int32)
    sub = COST_TABLE[a[:, None], b[None, :]] if n1 and n2 else np.zeros((n1, n2), np.int32)

    m = np.zeros((n1 + 1, n2 + 1), dtype=np.int64)
    aff = np.zeros((n1 + 1, n2 + 1), dtype=np.int8)
    # Border init (ref: pastar/PairAlign.cpp:142-160): first step off the end
    # costs GapOpen, further steps GapExtension.
    m[n1, n2] = 0
    aff[n1, n2] = _NOGAP
    if n2 >= 1:
        m[n1, n2 - 1] = GAP_OPEN
        aff[n1, n2 - 1] = _GAPY
        for j in range(n2 - 2, -1, -1):
            m[n1, j] = m[n1, j + 1] + GAP_EXTENSION
            aff[n1, j] = _GAPY
    if n1 >= 1:
        m[n1 - 1, n2] = GAP_OPEN
        aff[n1 - 1, n2] = _GAPX
        for i in range(n1 - 2, -1, -1):
            m[i, n2] = m[i + 1, n2] + GAP_EXTENSION
            aff[i, n2] = _GAPX

    # Interior, by anti-diagonal d = i + j from high to low.
    for d in range(n1 + n2 - 2, -1, -1):
        i_lo = max(0, d - (n2 - 1))
        i_hi = min(n1 - 1, d)
        if i_lo > i_hi:
            continue
        ii = np.arange(i_lo, i_hi + 1)
        jj = d - ii
        # gapCost(x, y, dir) = GapExtension if aff[x,y]==dir else GapOpen
        c0 = m[ii + 1, jj] + np.where(aff[ii + 1, jj] == _GAPX, GAP_EXTENSION, GAP_OPEN)
        c1 = m[ii, jj + 1] + np.where(aff[ii, jj + 1] == _GAPY, GAP_EXTENSION, GAP_OPEN)
        c2 = m[ii + 1, jj + 1] + sub[ii, jj]
        # Tie order matches ref pairCost (pastar/PairAlign.cpp:107-134):
        # prefer GapX over GapY on tie, diagonal wins only on strict '<'.
        take_x = c0 < c1
        mv = np.where(take_x, c0, c1)
        gv = np.where(take_x, _GAPX, _GAPY)
        diag = c2 < mv
        mv = np.where(diag, c2, mv)
        gv = np.where(diag, _NOGAP, gv)
        m[ii, jj] = mv
        aff[ii, jj] = gv
    return m.astype(np.int32)


def all_pair_tables(seqs: Tuple[str, ...]) -> List[np.ndarray]:
    """Suffix tables for every (i<j) pair, reference enumeration order."""
    n = len(seqs)
    return [suffix_table_numpy(seqs[i], seqs[j]) for i in range(n - 1) for j in range(i + 1, n)]


def stack_pair_tables(tables: List[np.ndarray], lmax: int) -> np.ndarray:
    """Stack per-pair tables into one (P, lmax+1, lmax+1) int32 array.

    Device-resident heuristic storage: h(coord) gathers from this stack.
    Out-of-range cells are padded with a large value (never read for legal
    coords; defensively poisons bad gathers).
    """
    P = len(tables)
    out = np.full((P, lmax + 1, lmax + 1), 2**30, dtype=np.int32)
    for p, t in enumerate(tables):
        out[p, : t.shape[0], : t.shape[1]] = t
    return out
