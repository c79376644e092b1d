"""Scoring model: PAM250-derived distance table + gap penalties.

Equivalent of the reference scoring layer
(ref: pastar/include/Cost.h:10-50, pastar/Cost.cpp:267-271): a char-indexed
distance table (lower = better) with gap penalties
GapExtension = GapOpen = GapGap = 30 (ref: pastar/include/Cost.h:13).

Here the table is materialised once as a dense 128x128 int32 NumPy array
indexed by raw ASCII byte, mirroring the reference's char-indexed 2-D array
(including its quirk that unassigned pairs cost 0).  The same array is shipped
to the GPU as a device-resident lookup table for the pair-wavefront kernel.
"""
from __future__ import annotations

import numpy as np

from .pam250_data import PAM250_ENTRIES

# Gap penalties (ref: pastar/include/Cost.h:13)
GAP_EXTENSION = 30
GAP_OPEN = 30
GAP_GAP = GAP_OPEN

# Gotoh 'primer' weight-precompute gap costs (ref: pastar/include/WeightedSP.hpp:17,21)
PRIMER_GAP_COST = 8
PRIMER_EFFECTIVE_GAP_COST = 0

DASH = ord("-")

_TABLE_SIZE = 128  # covers 7-bit ASCII; reference uses ['Z']['Z'] = 90x90


def build_cost_table() -> np.ndarray:
    """Dense (128, 128) int32 distance table indexed by ASCII code."""
    t = np.zeros((_TABLE_SIZE, _TABLE_SIZE), dtype=np.int32)
    for (a, b), v in PAM250_ENTRIES.items():
        t[ord(a), ord(b)] = v
    return t


COST_TABLE = build_cost_table()


def cost(a: int | str, b: int | str) -> int:
    """Scalar pairwise residue cost (ref: pastar/Cost.cpp:267-271)."""
    ia = ord(a) if isinstance(a, str) else a
    ib = ord(b) if isinstance(b, str) else b
    return int(COST_TABLE[ia, ib])
