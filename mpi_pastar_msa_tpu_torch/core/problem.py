"""Problem definition: the N sequences to align and derived constants.

Replacement of the reference's Sequences singleton
(ref: pastar/include/Sequences.h:16-39, pastar/Sequences.cpp:39-87) — a plain
immutable dataclass instead of global state, carrying both host-side strings
and padded device-friendly integer encodings.

Lattice conventions (identical to the reference):
  * a state is a coordinate c in prod([0..len_i]) — c[i] counts consumed
    residues of sequence i; initial coord = all zeros, final = the lengths;
  * the root node's parent move-mask is (1<<N)-1 so the affine-gap context of
    the first move is "every sequence advanced" (ref: pastar/Sequences.cpp:70-77).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

MAX_SEQUENCES = 64  # ref: pastar/include/Sequences.h:31


@dataclass(frozen=True)
class Problem:
    seqs: Tuple[str, ...]

    def __post_init__(self):
        if not (2 <= len(self.seqs) <= MAX_SEQUENCES):
            raise ValueError(f"need 2..{MAX_SEQUENCES} sequences, got {len(self.seqs)}")

    @property
    def n_seq(self) -> int:
        return len(self.seqs)

    @property
    def max_length(self) -> int:
        return max(len(s) for s in self.seqs)

    @property
    def initial_coord(self) -> np.ndarray:
        return np.zeros(self.n_seq, dtype=np.int32)

    @property
    def final_coord(self) -> np.ndarray:
        """Goal coordinate = sequence lengths (ref: pastar/Sequences.cpp:53-60)."""
        return np.array([len(s) for s in self.seqs], dtype=np.int32)

    @property
    def root_parent_mask(self) -> int:
        """Root's parent move mask = all-advance (ref: pastar/Sequences.cpp:75)."""
        return (1 << self.n_seq) - 1

    def encoded(self, pad_to: int | None = None) -> np.ndarray:
        """Sequences as a (N, Lpad) uint8 ASCII array, 0-padded on the right.

        Device-resident residue storage for the expansion kernel; index i of
        sequence s is the residue consumed by the move into coordinate value
        i+1 (the reference reads seq[pos[i]] pre-move, pastar/Node.cpp:225).
        """
        L = pad_to if pad_to is not None else self.max_length
        out = np.zeros((self.n_seq, L), dtype=np.uint8)
        for i, s in enumerate(self.seqs):
            b = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
            out[i, : len(b)] = b
        return out

    def pairs(self) -> List[Tuple[int, int]]:
        """All C(N,2) ordered pairs (i<j), in the reference's enumeration
        order (ref: pastar/HeuristicHPair.cpp:54-62)."""
        n = self.n_seq
        return [(i, j) for i in range(n - 1) for j in range(i + 1, n)]


def problem_from_fasta(path: str) -> Problem:
    from ..io.fasta import read_fasta_file

    return Problem(tuple(read_fasta_file(path)))
