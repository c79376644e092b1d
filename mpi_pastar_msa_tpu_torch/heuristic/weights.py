"""Weighted sum-of-pairs weights: Gotoh distances + NJ tree + Altschul rationale-2.

Precompute replicating the reference pipeline semantics
(ref: pastar/WeightedSP.cpp) bit-for-bit so that optimal WSP scores match:

  1. ``gotoh_distances`` — per pair, a 3-matrix (diag/horiz/vert) global
     alignment DP with GapCost=8 and zero-cost terminal gaps
     (ref: WeightedSP.cpp:144-244), traced back to a per-mille distance
     ``int(0.5 + 1000*(n-match + m-match)/(n+m))`` clamped to >= 1
     (ref: WeightedSP.cpp:109-142, 225-227).
  2. ``neighbor_joining`` — NJ guide tree over those distances
     (ref: WeightedSP.cpp:317-401).
  3. ``rationale2_weights`` — tree-flow partial weights (w/W/v/V) and final
     pair weights rescaled so the smallest is ~8 (``sm /= 7.9``, ``+0.5``)
     (ref: WeightedSP.cpp:424-519).

All floating arithmetic that the reference performs in C ``float`` is emulated
with explicit ``np.float32`` operations (SSE single-precision rounding); the
O(N^3..N^4) tree work on N <= 64 leaves is negligible, so clarity and exact
parity beat vectorisation here.  The per-pair DP is O(L^2) ints and is the only
heavy part: on the host it is NumPy-vectorised by anti-diagonal, on a torch
device all pairs are filled at once (``gotoh_wavefront.py``, kernel K8).

The runtime weight used by both g and h is the float truncated to int
(ref: pastar/Node.cpp:226, pastar/HeuristicHPair.cpp:82).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..core.cost import COST_TABLE, DASH, PRIMER_EFFECTIVE_GAP_COST, PRIMER_GAP_COST
from .gotoh_wavefront import gotoh_matrices_device

_BIG = 999999  # ref: WeightedSP.hpp:12
_DIAG, _VERT, _HORZ = 0, 1, 2

f32 = np.float32


# ---------------------------------------------------------------------------
# Phase A: pairwise Gotoh distances
# ---------------------------------------------------------------------------

def _gotoh_pair_matrices(a: np.ndarray, b: np.ndarray):
    """Fill dd/hh/vv for one dash-prefixed pair, anti-diagonal vectorised.

    ``a``/``b`` are int arrays of the dash-prefixed sequences ('-' + original),
    lengths n+1 / m+1 where n, m are original lengths.  Matches the recurrence
    at ref: WeightedSP.cpp:187-220, including zero ("effective") gap cost on
    the last row/column.

    Index convention (captured from the reference binary, round 2): the
    reference's ``n``/``m`` are the DASH-PREFIXED lengths (n+1/m+1 here), so
    its interior loops ``for (i=1; i<n)`` cover i = 1..n (all real chars) and
    the terminal-gap discount fires at i == n, j == m
    (ref: WeightedSP.cpp:203-216 with n = seqA.length()).
    """
    n = len(a) - 1  # original length
    m = len(b) - 1
    dd = np.full((n + 1, m + 1), _BIG, dtype=np.int64)
    hh = np.full((n + 1, m + 1), _BIG, dtype=np.int64)
    vv = np.full((n + 1, m + 1), _BIG, dtype=np.int64)
    dd[0, 0] = 0
    hh[0, 0] = vv[0, 0] = PRIMER_EFFECTIVE_GAP_COST
    # hh[0, j] accumulates cost(DASH, b[j]); vv[i, 0] accumulates cost(a[i], DASH)
    hh[0, 1:] = np.cumsum(COST_TABLE[DASH, b[1:]]) + hh[0, 0]
    vv[1:, 0] = np.cumsum(COST_TABLE[a[1:], DASH]) + vv[0, 0]

    sub = COST_TABLE[a[:, None], b[None, :]].astype(np.int64)  # sub[i, j] = cost(a[i], b[j])
    gapH = COST_TABLE[DASH, b].astype(np.int64)               # cost(DASH, b[j])
    gapV = COST_TABLE[a, DASH].astype(np.int64)               # cost(a[i], DASH)

    # Interior cells (1..n) x (1..m); Gi/Gj become 0 on the last row/column
    # (terminal-gap discount).
    for d in range(2, n + m + 1):
        i_lo = max(1, d - m)
        i_hi = min(n, d - 1)
        if i_lo > i_hi:
            continue
        ii = np.arange(i_lo, i_hi + 1)
        jj = d - ii
        Gi = np.where(ii == n, PRIMER_EFFECTIVE_GAP_COST, PRIMER_GAP_COST)
        Gj = np.where(jj == m, PRIMER_EFFECTIVE_GAP_COST, PRIMER_GAP_COST)
        d_diag = np.minimum(np.minimum(dd[ii - 1, jj - 1], hh[ii - 1, jj - 1]), vv[ii - 1, jj - 1]) + sub[ii, jj]
        h_new = np.minimum(np.minimum(dd[ii, jj - 1] + Gi, hh[ii, jj - 1]), vv[ii, jj - 1] + Gi) + gapH[jj]
        v_new = np.minimum(np.minimum(dd[ii - 1, jj] + Gj, hh[ii - 1, jj] + Gj), vv[ii - 1, jj]) + gapV[ii]
        dd[ii, jj] = d_diag
        hh[ii, jj] = h_new
        vv[ii, jj] = v_new
    return dd, hh, vv


def _traceback_distance(a: np.ndarray, b: np.ndarray, dd, hh, vv) -> int:
    """Walk the optimal path and convert to per-mille distance
    (ref: WeightedSP.cpp:109-142).  ``a``/``b`` dash-prefixed."""
    n = len(a) - 1
    m = len(b) - 1
    # The reference calls convert_path_to_cost with n-1, m-1 where n/m are the
    # dash-PREFIXED lengths (ref: WeightedSP.cpp:223), i.e. the ORIGINAL
    # lengths — verified against the reference binary (round 2).
    i, j = n, m
    N_, M_ = i, j        # traceback bounds
    direction = _DIAG
    match = 0
    while i or j:
        V = vv[i, j] - ((PRIMER_EFFECTIVE_GAP_COST if j == M_ else PRIMER_GAP_COST) if direction == _VERT else 0)
        H = hh[i, j] - ((PRIMER_EFFECTIVE_GAP_COST if i == N_ else PRIMER_GAP_COST) if direction == _HORZ else 0)
        Mv = min(V, H, dd[i, j])
        if (not j) or Mv == V:
            direction = _VERT
            i -= 1
        elif (not i) or Mv == H:
            direction = _HORZ
            j -= 1
        else:
            direction = _DIAG
            match += int(a[i] == b[j])
            i -= 1
            j -= 1
    return int(0.5 + 1000.0 * (N_ - match + M_ - match) / (N_ + M_))


def gotoh_distances(seqs: Tuple[str, ...], device=None) -> np.ndarray:
    """(N, N) float32 symmetric per-mille distance matrix, min-clamped to 1.

    ``device=None`` fills the O(L^2) Gotoh matrices on the host, the JAX
    package's default; a ``torch.device`` fills all pairs at once through
    ``gotoh_wavefront.gotoh_matrices_device`` (kernel K8 on the card, its
    plain version on the CPU), bit-identical int arithmetic.  Neither has a
    length cap (the reference caps this phase at ``MAX_SEQ_SIZE=1000``,
    ref: pastar/include/WeightedSP.hpp:10).  The per-mille traceback is
    host-side either way."""
    enc = []
    for s in seqs:
        # dash-prefix workaround (ref: WeightedSP.cpp:445-447)
        enc.append(np.frombuffer(("-" + s).encode("latin-1"), dtype=np.uint8).astype(np.int32))
    n = len(seqs)
    D = np.zeros((n, n), dtype=np.float32)
    ij = [(I, J) for I in range(n - 1) for J in range(I + 1, n)]
    if device is not None:
        mats = gotoh_matrices_device(
            [(enc[I], enc[J]) for I, J in ij],
            [(len(enc[I]) - 1, len(enc[J]) - 1) for I, J in ij], device)
    else:
        mats = [_gotoh_pair_matrices(enc[I], enc[J]) for I, J in ij]
    for (I, J), (dd, hh, vv) in zip(ij, mats):
        dist = _traceback_distance(enc[I], enc[J], dd, hh, vv)
        if dist <= 0:
            dist = 1  # rationale-2 needs distances >= 1 (ref: WeightedSP.cpp:225-227)
        D[I, J] = D[J, I] = f32(dist)
    return D


# ---------------------------------------------------------------------------
# Phase B: neighbor-joining guide tree
# ---------------------------------------------------------------------------

@dataclass
class TreeNode:
    """Guide-tree node (ref: pastar/include/WeightedSP.hpp:27-66)."""
    sequence_number: int  # >=0 leaf; -1 internal; -2 root
    parent: Optional["TreeNode"] = None
    left: Optional["TreeNode"] = None
    right: Optional["TreeNode"] = None
    brother: Optional["TreeNode"] = None
    weight: np.float32 = f32(0.0)
    w: np.float32 = f32(0.0)
    W: np.float32 = f32(0.0)
    v: np.float32 = f32(0.0)
    V: np.float32 = f32(0.0)


def _path_cost_rec(A: TreeNode, B: TreeNode, D: np.ndarray, length: List[int]) -> np.float32:
    """Sum of leaf-leaf distances between the leaf sets under A and B, counting
    traversed internal nodes (ref: WeightedSP.cpp:248-264)."""
    if A.sequence_number < 0:
        length[0] += 1
        return f32(_path_cost_rec(A.left, B, D, length) + _path_cost_rec(A.right, B, D, length))
    if B.sequence_number < 0:
        length[0] += 1
        return f32(_path_cost_rec(A, B.left, D, length) + _path_cost_rec(A, B.right, D, length))
    return D[A.sequence_number, B.sequence_number]


def _path_cost_nodes(A: TreeNode, B: TreeNode, D: np.ndarray) -> np.float32:
    length = [1]
    cost = _path_cost_rec(A, B, D, length)
    return f32(cost / length[0])


def _path_cost(i: int, j: int, tree: List[TreeNode], D: np.ndarray) -> np.float32:
    return _path_cost_nodes(tree[i], tree[j], D)


def _path_cost_to_leafs(A: TreeNode, total: np.float32, count2: List[int]) -> np.float32:
    """ref: WeightedSP.cpp:55-61."""
    if A.sequence_number >= 0:
        return f32(total + A.weight)
    count2[0] += 1
    return f32(
        _path_cost_to_leafs(A.left, f32(A.weight + total), count2)
        + _path_cost_to_leafs(A.right, f32(A.weight + total), count2)
    )


def _compute_S(i: int, j: int, tree: List[TreeNode], D: np.ndarray) -> np.float32:
    """NJ selection criterion (ref: WeightedSP.cpp:288-309)."""
    nn = len(tree)
    s1 = f32(0.0)
    s2 = f32(0.0)
    for t in range(nn):
        if t != i and t != j:
            s1 = f32(s1 + f32(_path_cost(i, t, tree, D) + _path_cost(j, t, tree, D)))
    s1 = f32(s1 / (2 * (nn - 2)))
    for t in range(nn - 1):
        for tt in range(t + 1, nn):
            if t != i and t != j and tt != i and tt != j:
                s2 = f32(s2 + _path_cost(t, tt, tree, D))
    s2 = f32(s2 / (nn - 2))
    return f32(f32(s1 + s2) + f32(_path_cost(i, j, tree, D) / 2))


def _compute_curr_cost(i: int, j: int, tree: List[TreeNode], D: np.ndarray) -> np.float32:
    """Branch length of node i when joined with j (ref: WeightedSP.cpp:63-77)."""
    nn = len(tree)
    diz = f32(0.0)
    djz = f32(0.0)
    for t in range(nn):
        if t != i and t != j:
            diz = f32(diz + _path_cost(i, t, tree, D))
            djz = f32(djz + _path_cost(j, t, tree, D))
    diz = f32(diz / (nn - 2))
    djz = f32(djz / (nn - 2))
    count2 = [1]
    leaf_term = _path_cost_to_leafs(tree[i], f32(0.0), count2)
    return f32(
        f32(f32(f32(_path_cost(i, j, tree, D) + diz) - djz) / 2) - f32(leaf_term / count2[0])
    )


def neighbor_joining(n_seq: int, D: np.ndarray) -> Tuple[List[TreeNode], List[TreeNode]]:
    """Build the NJ guide tree; returns (tree, nodes_list) where nodes_list is
    leaves in order, then internal nodes in join order, then the root
    (ref: WeightedSP.cpp:317-401)."""
    tree: List[TreeNode] = []
    nodes_list: List[TreeNode] = []
    for i in range(n_seq):
        node = TreeNode(sequence_number=i)
        tree.append(node)
        nodes_list.append(node)

    while len(tree) > 2:
        best = f32(1.0e20)
        min_i = min_j = 0
        nn = len(tree)
        for i in range(nn - 1):
            for j in range(i + 1, nn):
                tmp = _compute_S(i, j, tree, D)
                if tmp < best:
                    min_i, min_j, best = i, j, tmp
        # join (ref: WeightedSP.cpp:79-107)
        left = tree[min_i]
        left.weight = _compute_curr_cost(min_i, min_j, tree, D)
        right = tree[min_j]
        right.weight = _compute_curr_cost(min_j, min_i, tree, D)
        new = TreeNode(sequence_number=-1, left=left, right=right)
        left.brother = right
        right.brother = left
        left.parent = right.parent = new
        nodes_list.append(new)
        tree[min_i] = new
        tree[min_j] = tree[-1]
        tree.pop()

    left, right = tree[0], tree[1]
    ancestor = TreeNode(sequence_number=-2, left=left, right=right)
    left.brother = right
    right.brother = left
    left.parent = right.parent = ancestor
    tree = [ancestor]
    nodes_list.append(ancestor)

    # ancestor's left-son branch length (ref: WeightedSP.cpp:390-397)
    count2 = [1]
    length = f32(_path_cost_nodes(left, right, D))
    length = f32(length - f32(_path_cost_to_leafs(left, f32(0.0), count2) / count2[0]))
    count2 = [1]
    length = f32(length - f32(_path_cost_to_leafs(right, f32(0.0), count2) / count2[0]))
    ancestor.left.weight = length
    return tree, nodes_list


# ---------------------------------------------------------------------------
# Phase C: rationale-2 weights from the tree
# ---------------------------------------------------------------------------

def _weights_from_tree(product: np.float32, total: np.float32, no: TreeNode,
                       brother: Optional[TreeNode], wm: np.ndarray, leaf: TreeNode):
    """ref: WeightedSP.cpp:403-420."""
    if no.sequence_number > -1:
        wm[leaf.sequence_number, no.sequence_number] = f32(total * product)
    elif brother is None:
        _weights_from_tree(f32(product * no.left.W), f32(total + no.right.weight), no.right, None, wm, leaf)
        _weights_from_tree(f32(product * no.right.W), f32(total + no.left.weight), no.left, None, wm, leaf)
    else:
        _weights_from_tree(f32(product * no.V), f32(total + brother.weight), brother, None, wm, leaf)
        if no.sequence_number != -2:
            _weights_from_tree(f32(product * brother.W), f32(total + no.weight), no.parent, no.brother, wm, leaf)


def rationale2_weights(n_seq: int, nodes_list: List[TreeNode]) -> np.ndarray:
    """(N, N) float32 symmetric scaled pair weights (ref: WeightedSP.cpp:464-509)."""
    idx = 0
    # partial weights of leaves
    while nodes_list[idx].sequence_number > -1:
        no = nodes_list[idx]
        no.w = f32(1.0)
        no.W = no.weight
        idx += 1
    # partial weights of internal nodes
    while nodes_list[idx].sequence_number > -2:
        no = nodes_list[idx]
        no.w = f32(f32(no.left.w * no.right.W) + f32(no.left.W * no.right.w))
        no.W = f32(f32(no.weight * no.w) + f32(no.left.W * no.right.W))
        idx += 1
    root = nodes_list[idx]
    root.V = f32(1.0)
    root.v = f32(0.0)
    # downward pass, root-1 back to the first node
    while idx != 0:
        idx -= 1
        no = nodes_list[idx]
        no.v = f32(f32(no.parent.v * no.brother.W) + f32(no.parent.V * no.brother.w))
        no.V = f32(f32(no.weight * no.v) + f32(no.parent.V * no.brother.W))

    raw = np.zeros((n_seq, n_seq), dtype=np.float32)
    i = 0
    while nodes_list[i].sequence_number > -1:
        leaf = nodes_list[i]
        _weights_from_tree(f32(1.0), leaf.weight, leaf.parent, leaf.brother, raw, leaf)
        i += 1

    # rescale so the smallest pair weight is ~8 (ref: WeightedSP.cpp:497-509)
    sm = f32(1.0e30)
    for j in range(1, n_seq):
        for i in range(j):
            if raw[i, j] < sm:
                sm = raw[i, j]
    sm = f32(np.float64(sm) / 7.9)
    out = np.zeros((n_seq, n_seq), dtype=np.float32)
    for i in range(n_seq - 1):
        for j in range(i + 1, n_seq):
            out[i, j] = out[j, i] = f32(np.float64(f32(raw[i, j] / sm)) + 0.5)
    return out


def altschul_rationale2(seqs: Tuple[str, ...],
                        device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Full pipeline: sequences -> (float weight matrix, int runtime weights).

    ``device`` is where the Gotoh matrices are filled (``gotoh_distances``):
    None on the host, else a ``torch.device``.

    The int weights are the float weights truncated toward zero, exactly as the
    reference casts at every use site (pastar/Node.cpp:226,242;
    pastar/HeuristicHPair.cpp:82).
    """
    n = len(seqs)
    D = gotoh_distances(seqs, device)
    _, nodes_list = neighbor_joining(n, D)
    wf = rationale2_weights(n, nodes_list)
    wi = wf.astype(np.int32)  # C-style float->int truncation
    return wf, wi
