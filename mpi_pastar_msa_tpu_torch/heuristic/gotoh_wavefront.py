"""Gotoh primer matrices for every sequence pair on the card (kernel K8).

The Altschul rationale-2 weights (``weights.py``) start from a per-pair
3-matrix (diag/horiz/vert) global alignment with the primer gap costs
(ref: pastar/WeightedSP.cpp:144-220).  ``gotoh_matrices`` fills dd, hh and
vv of all C(N,2) pairs at once: on a CUDA tensor it launches the
hand-written kernel ``csrc/gotoh_wavefront.cu`` (one thread block a pair,
one thread a band of rows, its shape from ``k8_launch_shape``, each
diagonal stored coalesced into a diagonal-major scratch of
``k8_scratch_shape``, then a tiled transpose into the output); on a CPU
tensor it runs the plain PyTorch version below, a loop over anti-diagonals
batched over the pairs, written from the JAX scan
(mpi_pastar_msa_tpu/heuristic/gotoh_wavefront.py::_gotoh_wavefront).  The
CUDA path never falls back to the plain version.

Layout: the sequences are dash-prefixed as in the reference's workaround
(ref: WeightedSP.cpp:445-447), so a pair of lengths (n, m) has (n+1) x (m+1)
matrices: the origin dd = 0, hh = vv = the effective gap cost; the borders
hh[0, j] = hh[0, j-1] + cost(-, b_j) and vv[i, 0] = vv[i-1, 0] + cost(a_i, -);
on the interior (1..n) x (1..m)

  dd = min(dd, hh, vv)[i-1, j-1] + cost(a_i, b_j)
  hh = min(dd + Gi, hh, vv + Gi)[i, j-1] + cost(-, b_j)
  vv = min(dd + Gj, hh + Gj, vv)[i-1, j] + cost(a_i, -)

with Gi the effective gap cost on row i = n (the last real residue) and the
primer gap cost elsewhere, Gj the same on column j = m; every other cell,
inside the pair's (l1, l1) square or outside its box, is ``_BIG`` = 999999
(not K1's 2^28).  All arithmetic is int32, bit-identical to the host fill
``weights._gotoh_pair_matrices`` (int64 there; every value stays far below
2^31).  The per-mille traceback stays on the host: ``gotoh_matrices_device``
crops each pair's box on the device, at offsets built on the host from the
lengths it already knows, and copies them back in one transfer into pinned
memory.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from ..core.cost import COST_TABLE, DASH, PRIMER_EFFECTIVE_GAP_COST, PRIMER_GAP_COST
from .wavefront import _check, _device_cost

_BIG = 999999  # ref: WeightedSP.hpp:12
#: rows a thread may own (kMaxRows of the kernel's source)
K8_MAX_ROWS = 22


def k8_launch_shape(l1: int) -> tuple:
    """(threads, rows per thread, shared bytes) of the K8 kernel for a
    dash-prefixed length l1 = Lmax + 1.

    Each thread owns R = ceil(l1 / 1024) contiguous rows, and the block has
    ceil(l1 / R) threads rounded up to a warp.  Shared memory holds the
    parity buffers of the band edges (2 x threads int2), the 128 x 128
    cost table and both residue rows as uint8 (``shared_bytes`` in the
    kernel's source): at most 77,824 bytes, within the 232,448 a block may
    use (above 48 KB the C entry asks for the larger dynamic size).  Raises
    ValueError above K8_MAX_ROWS rows a thread: the kernel has no other
    shape."""
    if l1 < 1:
        raise ValueError(f"K8: l1={l1}, need >= 1")
    rows = -(-l1 // 1024)
    if rows > K8_MAX_ROWS:
        raise ValueError(f"K8: l1={l1} needs {rows} rows a thread, above the "
                         f"{K8_MAX_ROWS} the kernel takes")
    threads = -(-l1 // rows)
    threads = -(-threads // 32) * 32
    return threads, rows, 16 * threads + 128 * 128 + 2 * l1


def k8_scratch_shape(P: int, l1: int) -> tuple:
    """Shape of K8's int32 scratch: (dd, hh, vv) x P pairs x the 2 l1 - 1
    anti-diagonals x W = rows x threads lanes.  The fill stores cell (i, j)
    of pair p at [c, p, i + j, i], a diagonal's cells side by side, and the
    transpose reads them back into the (3, P, l1, l1) output; about twice
    the output's bytes."""
    threads, rows, _ = k8_launch_shape(l1)
    return 3, P, 2 * l1 - 1, threads * rows


def gotoh_inputs(enc_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                 lens: Sequence[Tuple[int, int]], device) -> dict:
    """The kernel's inputs: the dash-prefixed pairs as (P, l1) int32 residue
    codes, 0-padded (``seq_a``, ``seq_b``), the original lengths (n, m) as
    (P,) int32 (``n1s``, ``n2s``), and l1, the longest dash-prefixed
    length (no rounding up)."""
    dev = torch.device(device)
    P = len(enc_pairs)
    l1 = max(max(len(a), len(b)) for a, b in enc_pairs)
    seq_a = np.zeros((P, l1), dtype=np.int32)
    seq_b = np.zeros((P, l1), dtype=np.int32)
    for p, (a, b) in enumerate(enc_pairs):
        seq_a[p, : len(a)] = a
        seq_b[p, : len(b)] = b
    return dict(
        seq_a=torch.from_numpy(seq_a).to(dev),
        seq_b=torch.from_numpy(seq_b).to(dev),
        n1s=torch.tensor([n for n, _ in lens], dtype=torch.int32, device=dev),
        n2s=torch.tensor([m for _, m in lens], dtype=torch.int32, device=dev),
        l1=l1,
    )


def gotoh_matrices_plain(seq_a, seq_b, n1s, n2s, l1: int) -> torch.Tensor:
    """Plain PyTorch version: (3, P, l1, l1) int32 (dd, hh, vv) on seq_a's
    device.

    Written from the JAX scan: diagonals d-1 and d-2 of the three matrices
    carried over the lanes i of a diagonal, one tensor op a term over all
    pairs, and each diagonal's cells (i, d - i) written into the output."""
    dev = seq_a.device
    P = seq_a.shape[0]
    cost = torch.from_numpy(COST_TABLE).to(dev).long()
    a, b = seq_a.long(), seq_b.long()
    gH_row = cost[DASH, b].int()   # (P, l1) cost(-, b[j])
    gV = cost[a, DASH].int()       # (P, l1) cost(a[i], -)
    n = n1s.long()[:, None]
    m = n2s.long()[:, None]
    i = torch.arange(l1, device=dev)[None, :]
    EGC, GC = PRIMER_EFFECTIVE_GAP_COST, PRIMER_GAP_COST
    Gi = torch.where(i == n, EGC, GC).int()
    big = torch.full((P, l1), _BIG, dtype=torch.int32, device=dev)
    pad = big[:, :1]
    out = torch.full((3, P, l1, l1), _BIG, dtype=torch.int32, device=dev)

    def up(x):  # lane i - 1 of the same diagonal
        return torch.cat([pad, x[:, :-1]], dim=1)

    dd1 = hh1 = vv1 = dd2 = hh2 = vv2 = big
    for d in range(2 * l1 - 1):
        j = d - i
        jc = j.clamp(0, l1 - 1).expand(P, l1)
        Gj = torch.where(j == m, EGC, GC).int()
        gH = gH_row.gather(1, jc)
        sub = cost[a, b.gather(1, jc)].int()
        d_new = torch.minimum(torch.minimum(up(dd2), up(hh2)), up(vv2)) + sub
        h_new = torch.minimum(torch.minimum(dd1 + Gi, hh1), vv1 + Gi) + gH
        v_new = torch.minimum(torch.minimum(up(dd1) + Gj, up(hh1) + Gj), up(vv1)) + gV
        interior = (i >= 1) & (i <= n) & (j >= 1) & (j <= m)
        top = (i == 0) & (j >= 1) & (j <= m)
        left = (j == 0) & (i >= 1) & (i <= n)
        origin = (i == 0) & (j == 0)
        dd_d = torch.where(origin, 0, torch.where(interior, d_new, big))
        hh_d = torch.where(origin, EGC, torch.where(
            top, hh1 + gH, torch.where(interior, h_new, big)))
        vv_d = torch.where(origin, EGC, torch.where(
            left, up(vv1) + gV, torch.where(interior, v_new, big)))
        ii = torch.arange(max(0, d - l1 + 1), min(d, l1 - 1) + 1, device=dev)
        for k, x in enumerate((dd_d, hh_d, vv_d)):
            out[k][:, ii, d - ii] = x[:, ii]
        dd2, hh2, vv2, dd1, hh1, vv1 = dd1, hh1, vv1, dd_d, hh_d, vv_d
    return out


def gotoh_matrices(seq_a, seq_b, n1s, n2s, l1: int) -> torch.Tensor:
    """(3, P, l1, l1) int32 (dd, hh, vv) on seq_a's device.

    CUDA tensors launch the K8 kernel (or raise); CPU tensors run the plain
    version."""
    if seq_a.device.type != "cuda":
        return gotoh_matrices_plain(seq_a, seq_b, n1s, n2s, l1)
    dev = seq_a.device
    _check(seq_a, "seq_a", dev, 2)
    _check(seq_b, "seq_b", dev, 2)
    _check(n1s, "n1s", dev, 1)
    _check(n2s, "n2s", dev, 1)
    P = seq_a.shape[0]
    if (seq_b.shape != seq_a.shape or seq_a.shape[1] != l1 or n1s.shape[0] != P
            or n2s.shape[0] != P):
        raise ValueError("gotoh_matrices: inconsistent shapes")
    if P:
        lo, hi = torch.stack([torch.cat([n1s, n2s]).min(),
                              torch.cat([n1s, n2s]).max()]).tolist()
        if lo < 0 or hi >= l1:
            raise ValueError(f"gotoh_matrices: lengths {lo}..{hi}, need 0..{l1 - 1}")
    return _gotoh_cuda(seq_a, seq_b, n1s, n2s, l1)


def _gotoh_cuda(seq_a, seq_b, n1s, n2s, l1: int) -> torch.Tensor:
    """Launch K8 on inputs already checked, with no read of the device: the
    fill into a scratch of ``k8_scratch_shape``, released on return, and the
    transpose into the output."""
    dev = seq_a.device
    threads, rows, shared = k8_launch_shape(l1)
    P = seq_a.shape[0]
    out = torch.empty((3, P, l1, l1), dtype=torch.int32, device=dev)
    if P == 0:
        return out
    scratch = torch.empty(k8_scratch_shape(P, l1), dtype=torch.int32, device=dev)
    _kernels.launch(
        "gotoh_wavefront", seq_a.data_ptr(), seq_b.data_ptr(), n1s.data_ptr(),
        n2s.data_ptr(), _device_cost(dev).data_ptr(), scratch.data_ptr(), out.data_ptr(),
        P, l1, PRIMER_GAP_COST, PRIMER_EFFECTIVE_GAP_COST, threads, rows, shared,
        torch.cuda.current_stream(dev).cuda_stream)
    return out


def box_offsets(lens: Sequence[Tuple[int, int]], l1: int) -> tuple:
    """Where each pair's (n+1) x (m+1) box lies in the flat (P, l1, l1)
    matrices, built on the host: one entry a box row, its length (m + 1)
    and the shift from its place in the packed boxes to its place in the
    matrices.  Flat cell k of the packed boxes is cell k + shift of its
    row; the boxes follow one another, pair by pair, row by row."""
    n = np.array([a for a, _ in lens], dtype=np.int64)
    m = np.array([b for _, b in lens], dtype=np.int64)
    pair = np.repeat(np.arange(len(lens)), n + 1)
    first_row = np.cumsum(n + 1) - (n + 1)
    i = np.arange(len(pair)) - first_row[pair]
    row_len = m[pair] + 1
    packed_at = np.cumsum(row_len) - row_len
    return row_len, (pair * l1 + i) * l1 - packed_at


def crop_boxes(mats: torch.Tensor, lens: Sequence[Tuple[int, int]]) -> np.ndarray:
    """(3, sum of boxes) int32 NumPy array of every pair's box of the (3, P,
    l1, l1) ``mats``, packed as ``box_offsets`` lays them out: one gather on
    the matrices' device from host-built offsets (no read of the device to
    size it), then, from the card, one copy into pinned host memory."""
    dev, l1 = mats.device, mats.shape[-1]
    row_len, shift = box_offsets(lens, l1)
    total = int(row_len.sum())
    idx = torch.arange(total, device=dev) + torch.repeat_interleave(
        torch.from_numpy(shift).to(dev), torch.from_numpy(row_len).to(dev),
        output_size=total)
    flat = mats.view(3, -1).index_select(1, idx)
    if dev.type == "cuda":
        host = torch.empty((3, total), dtype=torch.int32, pin_memory=True)
        flat = host.copy_(flat)
    return flat.numpy()


def gotoh_matrices_device(enc_pairs, lens, device) -> List[tuple]:
    """Batched fill on ``device`` (JAX ``gotoh_matrices_device``).

    enc_pairs: list of (a, b) int arrays, dash-prefixed (as weights.py builds)
    lens:      list of (n, m) original lengths
    Returns the list of (dd, hh, vv) int32 NumPy triples of shape (n+1, m+1)
    each, equal in value to ``weights._gotoh_pair_matrices`` (int64 there;
    the traceback needs no wider type).  The lengths are checked here, on
    the host, so the launch skips the wrapper's read of them from the
    device; the boxes come back through ``crop_boxes``."""
    args = gotoh_inputs(enc_pairs, lens, device)
    l1 = args["l1"]
    if any(not (0 <= n < l1 and 0 <= m < l1) for n, m in lens):
        raise ValueError(f"gotoh_matrices_device: lengths outside 0..{l1 - 1}")
    fill = _gotoh_cuda if args["seq_a"].device.type == "cuda" else gotoh_matrices_plain
    flat = crop_boxes(fill(**args), lens)
    out, off = [], 0
    for n, m in lens:
        k = (n + 1) * (m + 1)
        out.append(tuple(flat[c, off: off + k].reshape(n + 1, m + 1) for c in range(3)))
        off += k
    return out
