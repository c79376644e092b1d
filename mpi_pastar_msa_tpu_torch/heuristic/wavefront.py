"""Pairwise suffix-DP tables for every sequence pair (kernel K1).

``wavefront_tables`` computes, for each pair p = (x, y), the (i, j)-major
table ``out[p, i, j]`` = least cost to align ``seq_x[i:]`` with ``seq_y[j:]``
(ref: pastar/PairAlign.cpp:96-171), with the reference's tie order (GapX over
GapY, the diagonal only on strict ``<``), gap-run borders and ``_BIG`` in
every cell outside a pair's (n1+1) x (n2+1) box.

On a CUDA tensor it launches the hand-written kernel ``csrc/pair_wavefront.cu``
(one thread block per pair, one thread per row band, its shape from
``k1_launch_shape``); on a CPU tensor it runs the plain PyTorch version
below, a loop over anti-diagonals batched over all pairs.  The CUDA path
never falls back to the plain version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels
from ..core.cost import COST_TABLE, GAP_EXTENSION, GAP_OPEN
from ..core.problem import Problem

_BIG = 2**28
_NOGAP, _GAPX, _GAPY = 0, 1, 2
#: shared memory one thread block may use on an H100 (232,448 bytes)
_SHARED_LIMIT = 232_448


def k1_launch_shape(lmax: int) -> tuple:
    """(threads, rows per thread, shared bytes) of the K1 kernel for Lmax.

    Each thread owns R = ceil(L1 / 1024) contiguous rows of the L1 = Lmax+1
    rows, and the block has ceil(L1 / R) threads rounded up to a warp.
    Shared memory holds two int32 rows of L1+1 words, the 128 x 128 uint8
    cost table and both residue rows as uint8 (``shared_bytes`` in the
    kernel's source).  Raises ValueError when that exceeds one block's
    limit: the kernel has no other shape."""
    L1 = lmax + 1
    rows = -(-L1 // 1024)
    threads = -(-L1 // rows)
    threads = -(-threads // 32) * 32
    shared = 8 * (L1 + 1) + 128 * 128 + 2 * L1
    if shared > _SHARED_LIMIT:
        raise ValueError(f"K1: Lmax={lmax} needs {shared} bytes of shared "
                         f"memory, above the {_SHARED_LIMIT} a block may use")
    return threads, rows, shared


def pair_inputs(problem: Problem, device) -> dict:
    """The kernel's inputs for a problem: encoded residues (N, Lmax) int32,
    pair endpoints xs/ys (P,) int32, sequence lengths (N,) int32, Lmax."""
    pairs = problem.pairs()
    dev = torch.device(device)
    return dict(
        enc=torch.from_numpy(problem.encoded().astype(np.int32)).to(dev),
        xs=torch.tensor([x for x, _ in pairs], dtype=torch.int32, device=dev),
        ys=torch.tensor([y for _, y in pairs], dtype=torch.int32, device=dev),
        lens=torch.tensor([len(s) for s in problem.seqs], dtype=torch.int32,
                          device=dev),
        lmax=problem.max_length,
    )


def wavefront_tables_plain(enc, xs, ys, lens, lmax: int) -> torch.Tensor:
    """Plain PyTorch version: (P, Lmax+1, Lmax+1) int32 on enc's device.

    Written from the JAX scan (``_wavefront_tables``): rolling diagonals
    d+1 (value, direction) and d+2, one tensor op per diagonal over all
    pairs, diagonal-major buffer gathered to (i, j)-major at the end."""
    dev = enc.device
    P = xs.shape[0]
    L1 = lmax + 1
    E, O = GAP_EXTENSION, GAP_OPEN
    cost = torch.from_numpy(COST_TABLE).to(dev).long()
    a = enc.long()[xs.long()]  # (P, Lmax)
    b = enc.long()[ys.long()]
    n1 = lens.long()[xs.long()][:, None]  # (P, 1)
    n2 = lens.long()[ys.long()][:, None]
    D = n1 + n2
    clip = max(lmax - 1, 0)
    i = torch.arange(L1, device=dev)[None, :]  # (1, L1)
    a_i = a[:, i[0].clamp(max=clip)] if lmax > 0 else torch.zeros(P, L1, dtype=torch.long, device=dev)
    big = torch.full((P, 1), _BIG, dtype=torch.long, device=dev)
    nogap = torch.zeros((P, 1), dtype=torch.long, device=dev)

    v1 = torch.where(i == n1, 0, _BIG).expand(P, L1).contiguous()  # diag D
    a1 = torch.zeros((P, L1), dtype=torch.long, device=dev)
    v2 = torch.full((P, L1), _BIG, dtype=torch.long, device=dev)
    # diag-major buffer; negative diagonals land in the trash row 2*lmax+1
    buf = torch.full((P, 2 * lmax + 2, L1), _BIG, dtype=torch.long, device=dev)
    prow = torch.arange(P, device=dev)
    buf[prow, D[:, 0].clamp(max=2 * lmax + 1)] = v1
    for dr in range(2 * lmax):
        d = D - dr - 1  # (P, 1)
        j = d - i
        in_range = (i <= n1) & (j >= 0) & (j <= n2)
        v1s = torch.cat([v1[:, 1:], big], dim=1)
        a1s = torch.cat([a1[:, 1:], nogap], dim=1)
        v2s = torch.cat([v2[:, 1:], big], dim=1)
        if lmax > 0:
            sub = cost[a_i, b.gather(1, j.clamp(0, clip))]
        else:
            sub = torch.zeros_like(v1)
        c0 = v1s + torch.where(a1s == _GAPX, E, O)
        c1 = v1 + torch.where(a1 == _GAPY, E, O)
        c2 = v2s + sub
        take_x = c0 < c1
        mv = torch.where(take_x, c0, c1)
        gv = torch.where(take_x, _GAPX, _GAPY)
        dwin = c2 < mv
        mv = torch.where(dwin, c2, mv)
        gv = torch.where(dwin, _NOGAP, gv)
        bottom = O + (n2 - 1 - j) * E
        right = O + (n1 - 1 - i) * E
        bval = torch.where(i == n1, torch.where(j == n2, 0, bottom), right)
        baff = torch.where((i == n1) & (j == n2), _NOGAP,
                           torch.where(i == n1, _GAPY, _GAPX))
        is_border = (i == n1) | (j == n2)
        mv = torch.where(is_border, bval, mv)
        gv = torch.where(is_border, baff, gv)
        mv = torch.where(in_range, mv, _BIG)
        gv = torch.where(in_range, gv, _NOGAP)
        buf[prow, torch.where(d[:, 0] >= 0, d[:, 0], 2 * lmax + 1)] = mv
        v2, v1, a1 = v1, mv, gv
    ii = torch.arange(L1, device=dev)[:, None]
    jj = torch.arange(L1, device=dev)[None, :]
    out = buf[:, (ii + jj).clamp(max=2 * lmax + 1), ii.expand(L1, L1)]
    valid = (ii[None] <= n1[:, :, None]) & (jj[None] <= n2[:, :, None])
    return torch.where(valid, out, _BIG).to(torch.int32)


def _check(t: torch.Tensor, name: str, device, ndim: int) -> None:
    if t.device != device or t.dtype != torch.int32 or t.dim() != ndim:
        raise ValueError(f"{name}: need int32, {ndim}-D, on {device}; got "
                         f"{t.dtype}, {t.dim()}-D, on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _device_cost(dev) -> torch.Tensor:
    """COST_TABLE as int32 on ``dev``, copied once per device (read only)."""
    return torch.from_numpy(COST_TABLE).to(dev).contiguous()


def wavefront_tables(enc, xs, ys, lens, lmax: int) -> torch.Tensor:
    """(P, Lmax+1, Lmax+1) int32 suffix tables on enc's device.

    CUDA tensors launch the K1 kernel (or raise; it takes gap open equal to
    extension, as ``core/cost.py`` sets them); CPU tensors run the plain
    version."""
    if enc.device.type != "cuda":
        return wavefront_tables_plain(enc, xs, ys, lens, lmax)
    dev = enc.device
    _check(enc, "enc", dev, 2)
    for name, t in (("xs", xs), ("ys", ys), ("lens", lens)):
        _check(t, name, dev, 1)
    if xs.shape != ys.shape or enc.shape[0] != lens.shape[0] or enc.shape[1] < lmax:
        raise ValueError("wavefront_tables: inconsistent shapes")
    if GAP_OPEN != GAP_EXTENSION:
        raise ValueError(f"K1 kernel: needs gap open == gap extension, got "
                         f"{GAP_OPEN} and {GAP_EXTENSION}")
    threads, rows, shared = k1_launch_shape(lmax)
    L1 = lmax + 1
    cost = _device_cost(dev)
    # the kernel writes each diagonal (d, i)-major here, rows of threads x
    # rows-per-thread words, diagonals 0 .. 2 Lmax, then gathers it
    diag = torch.empty((xs.shape[0], 2 * lmax + 1, threads * rows),
                       dtype=torch.int32, device=dev)
    out = torch.empty((xs.shape[0], L1, L1), dtype=torch.int32, device=dev)
    _kernels.launch(
        "pair_wavefront", enc.data_ptr(), enc.shape[1], xs.data_ptr(),
        ys.data_ptr(), lens.data_ptr(), cost.data_ptr(), diag.data_ptr(),
        out.data_ptr(),
        xs.shape[0], L1, lmax, GAP_OPEN, GAP_EXTENSION, threads, rows, shared,
        torch.cuda.current_stream(dev).cuda_stream)
    return out


def pair_tables(problem: Problem, device) -> torch.Tensor:
    """All C(N,2) suffix tables of a problem, (P, Lmax+1, Lmax+1) int32 on
    ``device`` (same layout and ``_BIG`` as the JAX ``pair_tables_device``)."""
    return wavefront_tables(**pair_inputs(problem, device))
