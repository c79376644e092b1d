"""Work partitioning: coordinate -> owner-shard hash functions.

Port of the JAX package's ``parallel/partition.py``: the reference's four
owner-hash strategies (ref: pastar/CoordHash.cpp:26-166,
pastar/include/Coord.h:29), on int32 coordinate tensors and numpy arrays:

  FZORDER  full Z-order    interleave the bits of all N dims starting at bit
                           shift // N, keep log2(size) + shift % N + 1 bits,
                           then ``(hash >> shift % N) % size``
  PZORDER  partial Z-order the same over the first two dims only
  FSUM     full sum        ``(sum(coords) >> shift) % size``
  PSUM     partial sum     ``((c0 + c1) >> shift) % size``

Every state is owned by exactly one of ``size`` shards, the HDA* ownership
that decides whether a candidate stays on its shard or is routed to
another (ref: pastar/PAStar.cpp:366-394).  The arithmetic is uint32's: torch
has thin uint32 support, so a tensor is computed in int64 and masked to 32
bits (a numpy array in uint32, as the JAX package does).  The kernels
compute the same functions with ``csrc/owner.cuh`` (``owner_params`` gives
their arguments).

Quirk preserved: the reference computes ``bits = log2(size) + shift % N + 1``
with C's double -> int truncation and writes bit positions 0..bits
inclusive (loop condition ``bit_to_write <= total``), i.e. bits + 1
positions, at most 32.
"""
from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

HASH_SHIFT_DEFAULT = 12  # ref: pastar/include/CoordHash.h:9-12
HASH_TYPES = ("FZORDER", "PZORDER", "FSUM", "PSUM")
_M32 = 0xFFFFFFFF

Array = Union[np.ndarray, torch.Tensor]


def _u32(x: Array) -> Array:
    """Coordinates as unsigned 32-bit lanes: uint32 numpy, int64 torch."""
    if isinstance(x, np.ndarray):
        return x.astype(np.uint32)
    return x.long() & _M32


def _out(h: Array) -> Array:
    return h.astype(np.int32) if isinstance(h, np.ndarray) else h.to(torch.int32)


def _shr_mod(s: Array, size: int, shift: int) -> Array:
    if isinstance(s, np.ndarray):
        return _out((s >> np.uint32(shift)) % np.uint32(size))
    return _out(((s & _M32) >> shift) % size)


def sum_hash(coords: Array, size: int, shift: int) -> Array:
    """(sum >> shift) % size (ref: pastar/CoordHash.cpp:27-44)."""
    c = _u32(coords)
    s = c.sum(axis=-1, dtype=np.uint32) if isinstance(c, np.ndarray) else c.sum(-1)
    return _shr_mod(s, size, shift)


def part_sum_hash(coords: Array, size: int, shift: int) -> Array:
    """((c0 + c1) >> shift) % size (ref: pastar/CoordHash.cpp:46-61)."""
    c = _u32(coords)
    return _shr_mod(c[..., 0] + c[..., 1], size, shift)


def z_bits(size: int, shift: int, ndims: int) -> int:
    """Bit positions the Z-order hash writes: the reference's ``bits =
    log2(size) + shift % ndims + 1`` (truncated), written 0..bits
    inclusive, at most 32."""
    return min(int(math.log2(size)) + (shift % ndims) + 2, 32)


def _z_order(coords: Array, size: int, shift: int, ndims: int) -> Array:
    """Shared Z-order machinery of the full and partial variants
    (ref: pastar/CoordHash.cpp:105-166)."""
    c = _u32(coords)
    npy = isinstance(c, np.ndarray)
    read0 = shift // ndims
    h = np.zeros(c.shape[:-1], np.uint32) if npy else c.new_zeros(c.shape[:-1])
    for w in range(z_bits(size, shift, ndims)):
        br = read0 + w // ndims
        if br >= 32:  # a uint32 has no such bit
            continue
        col = c[..., w % ndims]
        if npy:
            h = h | (((col >> np.uint32(br)) & np.uint32(1)) << np.uint32(w))
        else:
            h = h | (((col >> br) & 1) << w)
    if npy:
        return _shr_mod(h, size, shift % ndims)
    return _shr_mod(h & _M32, size, shift % ndims)


def z_order_hash(coords: Array, size: int, shift: int) -> Array:
    return _z_order(coords, size, shift, coords.shape[-1])


def part_z_order_hash(coords: Array, size: int, shift: int) -> Array:
    return _z_order(coords, size, shift, 2)


def owner_fn(hash_type: str, size: int, shift: int = HASH_SHIFT_DEFAULT):
    """A vectorised coords (..., N) -> owner shard id function (the
    analogue of Coord::get_id, ref: pastar/CoordHash.cpp:191-245)."""
    ht = hash_type.upper()
    if ht == "FSUM":
        return lambda c: sum_hash(c, size, shift)
    if ht == "PSUM":
        return lambda c: part_sum_hash(c, size, shift)
    if ht == "FZORDER":
        return lambda c: z_order_hash(c, size, shift)
    if ht == "PZORDER":
        return lambda c: part_z_order_hash(c, size, shift)
    raise ValueError(f"unknown hash type {hash_type!r}; expected one of {HASH_TYPES}")


def owner_params(hash_type: str, size: int, shift: int, n: int) -> tuple:
    """The owner hash's arguments of ``csrc/owner.cuh`` for N = ``n``
    coordinates: (kind, size, shift, Z-order bits), kind the index of
    ``hash_type`` in HASH_TYPES."""
    ht = hash_type.upper()
    if ht not in HASH_TYPES:
        raise ValueError(f"unknown hash type {hash_type!r}; expected one of {HASH_TYPES}")
    if not 1 <= size < 2**31 or not 0 <= shift < 32:
        raise ValueError(f"owner hash: size {size}, shift {shift} out of range")
    ndims = n if ht == "FZORDER" else 2
    return HASH_TYPES.index(ht), int(size), int(shift), z_bits(size, shift, ndims)
