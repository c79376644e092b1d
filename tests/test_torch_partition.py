"""The port's owner hashes (mpi_pastar_msa_tpu_torch/parallel/partition.py)
against the JAX package's (mpi_pastar_msa_tpu/parallel/partition.py) and the
scalar transcription of the reference's CoordHash (tests/test_partition.py's
oracle), on int32 torch tensors and numpy arrays: every hash type, size 1 to
8, shift 0 to 12, N from 2 to 10; and owner_params, the kernels' arguments,
against a scalar restatement of csrc/owner.cuh."""
import math

import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu.parallel import partition as J
from mpi_pastar_msa_tpu_torch.parallel import partition as T


def scalar_owner(kind, c, size, shift):
    """The reference's CoordHash (ref: pastar/CoordHash.cpp:26-166) for one
    coordinate, as tests/test_partition.py's oracle writes it."""
    if kind in ("FSUM", "PSUM"):
        s = sum(int(v) for v in (c if kind == "FSUM" else c[:2])) & 0xFFFFFFFF
        return (s >> shift) % size
    ndims = len(c) if kind == "FZORDER" else 2
    h, bit_to_read = 0, shift // ndims
    bits = int(math.log2(size)) + (shift % ndims) + 1
    total = (1 << bits) & 0xFFFFFFFF or 0xFFFFFFFF
    bit_to_write = 1
    while bit_to_write <= total:
        for j in range(ndims):
            if bit_to_write > total:
                break
            if int(c[j]) & (1 << bit_to_read):
                h |= bit_to_write
            bit_to_write <<= 1
        bit_to_read += 1
    return (h >> (shift % ndims)) % size


def cuda_owner(params, c):
    """csrc/owner.cuh's owner::of, restated on Python ints from
    owner_params's (kind, size, shift, zbits)."""
    kind, size, shift, zbits = params
    v = 0
    if kind >= 2:
        v = sum(int(x) for x in (c if kind == 2 else c[:2])) & 0xFFFFFFFF
        v >>= shift
    else:
        nd = len(c) if kind == 0 else 2
        for w in range(zbits):
            br = shift // nd + w // nd
            if br < 32:
                v |= ((int(c[w % nd]) >> br) & 1) << w
        v >>= shift % nd
    return v % size


@pytest.mark.parametrize("kind", T.HASH_TYPES)
@pytest.mark.parametrize("n", range(2, 11))
def test_owner_equals_jax_and_oracle(kind, n):
    rng = np.random.default_rng(100 * n + T.HASH_TYPES.index(kind))
    coords = rng.integers(0, 600, size=(48, n)).astype(np.int32)
    coords[0] = 0
    coords[1] = 65535  # the largest 16-bit coordinate
    tc = torch.from_numpy(coords)
    for size in range(1, 9):
        for shift in range(13):
            want = np.asarray(J.owner_fn(kind, size, shift)(coords))
            got_np = T.owner_fn(kind, size, shift)(coords)
            got_t = T.owner_fn(kind, size, shift)(tc)
            assert got_np.dtype == np.int32 and got_t.dtype == torch.int32
            assert np.array_equal(got_np, want), (size, shift)
            assert np.array_equal(got_t.numpy(), want), (size, shift)
            params = T.owner_params(kind, size, shift, n)
            for c, w in zip(coords[:12], want[:12]):
                assert scalar_owner(kind, c, size, shift) == w
                assert cuda_owner(params, c) == w


def test_owner_fn_and_params_reject_unknown():
    with pytest.raises(ValueError):
        T.owner_fn("XSUM", 4)
    with pytest.raises(ValueError):
        T.owner_params("XSUM", 4, 0, 3)
    with pytest.raises(ValueError):
        T.owner_params("FSUM", 0, 0, 3)
    assert T.HASH_SHIFT_DEFAULT == J.HASH_SHIFT_DEFAULT
    assert T.HASH_TYPES == J.HASH_TYPES
