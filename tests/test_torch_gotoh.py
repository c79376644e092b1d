"""The Gotoh fill of the Altschul weights (kernel K8) against the JAX package
on the CPU.

The port's plain ``gotoh_matrices_plain`` against JAX's
``gotoh_matrices_device`` (the XLA scan, on the JAX CPU backend) and the
port's host fill ``_gotoh_pair_matrices``, on random sequences, extreme pairs
and the golden inputs; ``gotoh_distances`` and ``altschul_rationale2`` on a
CPU device against JAX's host and device paths (mirrors
tests/test_heuristic.py:135-170 without the reference files); a NumPy
emulation of K8's schedule (bands of rows a thread, the parity edge
buffers, each cell of a box stored once into the diagonal-major scratch)
and of its tiled transpose (each output cell written once) against the
host fill; the crop of ``gotoh_matrices_device`` (offsets built on the host)
against JAX and the host fill; ``k8_launch_shape`` and
``k8_scratch_shape``.  Every comparison is exact.
"""
import json
import os

import numpy as np
import pytest
import torch

from mpi_pastar_msa_tpu.heuristic import weights as jw
from mpi_pastar_msa_tpu.heuristic.gotoh_wavefront import (
    gotoh_matrices_device as jax_gotoh_matrices_device)
from mpi_pastar_msa_tpu_torch import _kernels
from mpi_pastar_msa_tpu_torch.core.cost import (
    COST_TABLE, DASH, PRIMER_EFFECTIVE_GAP_COST, PRIMER_GAP_COST)
from mpi_pastar_msa_tpu_torch.heuristic import weights as tw
from mpi_pastar_msa_tpu_torch.heuristic.gotoh_wavefront import (
    _BIG, K8_MAX_ROWS, box_offsets, crop_boxes, gotoh_inputs, gotoh_matrices,
    gotoh_matrices_device, gotoh_matrices_plain, k8_launch_shape, k8_scratch_shape)

# one intra-op thread: the test lane runs several workers on a few cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))
AMINO = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
CPU = torch.device("cpu")


def golden_seqs(name):
    return tuple(r.replace("-", "") for r in GOLD[name]["alignment"])


def dash(s):
    return np.frombuffer(("-" + s).encode("latin-1"), dtype=np.uint8).astype(np.int32)


def all_pairs(seqs):
    enc = [dash(s) for s in seqs]
    ij = [(i, j) for i in range(len(seqs) - 1) for j in range(i + 1, len(seqs))]
    return [(enc[i], enc[j]) for i, j in ij], [(len(seqs[i]), len(seqs[j])) for i, j in ij]


def random_seqs(seed, lengths):
    rs = np.random.RandomState(seed)
    return tuple(rs.choice(AMINO, size=L).tobytes().decode() for L in lengths)


CASES = {
    "random4": random_seqs(3, np.random.RandomState(3).randint(4, 24, size=4)),
    "length1": random_seqs(4, (1, 1, 5)),
    "equal": random_seqs(5, (17, 17, 17)),
    "1_vs_40": random_seqs(6, (1, 40)),
    "40_vs_1": random_seqs(7, (40, 1)),
    "PF08184": golden_seqs("PF08184.fasta"),
    "test2": golden_seqs("test2.fasta"),
    "kinase": golden_seqs("kinase.fasta"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_jax_and_host(case):
    pairs, lens = all_pairs(CASES[case])
    args = gotoh_inputs(pairs, lens, CPU)
    full = gotoh_matrices_plain(**args)
    assert full.dtype == torch.int32 and full.shape == (3, len(pairs), args["l1"], args["l1"])
    got = gotoh_matrices_device(pairs, lens, CPU)
    want = jax_gotoh_matrices_device(pairs, lens)
    for (a, b), (n, m), g, w, k in zip(pairs, lens, got, want, range(len(pairs))):
        host = tw._gotoh_pair_matrices(a, b)
        for c in range(3):
            assert g[c].shape == (n + 1, m + 1)
            assert np.array_equal(g[c], w[c]) and np.array_equal(g[c], host[c])
        # every cell outside the box is _BIG (999999, not K1's 2^28)
        box = full[:, k].clone()
        box[:, : n + 1, : m + 1] = _BIG
        assert bool((box == _BIG).all())


@pytest.mark.parametrize("case", ["random4", "1_vs_40", "PF08184", "test2", "kinase"])
def test_distances_and_weights_equal_jax(case):
    seqs = CASES[case]
    got = tw.gotoh_distances(seqs, device=CPU)
    assert np.array_equal(got, tw.gotoh_distances(seqs))
    assert np.array_equal(got, jw.gotoh_distances(seqs, device=False))
    assert np.array_equal(got, jw.gotoh_distances(seqs, device=True))
    if len(seqs) >= 3:
        wf, wi = tw.altschul_rationale2(seqs, CPU)
        jf, ji = jw.altschul_rationale2(seqs)
        assert np.array_equal(wf, jf) and np.array_equal(wi, ji)
        assert np.array_equal((wf, wi), tw.altschul_rationale2(seqs))
    if case in ("PF08184", "test2", "kinase"):
        name = {"PF08184": "PF08184.fasta", "test2": "test2.fasta",
                "kinase": "kinase.fasta"}[case]
        assert np.array_equal(tw.altschul_rationale2(seqs, CPU)[1],
                              np.array(GOLD[name]["weights_int"]))


def test_cpu_wrapper_runs_the_plain_version():
    pairs, lens = all_pairs(CASES["random4"])
    args = gotoh_inputs(pairs, lens, CPU)
    before = dict(_kernels.launches)
    assert torch.equal(gotoh_matrices(**args), gotoh_matrices_plain(**args))
    assert _kernels.launches == before


# a scratch cell no kernel wrote (the wrapper allocates it with torch.empty)
UNSET = -(1 << 40)


def diag_to_rows_emulate(g, n, m, l1, big):
    """NumPy emulation of csrc/diag_to_rows.cuh (K8's gotoh_diag_to_rows_kernel)
    for one pair's planes g, (C, 2 l1 - 1, W) in (d, i)-major order: one
    block a 32 x 32 output tile (i0, j0); lane tx stages row i0 + tx of the
    tile's 63 diagonals i0 + j0 + k (the warps of the block take every k
    once), only the cells of the (n+1) x (m+1) box; then output row i0 + r,
    column j0 + tx takes staged [r + tx][r] inside the box and ``big``
    outside, within the (l1, l1) square.  Asserts that no read touches a
    scratch cell the fill left unwritten, nor a tile entry left unstaged.
    Returns the (C, l1, l1) output and the writes of each output cell."""
    C = g.shape[0]
    out = np.full((C, l1, l1), UNSET, np.int64)
    writes = np.zeros((l1, l1), np.int64)
    tx = np.arange(32)[None, :]
    r = np.arange(32)[:, None]
    k = np.arange(63)[:, None]
    for i0 in range(0, l1, 32):
        for j0 in range(0, l1, 32):
            tile = np.full((C, 63, 32), UNSET, np.int64)
            if i0 <= n and j0 <= m:
                i, d = i0 + tx, i0 + j0 + k                  # (1, 32), (63, 1)
                kk, tt = np.nonzero((i <= n) & (i <= d) & (d - i <= m))
                staged = g[:, kk + i0 + j0, tt + i0]
                assert bool((staged != UNSET).all())
                tile[:, kk, tt] = staged
            i, j = i0 + r, j0 + tx                           # (32, 1), (1, 32)
            rr, cc = np.nonzero((i < l1) & (j < l1))
            inbox = (rr + i0 <= n) & (cc + j0 <= m)
            val = tile[:, rr + cc, rr]
            assert bool((val[:, inbox] != UNSET).all())
            out[:, rr + i0, cc + j0] = np.where(inbox, val, big)
            np.add.at(writes, (rr + i0, cc + j0), 1)
    return out, writes


def k8_emulate(a, b, n, m, l1, T, R):
    """NumPy emulation of csrc/gotoh_wavefront.cu for one pair: the fill
    (one block), thread t owning rows t R .. t R + R - 1 (the lanes of each
    array below), each row's dd, hh, vv on the last diagonal and min(dd, hh,
    vv) on the one before in registers, rows run from the last to the
    first, the previous band's last row through the parity edge buffers
    (read at d from buffer (d - 1) & 1, written to d & 1, one barrier a
    diagonal), each cell of the box stored where the kernel stores it, at
    [c, d, i] of the (3, 2 l1 - 1, W = T R) diagonal-major scratch; then the
    tiled transpose (``diag_to_rows_emulate``).  Returns (dd, hh, vv) over
    the (l1, l1) square, the writes of each output cell and the writes of
    each scratch cell."""
    big = _BIG
    cost = (COST_TABLE & 0xFF).astype(np.int64)  # staged as uint8
    a_s = np.zeros(l1, np.int64)
    b_s = np.zeros(l1, np.int64)
    a_s[: len(a)] = np.asarray(a) & 127
    b_s[: len(b)] = np.asarray(b) & 127
    W = T * R
    scratch = np.full((3, 2 * l1 - 1, W), UNSET, np.int64)
    scratch_writes = np.zeros((2 * l1 - 1, W), np.int64)
    t = np.arange(T)
    base = t * R
    active = base <= n
    rows_i = base[:, None] + np.arange(R)[None, :]           # (T, R)
    arow = np.where(rows_i < l1, a_s[np.minimum(rows_i, l1 - 1)], 0) * 128
    gv = cost.reshape(-1)[arow + DASH]
    dd1, hh1, vv1, m2 = (np.full((T, R), big, np.int64) for _ in range(4))
    up_m2 = np.full(T, big, np.int64)
    edge = np.full((2, T, 2), big, np.int64)
    egap, gap = PRIMER_EFFECTIVE_GAP_COST, PRIMER_GAP_COST
    for d in range(n + m + 1):
        prev = edge[(d - 1) & 1]
        up_dh = np.where(t > 0, np.roll(prev[:, 0], 1), big)
        up_v = np.where(t > 0, np.roll(prev[:, 1], 1), big)
        for r in range(R - 1, -1, -1):
            i = rows_i[:, r]
            j = d - i
            udh = np.minimum(dd1[:, r - 1], hh1[:, r - 1]) if r else up_dh
            uv = vv1[:, r - 1] if r else up_v
            um2 = m2[:, r - 1] if r else up_m2
            jc = np.clip(j, 0, l1 - 1)
            bj = b_s[jc]
            Gi = np.where(i == n, egap, gap)
            Gj = np.where(j == m, egap, gap)
            inbox = active & (i <= n) & (j >= 0) & (j <= m)
            origin, top, left = (i == 0) & (j == 0), (i == 0) & (j > 0), (i > 0) & (j == 0)
            interior = (i > 0) & (j > 0)
            gh = cost[DASH, bj]
            nd = np.where(origin, 0, np.where(
                interior, um2 + cost.reshape(-1)[arow[:, r] + bj], big))
            nh = np.where(origin, egap, np.where(top, hh1[:, r] + gh, np.where(
                interior, np.minimum(np.minimum(dd1[:, r], vv1[:, r]) + Gi, hh1[:, r]) + gh,
                big)))
            nv = np.where(origin, egap, np.where(left, uv + gv[:, r], np.where(
                interior, np.minimum(udh + Gj, uv) + gv[:, r], big)))
            nd, nh, nv = (np.where(inbox, x, big) for x in (nd, nh, nv))
            for c, x in enumerate((nd, nh, nv)):
                scratch[c, d, i[inbox]] = x[inbox]
            np.add.at(scratch_writes, (d, i[inbox]), 1)
            m2[:, r] = np.where(active, np.minimum(np.minimum(dd1[:, r], hh1[:, r]),
                                                   vv1[:, r]), m2[:, r])
            for reg, x in ((dd1, nd), (hh1, nh), (vv1, nv)):
                reg[:, r] = np.where(active, x, reg[:, r])
        up_m2 = np.where(active, np.minimum(up_dh, up_v), up_m2)
        edge[d & 1] = np.where(active[:, None], np.stack(
            [np.minimum(dd1[:, R - 1], hh1[:, R - 1]), vv1[:, R - 1]], axis=1), edge[d & 1])
    out, writes = diag_to_rows_emulate(scratch, n, m, l1, big)
    return out, writes, scratch_writes


def box_scratch_cells(n, m, l1, W):
    """1 at each scratch cell [i + j, i] of the (n+1) x (m+1) box, else 0."""
    want = np.zeros((2 * l1 - 1, W), np.int64)
    i, j = np.meshgrid(np.arange(n + 1), np.arange(m + 1), indexing="ij")
    want[(i + j).ravel(), i.ravel()] = 1
    return want


@pytest.mark.parametrize("case,shape", [
    ("random4", None), ("random4", (32, 3)), ("length1", (32, 1)),
    ("equal", (32, 2)), ("1_vs_40", (32, 5)), ("40_vs_1", (32, 2)),
    ("PF08184", None), ("PF08184", (32, 4)), ("test2", (64, 1)),
    # K8's own shape at l1 = 1025 (two rows a thread) on lopsided pairs
    ("long", None),
    # several transpose tiles at l1 = 66 (not a multiple of 32), one to
    # four rows a thread
    ("tiles", None), ("tiles", (32, 3)), ("tiles", (64, 4)),
])
def test_k8_schedule_emulation_equals_host(case, shape):
    seqs = {"long": lambda: random_seqs(9, (1024, 5, 2)),
            "tiles": lambda: random_seqs(10, (65, 33, 1, 64))}.get(case, lambda: CASES[case])()
    pairs, lens = all_pairs(seqs)
    l1 = max(max(len(a), len(b)) for a, b in pairs)
    T, R = shape or k8_launch_shape(l1)[:2]
    assert T * R >= l1 and T % 32 == 0
    for (a, b), (n, m) in zip(pairs, lens):
        out, writes, scratch_writes = k8_emulate(a, b, n, m, l1, T, R)
        assert bool((writes == 1).all())  # the transpose: every cell of the square once
        # the fill: every scratch cell of the box once, no other
        assert np.array_equal(scratch_writes, box_scratch_cells(n, m, l1, T * R))
        host = tw._gotoh_pair_matrices(a, b)
        for c in range(3):
            assert np.array_equal(out[c, : n + 1, : m + 1], host[c])
            assert bool((out[c, n + 1:] == _BIG).all() and (out[c, :, m + 1:] == _BIG).all())
    if case != "long":
        args = gotoh_inputs(pairs, lens, CPU)
        plain = gotoh_matrices_plain(**args).numpy()
        for k, ((a, b), (n, m)) in enumerate(zip(pairs, lens)):
            assert np.array_equal(k8_emulate(a, b, n, m, l1, T, R)[0], plain[:, k])


@pytest.mark.parametrize("l1,n,m", [
    (1, 0, 0), (32, 31, 31), (33, 32, 0), (33, 0, 32), (33, 32, 32),
    (65, 64, 20), (100, 37, 99), (100, 99, 0),
])
def test_transpose_emulation_tiles(l1, n, m):
    # the transpose alone, on a scratch written only over the box (random
    # values): each output cell once, the box's cell (i, j) from [i + j, i]
    rs = np.random.RandomState(l1 + n + m)
    W = k8_launch_shape(l1)[0] * k8_launch_shape(l1)[1]
    box = box_scratch_cells(n, m, l1, W).astype(bool)
    g = np.full((3, 2 * l1 - 1, W), UNSET, np.int64)
    g[:, box] = rs.randint(0, 1 << 20, size=(3, int(box.sum())))
    out, writes = diag_to_rows_emulate(g, n, m, l1, _BIG)
    assert bool((writes == 1).all())
    i, j = np.meshgrid(np.arange(n + 1), np.arange(m + 1), indexing="ij")
    assert np.array_equal(out[:, : n + 1, : m + 1], g[:, i + j, i])
    assert bool((out[:, n + 1:] == _BIG).all() and (out[:, :, m + 1:] == _BIG).all())


@pytest.mark.parametrize("case", list(CASES))
def test_crop_from_host_offsets_equals_jax_and_host(case):
    # gotoh_matrices_device's crop: offsets built on the host from the
    # lengths, one gather (on the CPU the copy is the gather itself), the
    # boxes packed pair by pair, row by row
    pairs, lens = all_pairs(CASES[case])
    args = gotoh_inputs(pairs, lens, CPU)
    l1 = args["l1"]
    mats = gotoh_matrices_plain(**args)
    flat = crop_boxes(mats, lens)
    assert flat.dtype == np.int32
    assert flat.shape == (3, sum((n + 1) * (m + 1) for n, m in lens))
    want = np.concatenate([mats[:, k, : n + 1, : m + 1].reshape(3, -1).numpy()
                           for k, (n, m) in enumerate(lens)], axis=1)
    assert np.array_equal(flat, want)
    row_len, shift = box_offsets(lens, l1)
    assert len(row_len) == sum(n + 1 for n, _ in lens) and row_len.sum() == flat.shape[1]
    got = gotoh_matrices_device(pairs, lens, CPU)
    jax = jax_gotoh_matrices_device(pairs, lens)
    for (a, b), g, w in zip(pairs, got, jax):
        host = tw._gotoh_pair_matrices(a, b)
        for c in range(3):
            assert g[c].dtype == np.int32
            assert np.array_equal(g[c], w[c]) and np.array_equal(g[c], host[c])


def test_device_fill_rejects_lengths_outside_the_square():
    pairs, lens = all_pairs(CASES["random4"])
    with pytest.raises(ValueError):
        gotoh_matrices_device(pairs, [(n, m + 40) for n, m in lens], CPU)


def test_k8_scratch_shape():
    # kinase: P = 10, l1 = 277, 288 lanes a diagonal; synth4_long: P = 6,
    # l1 = 1108, two rows a thread of 576 threads
    assert k8_scratch_shape(10, 277) == (3, 10, 553, 288)
    assert k8_scratch_shape(6, 1108) == (3, 6, 2215, 1152)
    assert 4 * np.prod(k8_scratch_shape(6, 1108)) == 183_720_960
    for l1 in (1, 33, 1025, 22528):
        T, R, _ = k8_launch_shape(l1)
        assert k8_scratch_shape(2, l1) == (3, 2, 2 * l1 - 1, T * R)
    with pytest.raises(ValueError):
        k8_scratch_shape(1, 22529)


def test_k8_launch_shape():
    # kinase: l1 = 277, one row a thread, 288 threads
    assert k8_launch_shape(277) == (288, 1, 16 * 288 + 128 * 128 + 2 * 277)
    assert k8_launch_shape(1024)[:2] == (1024, 1)
    assert k8_launch_shape(1025)[:2] == (544, 2)   # synth4_long-like
    assert k8_launch_shape(1108)[:2] == (576, 2)   # synth4_long: Lmax 1107
    assert k8_launch_shape(1)[:2] == (32, 1)
    for l1 in (1, 31, 33, 1023, 1025, 3000, 22528):
        T, R, shared = k8_launch_shape(l1)
        assert T * R >= l1 and T % 32 == 0 and T <= 1024 and R <= K8_MAX_ROWS
        assert shared <= 232_448
    with pytest.raises(ValueError):
        k8_launch_shape(22529)
    with pytest.raises(ValueError):
        k8_launch_shape(0)
