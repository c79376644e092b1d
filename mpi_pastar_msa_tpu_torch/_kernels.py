"""Build, load and count the hand-written CUDA kernels of the port.

Each kernel is a plain C entry point of one ``csrc/<source>.cu`` file: its
own name, or the file ``SOURCES`` names (a second instantiation of a
kernel, such as K3's unpacked select in ``select_best.cu``).  A source is
compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library
under ``_build/`` (listed in ``.gitignore``), named by the source's content
hash so an edited source is never served from a stale library, and loaded
with ``ctypes``.  A failed build raises: there is no fallback.

``launches`` counts, per kernel, the launches its wrapper made; a run resets
the counts with ``reset_counts()`` and reads them after, which shows that a
path really went through the kernels.  A launch made while a CUDA graph is
captured runs nothing: under ``capturing(tally)`` it counts into ``tally``,
and each replay of the graph adds ``tally`` to ``launches``
(``replayed``), so the counts are the kernels that really ran.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

#: kernel name -> ctypes argtypes of its C entry point (same name as the file)
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SIGNATURES: Dict[str, List] = {
    # enc, enc_stride, xs, ys, lens, cost, diag scratch, out, P, L1, lmax,
    # O, E, threads, rows per thread, shared bytes, stream
    "pair_wavefront": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _I, _P],
    # seq_a, seq_b, n1s, n2s, cost, diagonal-major scratch, out, P, L1,
    # gap, effective gap, threads, rows per thread, shared bytes, stream
    "gotoh_wavefront": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # cubes, cxy, cxz, cyz, lens, ws, T, S, tile sides bi, bj, bk, tile
    # diagonals, launch grid (host int32, diagonals x 4), O, E, GG, stream
    "triple_wavefront": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                         _I, _I, _I, _P],
    # t_best, t_closed, C, B, n, f0, goal, thr, run (or null), slots, vmin,
    # active, compact list, partials, their capacity, ticket, state, stream
    "select_best": [_P, _P, _I, _I, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                    _P, _P, _P],
    # t_state, t_fpar, then select_best's without f0
    "select_best_unpacked": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _P, _P, _P],
    # t_sig, t_best, compact list, tables4, cubes, params, N, P, T, S, n, f0,
    # ub, E, GG, O - E, bbits, B, run, counters, state, pending list, stream
    "sig_expand": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I, _I,
                   _I, _I, _I, _P, _P, _P, _P, _P],
    # t_sig, t_best, pending list, lane_cur, lane_dest, lane_word, bbits,
    # max bucket probes, max calls, fill target, block-path cap, run,
    # counters, state, blocks, received count (or null), stream
    "sig_probe": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I,
                  _P, _P],
    # a chunk's set-up (K6): counters, run flag, stream
    "chunk_setup": [_P, _P, _P],
    # t_key, its row stride, t_g, t_fpar, t_best, C, unpacked, compact
    # list, tables4, cubes, params, N, P, T, S, n, f0, ub, E, GG, O - E, B,
    # blocks, threads, run, counters, state, pending list, stream
    "keyrow_expand": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _L, _L, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # t_key, its row stride, N, C, claim, t_best, t_g, t_fpar, t_state,
    # unpacked, pending list, lane_slot, lane_flag, max probe rounds, fill
    # target, run, counters, state, blocks, tail list, block-path cap, stream
    "keyrow_insert": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                      _P, _P, _P, _I, _P, _I, _P],
    # layout (0 sig, 1 packed, 2 unpacked), t_sig or t_key, its row
    # stride, t_best, t_fpar, N, C, bbits, probes, params (final
    # coordinate, key bit widths), tmax, out, stream
    "path_walk": [_I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P],
    # the sharded step (parallel/sharded.py): K4's sharded instantiation,
    # sig_expand's arguments then h3, cand, the owner hash (kind, size,
    # shift, Z-order bits), ndev, me, the list's coordinates (or null),
    # rows a block (0: the warp-strided form), stream
    "sig_expand_sharded": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I, _I,
                           _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                           _I, _P],
    # K11's passes: cand, carry, its live length, nsel, M, lanes cap, ring
    # rows, ndev, segment, this step's counts, the next step's (zeroed),
    # out, keys, run (or null), stream; then cand, carry, nsel, M, ring
    # rows, ndev, me, cap, S (or null), segment, counts, out, keys, wire,
    # new ring, its live length, run (or null), stream
    "route_count": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _P, _P, _P, _P, _P, _P],
    "route_pack": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P],
    # K12 and the coordinates it gathers: coords, cubes, triangles, N, S,
    # local cubes, rows, out, run (or null), stream; t_sig, compact list,
    # nsel, bit widths, N, bbits, B, coords, run (or null), stream
    "tri_partial": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "sig_coords": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # K7's hop-limited mode: path_walk's arguments, params the start
    # coordinate (and the key bit widths), hops in place of tmax, then the
    # walk loop's run flag (or null) before the stream
    "path_walk_hops": [_I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    # the sharded walk on one card in one launch: layout, the shards'
    # tables (a host int64 table of keys, t_best and t_fpar a shard), ndev,
    # row stride, N, C, bbits, probes, the owner hash (kind, size, shift,
    # Z-order bits), hops a round, params (final coordinate, key bit
    # widths), tmax, out, stream
    "path_walk_shards": [_I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P],
    # the sharded step on key rows: K9's sharded instantiation,
    # keyrow_expand's arguments then h3, cand, a candidate row's words, the
    # owner hash (kind, size, shift, Z-order bits), ndev, me, the
    # self-owned lanes' first claim tag, rows a block (0: a block a row),
    # stream
    "keyrow_expand_sharded": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _L, _L, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _P],
    # K10 over a pending list that received rows precede: keyrow_insert's
    # arguments, then their int32 count on the card, stream
    "keyrow_insert_recv": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                           _P, _P, _P, _I, _P, _I, _P, _P],
    # K11 on rows of any width: route_count's and route_pack's arguments
    # with the row's words, its key words and the empty fsort before the
    # counts
    "route_count_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _P, _P, _P, _P, _P,
                         _P],
    "route_pack_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _L, _I, _I, _I, _P, _P, _P, _P,
                        _P, _P, _P, _P],
    # the coordinates K12 gathers on the packed layout: t_key, its row
    # stride, compact list, nsel, N, B, coords, run (or null), stream
    "keyrow_coords": [_P, _I, _P, _P, _I, _I, _P, _P, _P],
    # the sharded loop on the card (csrc/shard_loop.cu, K6s): the report
    # table, its words a shard, ndev, cap, ragged, unpacked, n, f0, ring
    # rows, run, targets, their count, cons, stream; cons, ndev, cap,
    # ragged, R, a row's words, the address table (wires, then each
    # receiver's pending list, insert flag and index), receivers, stream;
    # the table of the shards' runs, ndev, hops, N, params, masks, their
    # room, walk state, walk flag, stream
    "consensus": [_P, _I, _I, _I, _I, _I, _I, _L, _L, _P, _P, _I, _P, _P],
    "exchange": [_P, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    "walk_advance": [_P, _I, _I, _I, _P, _P, _I, _P, _P, _P],
}
#: host entries that launch no kernel (``call``, not counted): peer access
#: from a card to a peer; a table of device-to-device copies (destination,
#: source, bytes a row), their count, stream; a buffer's CUDA IPC handle
#: (the buffer, 64 bytes out, its int64 offset in the handle's allocation
#: out), a handle's mapping into this process (the handle, the base out),
#: and its unmapping (the base)
HOST_SIGNATURES: Dict[str, List] = {
    "peer_access": [_I, _I],
    "copy_table": [_P, _I, _P],
    "ipc_export": [_P, _P, _P],
    "ipc_open": [_P, _P],
    "ipc_close": [_P],
}
#: kernel name -> its source file's stem, where that is not its own name
SOURCES: Dict[str, str] = {"select_best_unpacked": "select_best",
                           "sig_expand_sharded": "sig_expand", "route_count": "route_pack",
                           "sig_coords": "tri_partial", "path_walk_hops": "path_walk",
                           "path_walk_shards": "path_walk",
                           "keyrow_expand_sharded": "keyrow_expand",
                           "keyrow_insert_recv": "keyrow_insert",
                           "route_count_rows": "route_pack", "route_pack_rows": "route_pack",
                           "keyrow_coords": "tri_partial", "consensus": "shard_loop",
                           "exchange": "shard_loop", "walk_advance": "shard_loop",
                           "peer_access": "shard_loop", "copy_table": "shard_loop",
                           "ipc_export": "shard_loop", "ipc_open": "shard_loop",
                           "ipc_close": "shard_loop"}

launches: Dict[str, int] = {name: 0 for name in SIGNATURES}
_libs: Dict[str, ctypes.CDLL] = {}  # kernel name -> its library, argtypes set
_sources: Dict[str, ctypes.CDLL] = {}  # source -> its loaded library
_tally: Optional[Dict[str, int]] = None  # set while a graph is captured
_peers: set = set()  # (card, peer) pairs whose peer access is enabled


def reset_counts() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def capturing(tally: Dict[str, int]):
    """Count the launches made inside into ``tally``, not ``launches``: under
    a CUDA graph capture they record kernels and run nothing."""
    global _tally
    prev, _tally = _tally, tally
    try:
        yield tally
    finally:
        _tally = prev


def replayed(tally: Dict[str, int], times: int = 1) -> None:
    """Count ``times`` replays of a graph whose capture counted ``tally``."""
    for name, k in tally.items():
        launches[name] += k * times


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _lib_path(src: str) -> str:
    """The library's path of one source, named by the hash of the source
    and of the headers of csrc/ (which a source may include)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{src}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{src}_{digest}.so")


def _start_build(src: str):
    """Start nvcc for one source; returns (proc, tmp, lib) or None if built."""
    lib = _lib_path(src)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, os.path.join(CSRC, f"{src}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def build_all(names=None) -> Dict[str, str]:
    """Compile the sources of every kernel and host entry (or of
    ``names``) not yet built, one nvcc per source, all started together.
    Returns source -> nvcc output (empty when already built)."""
    srcs = dict.fromkeys(SOURCES.get(n, n) for n in (names or SIGNATURES))
    started = {n: _start_build(n) for n in srcs}
    logs = {}
    for n, job in started.items():
        if job is None:
            logs[n] = ""
            continue
        proc, tmp, lib = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu:\n{out}")
        os.replace(tmp, lib)
        logs[n] = out
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built at first use.  A source is
    hashed and loaded once a process: its other kernels reuse the library."""
    lib = _libs.get(name)
    if lib is None:
        src = SOURCES.get(name, name)
        lib = _sources.get(src)
        if lib is None:
            build_all([name])
            lib = _sources[src] = ctypes.CDLL(_lib_path(src))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name] if name in SIGNATURES else HOST_SIGNATURES[name]
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def bind(name: str, *args):
    """A launcher of one kernel with its arguments fixed: the C entry point
    is resolved and the arguments converted to their ctypes once, so a loop
    that launches the same kernel on the same buffers pays that once.  Each
    call of the launcher is a ``launch``."""
    fn = getattr(load(name), name)
    cargs = tuple(t(a) for t, a in zip(SIGNATURES[name], args, strict=True))

    def go() -> None:
        status = fn(*cargs)
        if status != 0:
            raise RuntimeError(f"CUDA kernel {name} failed to launch: error {status}")
        counts = launches if _tally is None else _tally
        counts[name] = counts.get(name, 0) + 1

    return go


def call(name: str, *args) -> None:
    """Call a host entry (``HOST_SIGNATURES``): no kernel, no count; raises
    on a non-zero CUDA status."""
    status = getattr(load(name), name)(*args)
    if status != 0:
        raise RuntimeError(f"CUDA host entry {name} failed: error {status}")


def enable_peer_access(devices) -> None:
    """Peer access between every ordered pair of distinct cards among
    ``devices`` (torch devices or indices), once a process and pair, so
    that a kernel on one reads and writes the others' buffers through
    their device addresses.  A card pair without peer access, or any
    error but "already enabled", raises."""
    import torch

    idx = sorted({torch.device(d).index if not isinstance(d, int) else d for d in devices})
    for a in idx:
        for b in idx:
            if a == b or (a, b) in _peers:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(f"cuda:{a} cannot access cuda:{b} as a peer")
            call("peer_access", a, b)
            _peers.add((a, b))


def launch(name: str, *args) -> None:
    """Call a kernel's C entry point and count the launch; raises on a
    non-zero CUDA status (a refused launch never runs, and a later
    synchronize would not report it)."""
    bind(name, *args)()
