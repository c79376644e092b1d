"""Build, load and count the hand-written CUDA kernels of the port.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point.  It is
compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library under
``_build/`` (listed in ``.gitignore``), named by the source's content hash so
an edited source is never served from a stale library, and loaded with
``ctypes``.  A failed build raises: there is no fallback.

``launches`` counts, per kernel, the launches its wrapper made; a run resets
the counts with ``reset_counts()`` and reads them after, which shows that a
path really went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

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
    # cubes, cxy, cxz, cyz, lens, ws, T, S, tile sides bi, bj, bk, tile
    # diagonals, launch grid (host int32, diagonals x 4), O, E, GG, stream
    "triple_wavefront": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                         _I, _I, _I, _P],
    # t_best, t_closed, C, B, n, f0, goal, thr, run (or null), slots, vmin,
    # active, state, stream
    "select_best": [_P, _P, _I, _I, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P],
    # t_sig, t_best, slots, vmin, active, tables4, cubes, params, N, P, T,
    # S, n, f0, ub, E, GG, O - E, bbits, B, threads, run, counters, state,
    # pending list, stream
    "sig_expand": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L,
                   _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # t_sig, t_best, pending list, lane_cur, lane_dest, lane_word, bbits,
    # max bucket probes, max calls, fill target, run, counters, state,
    # blocks, stream
    "sig_probe": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
}

launches: Dict[str, int] = {name: 0 for name in SIGNATURES}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _lib_path(name: str) -> str:
    """The library's path, named by the hash of its source and of the
    headers of csrc/ (which a source may include)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start_build(name: str):
    """Start nvcc for one kernel; returns (proc, tmp, lib) or None if built."""
    lib = _lib_path(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def build_all(names=None) -> Dict[str, str]:
    """Compile every kernel not yet built, one nvcc per source, all started
    together.  Returns name -> nvcc output (empty when already built)."""
    names = list(names or SIGNATURES)
    started = {n: _start_build(n) for n in names}
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
    """The loaded library of one kernel, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(_lib_path(name))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call a kernel's C entry point and count the launch; raises on a
    non-zero CUDA status (a refused launch never runs, and a later
    synchronize would not report it)."""
    status = getattr(load(name), name)(*args)
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {status}")
    launches[name] += 1
