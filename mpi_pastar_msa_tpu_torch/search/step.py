"""The search step on the card: kernels K3, K4 and K5 (the sig layout), K3,
K9 and K10 (the packed and unpacked layouts), a chunk of steps as one
CUDA graph of one step replayed (K6), and the path walk that follows the
search (K7).

The JAX engine runs its whole search loop as one compiled program
(``_make_run_loop_sig``, mpi_pastar_msa_tpu/search/engine.py:1882, through
``_make_run_loop_packed`` at :1819, and ``_make_run_loop`` at :1999 for
the unpacked layout).  A sig step is ``_select_sig`` (:1620), ``_expand``
(:497) with ``_candidates_sig`` -> ``_sig_encode`` (:1724, :400) and
``_insert_sig`` (:1551); a packed step ``_select_packed`` (:1668),
``_expand`` and ``_insert_packed`` (:1489); an unpacked one ``_select``
(:858), ``_expand`` with pathmax and ``_insert`` (:799).  On a CUDA table
the port runs each step as three hand-written kernels, launched back to
back on the current stream with no host read between them:

  K3 ``csrc/select_best.cu``   grouped argmin, cut and close in one launch,
                               and the compact list of the active rows
                               (``select_best_cuda``: sig and packed;
                               ``select_open_cuda``: unpacked)
  K4 ``csrc/sig_expand.cu``    sig: over that list, decode, expand, prune,
                               sig-encode and the round-0 row match of the
                               insert; unmatched lanes go to a pending list
                               (``_expand_args``)
  K5 ``csrc/sig_probe.cu``     sig: the claimless bucket probe of the
                               pending lanes (one block when they are at
                               most ``K5_CAP``, else the whole cooperative
                               grid), then the step's 14 counters and the
                               run flag (``_probe_args``)
  K9 ``csrc/keyrow_expand.cu`` packed and unpacked: over K3's list, a
                               block a row (``k9_launch_shape``): the
                               row's key words and term tables, expand,
                               prune, the children's key words, hash and
                               content tag; on the packed layout the
                               round-0 match of the insert (a lane whose
                               home row holds its key settles there);
                               the other surviving lanes go to the
                               pending list (``_keyrow_expand_args``)
  K10 ``csrc/keyrow_insert.cu`` packed and unpacked: the claim rounds of
                               the pending lanes, all in one block when
                               the list is at most ``K10_CAP`` long, else
                               round 0 on the cooperative grid and the
                               rest in one block when at most ``K10_CAP``
                               lanes are left (else on the grid), the
                               placement (t_best, or decrease-key on t_g
                               and t_fpar), then the counters and the run
                               flag (``_keyrow_insert_args``)

After the search, ``walk_cuda`` walks the path back on the finished table
of any layout: K7 ``csrc/path_walk.cu``, one launch and one host read a
run (JAX ``_make_backtrace_sig`` :1936, ``_make_backtrace_packed`` :1888,
``_make_backtrace`` :2061; the plain version is ``engine._walk``).

The step loop (``run_chunk_sig_cuda``, ``run_chunk_keyrow_cuda``: K6 of
the JAX loop) keeps the 14 counters in a device int64 vector, as the JAX
``while_loop`` does, and the stop test on the device: the insert ends
each step by writing a run flag (f-min < goal_g and no overflow), and
every kernel of the next step returns at once when it reads 0.  A chunk
is its set-up (``chunk_setup``, csrc/chunk_setup.cu: ``counters[1] = 0``
and the run flag) and ``chunk_steps`` steps, with no host read; the host
reads the counters once a chunk (``FrontierSearch``).  Steps after the
stop do nothing.  By default a step is one replay of a CUDA graph of ONE step, K3 -> K4 -> K5 or K3 ->
K9 -> K10, as the sharded engine replays its step graphs: captured once a
table, bound, fill, insert grid and cap (again after a regrow, or for a
table loaded from a checkpoint: a new table, whose tensors are not those
a graph holds) and replayed ``chunk_steps`` times a chunk after the
set-up, so the host makes one graph launch a step, not three kernel
launches, and a capture records one step.  The expand and the insert are
always launched over a programmatic edge from the kernel before them and
wait for it first thing (``step_state.cuh::wait_predecessor``).  Every
pointer the graph holds is a buffer of the table or of ``StepBuffers``,
the counters included: a chunk copies the caller's counters into
``StepBuffers.counters``, replays, and returns a copy.  ``graph=False``
enqueues the same chunk kernel by kernel (the eager chunk, the reference
the graph is held to).  The plain step
(``engine._run_chunk_plain``) gives the same tables and counters bit for
bit: ``chip_smoke.py`` holds them to each other on the card.

The wrappers (``select_best_cuda``, ``select_open_cuda``,
``run_chunk_sig_cuda``, ``run_chunk_keyrow_cuda``, ``walk_cuda``) check devices, dtypes
and sizes and raise ValueError on anything the kernels do not take;
nothing falls back to the plain code, and a failed launch or capture
raises.  The ``_*_args`` functions give one kernel's C arguments on
checked buffers; a chunk binds them once (``_kernels.bind``) and launches
each kernel ``chunk_steps`` times.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..core.cost import GAP_EXTENSION, GAP_GAP
from .engine import N_COUNTERS, PackedTable, SigTable, UnpackedTable, _Static

# the slots of the step's state vector (csrc/step_state.cuh)
STATE_GMAX, STATE_NOPEN, STATE_NSEL, STATE_REOPEN, STATE_FMIN = 0, 1, 2, 3, 4
STATE_NVALID, STATE_NPEND, STATE_CALLS, STATE_CNT = 5, 6, 7, 8
MAX_CALLS = 128
STATE_WORDS = STATE_CNT + MAX_CALLS
# K3's block partials: room for more blocks than the card holds at once
K3_MAX_BLOCKS = 1024
# K4's C entry takes N <= 24 (2^24 - 1 masks a row)
K4_MAX_N = 24
# K9's and K10's take N <= 16 (8 key words of two 16-bit coordinates)
K9_MAX_N = 16
# K5's block path takes at most kThreads x kLanes = 2048 pending lanes (its
# lanes live in registers), and the engine gives it all it takes: on the
# H100 one block is faster up to about 2,048 lanes and the grid above,
# where one multiprocessor's load/store unit serialises the rows' scattered
# sectors (chip_smoke.py --k5-sweep); the main path's steps are on both
# sides (kinase `auto`: median 5,984, `off`: 1,402)
K5_CAP = 2048
# K10's block 0 takes the whole list, every claim round, when the list is
# at most K10_CAP long, and else, after round 0 on the grid, the rounds of
# a tail at most that long (its lanes live in registers, kThreads x kLanes
# = 1024 of them).  On an H100 (chip_smoke.py --k10-sweep: lists of 64 to
# 4,096 entries on a kinase table of 2^20 slots an eighth full, device
# time) one block beats round 0 on the grid at every length up to 1,024:
# packed 8.2 against 14.5 us at 64 entries, 12.7 against 15.9 at 1,024;
# unpacked 7.7 against 15.5 at 64, 21.4 against 21.6 at 1,024 (20.3
# against 20.9 with 128 received rows).  Above, one multiprocessor issuing
# every lane's scattered loads and atomics loses: at 1,536 packed 26.9
# against 16.5, unpacked 37.0 against 21.7 (a build with 4 lanes a
# thread).  The sharded step's lists are below (kinase on 4 shards, step
# 200: 609 entries), the single table's main-path lists above (globin6
# step 60: 7,754; kinase pinned unpacked, step 150: 8,342)
K10_CAP = 1024
# K9's block: a row's masks over at most this many threads (kMaxThreads
# of csrc/keyrow_expand.cu)
K9_MAX_THREADS = 256
# K9's grid: at most this many blocks a multiprocessor, and 1024 threads
# (the kernel's 64 registers a thread of the H100's 65,536 a
# multiprocessor), so that the grid is resident at once
K9_BLOCKS_AN_SM = 16
# K9s's rows form (the sharded step at M <= 31): rows a block, a warp a
# row (kRowsMaxN of csrc/keyrow_expand.cu: N <= 5).  On an H100
# (chip_smoke.py --k9s-only: kinase on 4 shards, step 200, 508 rows; the
# sweep of 1, 2, 4 and 8) two rows a block are best or within 0.0001 ms
# of it: one returning atomic on kNPend for every two rows, and a block
# barrier that waits for one other warp; at 4 and 8 the barrier waits for
# the block's slowest row
K9S_ROWS = 2
K9S_ROWS_MAX_M = 31
# K4s's rows form (the sharded sig step at M <= K9S_ROWS_MAX_M, the same
# rows of 31 masks as K9s's): rows a block, a warp a row
# (csrc/sig_expand.cu kRowsMaxWarps: at most 8); 0 keeps the warp-strided
# form, which N >= 6 runs whatever this says
K4S_ROWS = 2
# K7's C entry: the layout codes
WALK_LAYOUTS = {"sig": 0, "packed": 1, "unpacked": 2}


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check(t, name: str, dev, dtype, numel: int = 1) -> None:
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: need a tensor, got {type(t).__name__}")
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {dev}, got "
                         f"{t.dtype} on {t.device}")
    if t.numel() < numel:
        raise ValueError(f"{name}: {t.numel()} elements, need {numel}")


def _cuda_device(t, name: str):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: the step kernels need a CUDA tensor")
    return t.device


def _scalar(x, name: str, dev) -> torch.Tensor:
    """An int64 device scalar (a 0-d view of the counters stays a view)."""
    t = torch.as_tensor(x, dtype=torch.int64, device=dev)
    if t.numel() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: need one int64 value on {dev}")
    return t


def select_best_cuda(st: _Static, t_best, t_closed, goal_g, thr, run=None,
                     bufs: "StepBuffers" = None, launch=None):
    """K3 (``csrc/select_best.cu``): ``engine._select_best_plain`` on the
    card, the same outputs: (slots, vmin, active, fmin, n_open, n_selected,
    reopen_ct) with t_closed updated in place.  The four counts are 0-d
    views of the step's state vector.  ``run`` is the step loop's flag (the
    kernels return at once when it reads 0); ``bufs`` the loop's buffers
    (default: new outputs); ``launch`` takes the checked C arguments in
    place of ``_kernels.launch`` (a caller that binds them once)."""
    dev = _cuda_device(t_best, "t_best")
    _check(t_best, "t_best", dev, torch.int32, st.C)
    _check(t_closed, "t_closed", dev, torch.int32, st.C)
    return _launch_select(st, dev, _select_args, t_best, t_closed, goal_g, thr, run, bufs,
                          launch)


def select_open_cuda(st: _Static, t_state, t_fpar, goal_g, thr, run=None,
                     bufs: "StepBuffers" = None, launch=None):
    """K3's unpacked instantiation (``select_best_unpacked``):
    ``engine._select_open_plain`` on the card, the same outputs, t_state
    updated in place; the rest as ``select_best_cuda``."""
    dev = _cuda_device(t_state, "t_state")
    _check(t_state, "t_state", dev, torch.int32, st.C)
    _check(t_fpar, "t_fpar", dev, torch.int64, st.C)
    return _launch_select(st, dev, _select_open_args, t_state, t_fpar, goal_g, thr, run, bufs,
                          launch)


def _launch_select(st, dev, args, a, b, goal_g, thr, run, bufs, launch=None):
    """One select launch on checked tables ``a``, ``b`` (``args`` gives
    the C arguments); the outputs as ``select_best_cuda``."""
    goal = _scalar(goal_g, "goal_g", dev)
    thr = _scalar(thr, "thr", dev)
    if run is not None:
        _check(run, "run", dev, torch.int32)
    if bufs is None:
        bufs = StepBuffers.select_only(st, dev)
    (launch or _kernels.launch)(*args(st, a, b, goal, thr, run, bufs, _stream(dev)))
    s = bufs.state
    return (bufs.slots, bufs.vmin, bufs.active, s[STATE_FMIN], s[STATE_NOPEN],
            s[STATE_NSEL], s[STATE_REOPEN])


def _select_args(st, t_best, t_closed, goal, thr, run, bufs, stream) -> tuple:
    return ("select_best", t_best.data_ptr(), t_closed.data_ptr(), st.C, st.B, st.nb,
            st.f0, goal.data_ptr(), thr.data_ptr(), None if run is None else run.data_ptr(),
            bufs.slots.data_ptr(), bufs.vmin.data_ptr(), bufs.active.data_ptr(),
            bufs.sel.data_ptr(), bufs.partial.data_ptr(), bufs.partial.shape[0],
            bufs.ticket.data_ptr(), bufs.state.data_ptr(), stream)


def _select_open_args(st, t_state, t_fpar, goal, thr, run, bufs, stream) -> tuple:
    return ("select_best_unpacked", t_state.data_ptr(), t_fpar.data_ptr(), st.C, st.B, st.nb,
            goal.data_ptr(), thr.data_ptr(), None if run is None else run.data_ptr(),
            bufs.slots.data_ptr(), bufs.vmin.data_ptr(), bufs.active.data_ptr(),
            bufs.sel.data_ptr(), bufs.partial.data_ptr(), bufs.partial.shape[0],
            bufs.ticket.data_ptr(), bufs.state.data_ptr(), stream)


@dataclass
class StepBuffers:
    """Device buffers of the step of one layout, made once a table size.

    slots, vmin (B,) int64, active (B,) bool: K3's outputs
    state (STATE_WORDS,) int64: the step's counts (csrc/step_state.cuh)
    sel (B, 2) int32: K3's compact list of active rows (slot, packed word;
        unpacked: slot, f), its length in state[STATE_NSEL]; K4 or K9
        walks it
    partial (K3_MAX_BLOCKS, 2) int64, ticket (1,) int32: K3's block
        partials and the ticket of its last block (0 between launches)
    run (1,) int32: the step loop's run flag
    pend int32: the pending lanes, K4's (B * M, 3): (home, sig base,
        packed), or K9's (B * M, W + 4): (key words, hash, tag, h, packed)
        on the packed layout, (B * M, W + 5): (key words, hash, tag, g, f *
        2^n + mask as two words) on the unpacked one
    lane_cur, lane_dest, lane_word (B * M,) int32: K5's lane state; on a
        key-row layout lane_cur and lane_dest are K10's lane_slot and
        lane_flag (lane_word None)
    tail (K10_CAP,) int32: K10's tail list, the lanes round 0 left
        unsettled (key-row layouts; None on sig)
    params int32: pairs, weights, triangles, final coordinate and key bit
    widths for K4 and K9 (``_kernel_params``)
    layout: "sig", "packed" or "unpacked", the layout these serve
    counters (N_COUNTERS,) int64: the chunk's counters, the same buffer
        every chunk (the graph holds its pointer)
    graph: the step's ``ChunkGraph`` (None before the first capture);
    captures, capture_s: graphs captured on these buffers, and the host
        seconds they took; capture_parts: those seconds by part (warm_s:
        the kernels' warm-up launches, host_s: the step's launches while
        captured, instantiate_s: the rest, the capture's ends and the
        instantiation)"""
    slots: torch.Tensor
    vmin: torch.Tensor
    active: torch.Tensor
    state: torch.Tensor
    sel: torch.Tensor
    partial: torch.Tensor
    ticket: torch.Tensor
    run: torch.Tensor = None
    pend: torch.Tensor = None
    lane_cur: torch.Tensor = None
    lane_dest: torch.Tensor = None
    lane_word: torch.Tensor = None
    tail: torch.Tensor = None
    params: torch.Tensor = None
    counters: torch.Tensor = None
    layout: str = "sig"
    graph: Optional["ChunkGraph"] = None
    captures: int = 0
    capture_s: float = 0.0
    capture_parts: Dict[str, float] = field(default_factory=lambda: dict.fromkeys(
        ("warm_s", "host_s", "instantiate_s"), 0.0))

    @classmethod
    def select_only(cls, st: _Static, dev) -> "StepBuffers":
        """New outputs; the scratch (sel, partial, ticket) is made once a
        table (``st``) and shared by every select on it."""
        B = st.B
        scratch = getattr(st, "_select_scratch", None)
        if scratch is None or scratch[2].device != dev:
            scratch = (torch.empty((B, 2), dtype=torch.int32, device=dev),
                       torch.empty((K3_MAX_BLOCKS, 2), dtype=torch.int64, device=dev),
                       torch.zeros(1, dtype=torch.int32, device=dev))
            st._select_scratch = scratch
        return cls(torch.empty(B, dtype=torch.int64, device=dev),
                   torch.empty(B, dtype=torch.int64, device=dev),
                   torch.empty(B, dtype=torch.bool, device=dev),
                   torch.empty(STATE_WORDS, dtype=torch.int64, device=dev), *scratch)

    @classmethod
    def for_step(cls, st: _Static, dev, layout: str = "sig") -> "StepBuffers":
        bufs = cls.select_only(st, dev)
        cap = st.B * st.M
        bufs.layout = layout
        bufs.run = torch.zeros(1, dtype=torch.int32, device=dev)
        words = {"sig": 3, "packed": st.W + 4, "unpacked": st.W + 5}[layout]
        bufs.pend = torch.empty((cap, words), dtype=torch.int32, device=dev)
        bufs.lane_cur, bufs.lane_dest = (
            torch.empty(cap, dtype=torch.int32, device=dev) for _ in range(2))
        if layout == "sig":
            bufs.lane_word = torch.empty(cap, dtype=torch.int32, device=dev)
        else:
            bufs.tail = torch.empty(K10_CAP, dtype=torch.int32, device=dev)
        bufs.params = _kernel_params(st, dev)
        bufs.counters = torch.zeros(N_COUNTERS, dtype=torch.int64, device=dev)
        return bufs


def _kernel_params(st: _Static, dev) -> torch.Tensor:
    """K4's and K9's constants as one int32 vector: xs, ys, w, w_h (P
    each), the triangles (3T), the final coordinate and the key bit widths
    (N each; K9 reads no bit width); then, at M <= K9S_ROWS_MAX_M, two
    words a mask for K9s's rows form (``k9s_mask_codes``)."""
    parts = [st.d_xs, st.d_ys, st.d_w, st.d_w_h]
    if st.T3:
        parts.append(st.d_tri_xyz.reshape(-1))
    parts += [st.d_final, torch.tensor(st.bitw, device=st.device)]
    if st.M <= K9S_ROWS_MAX_M:
        parts.append(k9s_mask_codes(st))
    v = torch.cat([p.to(st.device, torch.int64) for p in parts])
    if int(v.abs().max()) >= 2**31:
        raise ValueError("K4/K9: a pair weight does not fit 32 bits")
    return v.to(dev, torch.int32)


def k9s_mask_codes(st: _Static) -> torch.Tensor:
    """For each mask m = 1 .. M, K9s's rows form's two code words: bits 2p,
    2p + 1 pair p's move bits (2 bx + by: its entry in the row's term
    tables), bits 3t .. 3t + 2 cube t's corner (4 bx + 2 by + bz), as
    (pair, mask) and (cube, mask) lookups that are the same for every row;
    int64, 2M values (mask-major)."""
    m = torch.arange(1, st.M + 1, dtype=torch.int64)
    bit = lambda d: (m >> torch.as_tensor(d, dtype=torch.int64).reshape(-1, 1)) & 1
    xs, ys = st.d_xs.cpu().long(), st.d_ys.cpu().long()
    pair = (2 * bit(xs) + bit(ys)) << (2 * torch.arange(st.P).reshape(-1, 1))
    codes = torch.stack([pair.sum(0), torch.zeros_like(m)], 1)
    if st.T3:
        tri = st.d_tri_xyz.cpu().long().reshape(-1, 3)
        corner = 4 * bit(tri[:, 0]) + 2 * bit(tri[:, 1]) + bit(tri[:, 2])
        codes[:, 1] = (corner << (3 * torch.arange(st.T3).reshape(-1, 1))).sum(0)
    return codes.reshape(-1)


def _step_buffers(st: _Static, dev, layout: str = "sig") -> StepBuffers:
    """The statics' step buffers for ``layout`` (made anew, the old ones
    released, when the device or the layout changes)."""
    bufs = getattr(st, "_step_buffers", None)
    if bufs is None or bufs.slots.device != dev or bufs.layout != layout:
        st._step_buffers = None
        bufs = StepBuffers.for_step(st, dev, layout)
        st._step_buffers = bufs
    return bufs


def _check_common(st: _Static, dev, counters, cubes: bool = True) -> None:
    """The counters and the heuristic's tables of a step on ``dev`` (the
    cubes unless ``cubes`` is False: a shard of the sharded step that holds
    only its own)."""
    _check(counters, "counters", dev, torch.int64)
    if counters.numel() != N_COUNTERS:
        raise ValueError(f"counters: {counters.numel()} elements, need {N_COUNTERS}")
    _check(st.d_tables4, "tables4", dev, torch.int32, st.P * st.S * st.S * 8)
    if st.T3 and cubes:
        _check(st.d_cubes, "cubes", dev, torch.int32, st.T3 * st.S ** 3)


def _check_step(st: _Static, tab, counters, cubes: bool = True):
    """The device of a sig step, after checking the table, the statics and
    the counters (the cubes as ``_check_common``)."""
    if not isinstance(tab, SigTable):
        raise ValueError(f"the sig step kernels need a SigTable, got {type(tab).__name__}")
    dev = _cuda_device(tab.t_sig, "t_sig")
    for name in ("t_sig", "t_best", "t_closed"):
        _check(getattr(tab, name), name, dev, torch.int32, st.C)
    _check_common(st, dev, counters, cubes)
    if not st.sig_ok:
        raise ValueError("the sig step kernels need a sig-eligible table (sig_ok)")
    if st.n > K4_MAX_N:
        raise ValueError(f"K4 takes at most {K4_MAX_N} sequences, got {st.n}")
    return dev


def _expand_args(st, tab, bufs, counters, ub, stream, *, entry: str = "sig_expand",
                 cubes: bool = True, pend_at: int = 0, sharded: tuple = ()) -> tuple:
    """K4's launch: ``entry`` the unsharded or the sharded instantiation,
    ``cubes`` False where h3 stands in for the cube reads, the pending
    lanes appended from row ``pend_at`` of ``bufs.pend``, and ``sharded``
    the sharded instantiation's arguments before the stream."""
    return (entry, tab.t_sig.data_ptr(), tab.t_best.data_ptr(), bufs.sel.data_ptr(),
            st.d_tables4.data_ptr(), st.d_cubes.data_ptr() if cubes and st.T3 else None,
            bufs.params.data_ptr(), st.n, st.P, st.T3, st.S, st.nb, st.f0, int(ub),
            GAP_EXTENSION, GAP_GAP, st.gap_oe, st.bbits, st.B, bufs.run.data_ptr(),
            counters.data_ptr(), bufs.state.data_ptr(),
            bufs.pend.data_ptr() + 4 * 3 * pend_at, *sharded, stream)


def _probe_args(st, tab, bufs, counters, fill, blocks, cap, stream, pend_at: int = 0,
                recv=None, run=None) -> tuple:
    """K5's launch over the pending lanes from row ``pend_at`` of
    ``bufs.pend``; with ``recv`` (the sharded step) the int32 count of
    rows received just before that row, read on the card, and ``run`` the
    insert's own flag (default ``bufs.run``)."""
    run = bufs.run if run is None else run
    return ("sig_probe", tab.t_sig.data_ptr(), tab.t_best.data_ptr(),
            bufs.pend.data_ptr() + 4 * 3 * pend_at, bufs.lane_cur.data_ptr(),
            bufs.lane_dest.data_ptr(), bufs.lane_word.data_ptr(), st.bbits, st.max_bprobes,
            st.max_probes, int(fill), int(cap), run.data_ptr(), counters.data_ptr(),
            bufs.state.data_ptr(), int(blocks), None if recv is None else recv.data_ptr(),
            stream)


def _check_keyrow(st: _Static, tab, counters, cubes: bool = True):
    """The device and layout of a packed or unpacked step, after checking
    the table, the statics and the counters (the cubes as
    ``_check_common``)."""
    if isinstance(tab, PackedTable):
        layout, cols = "packed", st.KW
        tensors = (("t_best", torch.int32), ("t_closed", torch.int32), ("claim", torch.int32))
    elif isinstance(tab, UnpackedTable):
        layout, cols = "unpacked", st.W
        tensors = (("t_g", torch.int32), ("t_fpar", torch.int64), ("t_state", torch.int32),
                   ("claim", torch.int32))
    else:
        raise ValueError("the key-row step kernels need a PackedTable or an UnpackedTable, "
                         f"got {type(tab).__name__}")
    if st.n > K9_MAX_N:
        raise ValueError(f"K9 and K10 take at most {K9_MAX_N} sequences, got {st.n}")
    if st.B * st.M >= 2**31 or st.C & (st.C - 1):
        raise ValueError(f"key-row step: B x M = {st.B * st.M} must be below 2^31 (the claim "
                         f"tags) and C = {st.C} a power of two")
    dev = _cuda_device(tab.t_key, "t_key")
    _check(tab.t_key, "t_key", dev, torch.int32, st.C * cols)
    if tab.t_key.dim() != 2 or tab.t_key.shape[1] != cols:
        raise ValueError(f"t_key: shape {tuple(tab.t_key.shape)}, need (>= {st.C}, {cols})")
    for name, dtype in tensors:
        _check(getattr(tab, name), name, dev, dtype, st.C)
    _check_common(st, dev, counters, cubes)
    return dev, layout


def k9_launch_shape(B: int, M: int, sms: int = 132) -> Tuple[int, int, int]:
    """(blocks, threads a block, passes a row) of K9 (csrc/keyrow_expand.cu)
    for a batch of ``B`` rows of ``M`` masks on a card of ``sms``
    multiprocessors.  A block takes a row: its threads are the row's masks
    rounded up to a warp, at most ``K9_MAX_THREADS`` (one warp at M <= 31:
    a warp a row), so a row takes ceil(M / threads) passes (synth10: 1023
    masks, 256 threads, 4 passes).  The grid is a block a row, up to
    ``K9_BLOCKS_AN_SM`` blocks and 1024 threads a multiprocessor (what it
    holds at once at the kernel's 64 registers a thread); its blocks
    stride over K3's list, whose length (at most B) only the card knows,
    so the listed rows spread over every multiprocessor."""
    threads = min(K9_MAX_THREADS, -(-M // 32) * 32)
    per_sm = min(K9_BLOCKS_AN_SM, 1024 // threads)
    return min(B, sms * per_sm), threads, -(-M // threads)


def k9s_launch_shape(B: int, M: int, sms: int = 132,
                     rows: int = K9S_ROWS) -> Tuple[int, int, int]:
    """(blocks, threads a block, rows a block) of K9s, the sharded
    instantiation of K9: at M <= ``K9S_ROWS_MAX_M`` its rows form, a warp a
    row and ``rows`` rows a block, a block for each ``rows`` of the ``B``
    rows the list may hold (no stride: a block's warps meet at its one
    place atomic); else, or with ``rows`` 0, the block form of
    ``k9_launch_shape`` (a block a row), rows 0."""
    if rows > 0 and M <= K9S_ROWS_MAX_M:
        return -(-B // rows), 32 * rows, rows
    blocks, threads, _ = k9_launch_shape(B, M, sms)
    return blocks, threads, 0


def _sms(dev) -> int:
    """The multiprocessors of ``dev``: the card's, or the H100's 132 for a
    CPU device (the stub tests' tables)."""
    if dev.type != "cuda":
        return 132
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _keyrow_expand_args(st, tab, bufs, counters, ub, stream, *, entry: str = "keyrow_expand",
                        cubes: bool = True, pend_at: int = 0, sharded: tuple = (),
                        rows: Optional[int] = None) -> tuple:
    """K9's launch: ``entry`` the unsharded or the sharded instantiation,
    ``cubes`` False where h3 stands in for the cube reads, the pending
    entries appended from row ``pend_at`` of ``bufs.pend``, and
    ``sharded`` the sharded instantiation's arguments before its rows a
    block (``k9s_launch_shape`` with ``rows``, by default K9S_ROWS) and the
    stream."""
    unpacked = isinstance(tab, UnpackedTable)
    if sharded:
        blocks, threads, rows = k9s_launch_shape(st.B, st.M, _sms(tab.t_key.device),
                                                 K9S_ROWS if rows is None else rows)
        sharded = (*sharded, rows)
    else:
        blocks, threads, _ = k9_launch_shape(st.B, st.M, _sms(tab.t_key.device))
    return (entry, tab.t_key.data_ptr(), tab.t_key.shape[1],
            tab.t_g.data_ptr() if unpacked else None, tab.t_fpar.data_ptr() if unpacked else None,
            None if unpacked else tab.t_best.data_ptr(), st.C, int(unpacked),
            bufs.sel.data_ptr(), st.d_tables4.data_ptr(),
            st.d_cubes.data_ptr() if cubes and st.T3 else None, bufs.params.data_ptr(), st.n,
            st.P, st.T3, st.S, st.nb, st.f0, int(ub), GAP_EXTENSION, GAP_GAP, st.gap_oe, st.B,
            blocks, threads, bufs.run.data_ptr(), counters.data_ptr(), bufs.state.data_ptr(),
            bufs.pend.data_ptr() + 4 * bufs.pend.shape[1] * pend_at, *sharded, stream)


def _keyrow_insert_args(st, tab, bufs, counters, fill, blocks, cap, stream,
                        pend_at: Optional[int] = None, recv=None, run=None) -> tuple:
    """K10's launch; with ``pend_at`` the sharded entry
    ``keyrow_insert_recv`` over the pending entries from row ``pend_at`` of
    ``bufs.pend``, preceded by the received rows, whose int32 count
    ``recv`` holds on the card, and ``run`` the insert's own flag (default
    ``bufs.run``)."""
    unpacked = isinstance(tab, UnpackedTable)
    ptr = lambda name: getattr(tab, name).data_ptr() if hasattr(tab, name) else None
    pend = bufs.pend.data_ptr() + 4 * bufs.pend.shape[1] * (pend_at or 0)
    run = bufs.run if run is None else run
    args = (tab.t_key.data_ptr(), tab.t_key.shape[1], st.n, st.C, tab.claim.data_ptr(),
            ptr("t_best"), ptr("t_g"), ptr("t_fpar"), ptr("t_state"), int(unpacked), pend,
            bufs.lane_cur.data_ptr(), bufs.lane_dest.data_ptr(), st.max_probes, int(fill),
            run.data_ptr(), counters.data_ptr(), bufs.state.data_ptr(), int(blocks),
            bufs.tail.data_ptr(), int(cap))
    if pend_at is None:
        return ("keyrow_insert", *args, stream)
    return ("keyrow_insert_recv", *args, recv.data_ptr(), stream)


def k10_path(n: int, rounds: int, tail: int, cap: int) -> str:
    """Which of csrc/keyrow_insert.cu's schedules one K10 launch takes, from
    its list length ``n`` (state[kNPend]), claim rounds, the lanes round 0
    left (``tail``, state[kCnt]) and its cap: "block" (the whole list in
    block 0, every round), "tail" (round 0 on the grid, the rounds after it
    in block 0), "grid" (every round on the grid), or "none" (no lane)."""
    if rounds == 0:
        return "none"
    if 0 < cap and n <= cap:
        return "block"
    return "tail" if rounds >= 2 and tail <= cap else "grid"


def k10_grid_syncs(rounds: int, n: int, tail: int, cap: int, unpacked: bool) -> int:
    """The grid barriers of one K10 launch, as csrc/keyrow_insert.cu
    places them, on its path (``k10_path``: the same arguments): none on
    the whole-list block path; else one after round 0's reads, two a round
    on the grid (after the winners' writes, after the re-reads), none for
    the rounds of the tail's block path, then on the unpacked layout one
    inside the decrease-key and, after the tail's block path, one before
    it.  No lane: none."""
    path = k10_path(n, rounds, tail, cap)
    if path in ("none", "block"):
        return 0
    syncs = 1 + 2 * (1 if path == "tail" else rounds)
    return syncs + (2 if path == "tail" else 1) if unpacked else syncs


def _step_args(st, tab, bufs, ctr, ub, fill, blocks, cap, stream) -> list:
    """The C arguments of one step's three kernels on ``tab``'s layout:
    K3, K4, K5 (sig) or K3, K9, K10 (packed, unpacked); ``ctr`` the
    counters buffer (K3's goal and threshold are views of it); ``cap`` is
    K5's or K10's block-path cap."""
    if isinstance(tab, SigTable):
        return [_select_args(st, tab.t_best, tab.t_closed, ctr[0], ctr[7], bufs.run, bufs,
                             stream),
                _expand_args(st, tab, bufs, ctr, ub, stream),
                _probe_args(st, tab, bufs, ctr, fill, blocks, cap, stream)]
    if isinstance(tab, PackedTable):
        select = _select_args(st, tab.t_best, tab.t_closed, ctr[0], ctr[7], bufs.run, bufs,
                              stream)
    else:
        select = _select_open_args(st, tab.t_state, tab.t_fpar, ctr[0], ctr[7], bufs.run, bufs,
                                   stream)
    return [select, _keyrow_expand_args(st, tab, bufs, ctr, ub, stream),
            _keyrow_insert_args(st, tab, bufs, ctr, fill, blocks, cap, stream)]


@dataclass
class ChunkGraph:
    """A captured step: what it was captured for (``key``: the table's
    pointers, bound, fill, the insert's grid and K5's cap), the graph, and
    the launches of each kernel that one replay runs."""
    key: tuple
    graph: object
    tally: Dict[str, int] = field(default_factory=dict)


def run_chunk_sig_cuda(st: _Static, tab: SigTable, counters: torch.Tensor,
                       chunk_steps: int, ub: int, fill: int, blocks: int = 0,
                       cap: int = K5_CAP, graph: bool = True) -> torch.Tensor:
    """Up to ``chunk_steps`` steps of a CUDA sig table (``engine._run_chunk``
    on the card), each K3 -> K4 -> K5 with no host read: the plain loop's
    stop test runs on the device.  Like the plain loop, a chunk starts from
    f-min 0, so its first step runs unless goal_g <= 0 or the table
    overflowed.  ``blocks`` sizes K5's grid (0: one block a
    multiprocessor), ``cap`` is the largest pending count K5's block path
    takes (0 .. K5_CAP; 0: the grid path every step); ``graph`` replays a
    CUDA graph of one step ``chunk_steps`` times (captured at the first
    chunk of this table and these arguments), else enqueues the chunk
    kernel by kernel.  Returns new counters; the table is updated in
    place."""
    dev = _check_step(st, tab, counters)
    if not 0 <= cap <= K5_CAP:
        raise ValueError(f"K5 cap {cap}: need 0 .. {K5_CAP}")
    return _drive_chunk(st, tab, _step_buffers(st, dev), counters, chunk_steps, ub, fill,
                      blocks, cap, graph)


def run_chunk_keyrow_cuda(st: _Static, tab, counters: torch.Tensor, chunk_steps: int,
                          ub: int, fill: int, blocks: int = 0, cap: int = K10_CAP,
                          graph: bool = True) -> torch.Tensor:
    """Up to ``chunk_steps`` steps of a CUDA packed or unpacked table
    (``engine._run_chunk`` on the card), each K3 -> K9 -> K10 with no host
    read, as ``run_chunk_sig_cuda``; ``blocks`` sizes K10's cooperative
    grid (0: one block a multiprocessor), ``cap`` is the longest list that
    K10's block 0 takes whole, and the most lanes left after round 0 on
    the grid that it takes then (0 .. K10_CAP; 0: every round on the
    grid).  Returns new counters; the table is updated in place."""
    dev, layout = _check_keyrow(st, tab, counters)
    if not 0 <= cap <= K10_CAP:
        raise ValueError(f"K10 cap {cap}: need 0 .. {K10_CAP}")
    return _drive_chunk(st, tab, _step_buffers(st, dev, layout), counters, chunk_steps, ub,
                        fill, blocks, cap, graph)


def _drive_chunk(st, tab, bufs, counters, chunk_steps, ub, fill, blocks, cap, graph):
    """A chunk on checked arguments (``run_chunk_sig_cuda``,
    ``run_chunk_keyrow_cuda``): the caller's counters in and out of
    ``bufs.counters``, the chunk's set-up, then the step graph replayed
    ``chunk_steps`` times, or the chunk enqueued."""
    bufs.counters.copy_(counters)
    if graph:
        g = _step_graph(st, tab, bufs, ub, fill, blocks, cap)
        _setup(bufs, _stream(bufs.counters.device))
        for _ in range(chunk_steps):
            g.graph.replay()
        _kernels.replayed(g.tally, chunk_steps)
    else:
        _chunk(st, tab, bufs, chunk_steps, ub, fill, blocks, cap, _stream(bufs.counters.device))
    return bufs.counters.clone()


def chunk_setup_plain(counters: torch.Tensor, run: torch.Tensor) -> None:
    """The plain version of ``chunk_setup`` (csrc/chunk_setup.cu), in
    place: f-min 0 and the run flag = goal_g > 0 and no overflow, so that
    a chunk's first step runs as the plain loop's does."""
    counters[1].fill_(0)
    run.copy_(((counters[0] > 0) & (counters[6] == 0)).view(1))


def _setup(bufs, stream) -> None:
    """A chunk's set-up on ``bufs``: ``chunk_setup`` on the card, one
    launch on ``stream``; its plain version on CPU buffers."""
    if bufs.counters.device.type == "cuda":
        _kernels.launch("chunk_setup", bufs.counters.data_ptr(), bufs.run.data_ptr(), stream)
    else:
        chunk_setup_plain(bufs.counters, bufs.run)


def _chunk(st, tab, bufs, chunk_steps, ub, fill, blocks, cap, stream) -> None:
    """One chunk on ``bufs.counters``: its set-up, then ``chunk_steps`` x
    (select, expand, insert), every kernel's arguments bound once."""
    _setup(bufs, stream)
    kernels = [_kernels.bind(*args) for args in _step_args(st, tab, bufs, bufs.counters, ub,
                                                           fill, blocks, cap, stream)]
    for _ in range(chunk_steps):
        for k in kernels:
            k()


def _capture(fn, mode: str = "global"):
    """A CUDA graph of what ``fn`` enqueues on the current stream, which
    is a side stream during the capture (a graph is not captured on the
    default stream), so ``fn`` reads the stream inside; ``mode`` the
    capture's error mode (``CUDAGraph.capture_begin``).  A failed capture
    or instantiation raises.  (``torch.cuda.graph`` would also collect
    garbage and empty the allocator's cache first, up to 0.2 s a capture
    on the card; the capture needs neither.)"""
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        g.capture_begin(capture_error_mode=mode)
        try:
            fn()
        finally:
            g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return g


def _step_graph(st, tab, bufs, ub, fill, blocks, cap) -> ChunkGraph:
    """The step's graph for this table and these arguments: the one
    captured last on ``bufs`` if it was captured for them, else a new one
    of one step.  Before a capture every kernel is launched once with the
    run flag at 0 (it returns at once): each C entry's first call queries
    the card and loads its kernel, which a capture must not do."""
    key = tuple(getattr(tab, f.name).data_ptr() for f in fields(tab)) + (
        int(ub), int(fill), int(blocks), int(cap))
    if bufs.graph is not None and bufs.graph.key == key:
        return bufs.graph
    bufs.graph = None  # release the old graph first
    t0 = time.perf_counter()
    dev = bufs.counters.device
    bufs.run.zero_()
    stream = _stream(dev)
    for args in _step_args(st, tab, bufs, bufs.counters, ub, fill, blocks, cap, stream):
        _kernels.launch(*args)
    t1 = time.perf_counter()
    host = [0.0]

    def step():
        t = time.perf_counter()
        for args in _step_args(st, tab, bufs, bufs.counters, ub, fill, blocks, cap,
                               _stream(dev)):
            _kernels.launch(*args)
        host[0] += time.perf_counter() - t

    tally: Dict[str, int] = {}
    with _kernels.capturing(tally):
        graph = _capture(step)
    bufs.graph = ChunkGraph(key, graph, tally)
    bufs.captures += 1
    t2 = time.perf_counter()
    parts = bufs.capture_parts
    parts["warm_s"] += t1 - t0
    parts["host_s"] += host[0]
    parts["instantiate_s"] += t2 - t1 - host[0]
    bufs.capture_s += t2 - t0
    return bufs.graph


def capture_stats(st: _Static):
    """(graphs captured, host seconds they took) on the statics ``st``."""
    bufs = getattr(st, "_step_buffers", None)
    return (bufs.captures, bufs.capture_s) if bufs is not None else (0, 0.0)


def capture_parts(st: _Static) -> Dict[str, float]:
    """The host seconds of the captures on ``st`` by part: warm_s,
    host_s, instantiate_s (``StepBuffers.capture_parts``)."""
    bufs = getattr(st, "_step_buffers", None)
    parts = bufs.capture_parts if bufs is not None else {}
    return {k: parts.get(k, 0.0) for k in ("warm_s", "host_s", "instantiate_s")}


def walk_cuda(st: _Static, tab, layout: str):
    """K7 (``csrc/path_walk.cu``): ``engine._walk`` on the card, the same
    outputs, (parent masks, last coordinate) as int64 arrays, from one
    launch on the table's device's current stream and one host read.
    Raises ValueError on a table that is not ``layout``'s, not on a CUDA
    device or not of the statics' size, and RuntimeError when the launch
    fails."""
    args, bufs = _walk_args(st, tab, layout)
    _kernels.launch(*args)
    res = bufs[1].cpu().numpy().astype(np.int64)  # the run's one read
    n, tmax = st.n, len(res) - st.n - 1
    return res[:int(res[tmax + n])], res[tmax:tmax + n]


def _walk_table(st: _Static, tab, layout: str) -> tuple:
    """K7's table arguments on the checked table: (device, layout code,
    keys, row stride, t_best, t_fpar, probes)."""
    want = {"sig": SigTable, "packed": PackedTable, "unpacked": UnpackedTable}.get(layout)
    if want is None or not isinstance(tab, want):
        raise ValueError(f"the walk of layout {layout!r} needs its table, got "
                         f"{type(tab).__name__}")
    if layout == "sig":
        dev = _cuda_device(tab.t_sig, "t_sig")
        _check(tab.t_sig, "t_sig", dev, torch.int32, st.C)
        _check(tab.t_best, "t_best", dev, torch.int32, st.C)
        if not st.sig_ok or st.n > K4_MAX_N:
            raise ValueError("the sig walk needs a sig-eligible table of at most "
                             f"{K4_MAX_N} sequences")
        keys, stride, best, fpar, probes = tab.t_sig, 1, tab.t_best, None, st.max_bprobes
    else:
        dev = _cuda_device(tab.t_key, "t_key")
        stride = st.KW if layout == "packed" else st.W
        _check(tab.t_key, "t_key", dev, torch.int32, st.C * stride)
        if tab.t_key.dim() != 2 or tab.t_key.shape[1] != stride:
            raise ValueError(f"t_key: shape {tuple(tab.t_key.shape)}, need (>= {st.C}, "
                             f"{stride})")
        if st.n > K9_MAX_N:
            raise ValueError(f"the key-row walk takes at most {K9_MAX_N} sequences")
        if layout == "packed":
            _check(tab.t_best, "t_best", dev, torch.int32, st.C)
            best, fpar = tab.t_best, None
        else:
            _check(tab.t_fpar, "t_fpar", dev, torch.int64, st.C)
            best, fpar = None, tab.t_fpar
        keys, probes = tab.t_key, st.max_probes
    return (dev, WALK_LAYOUTS[layout], keys.data_ptr(), stride,
            None if best is None else best.data_ptr(), None if fpar is None else fpar.data_ptr(),
            probes)


def _walk_args(st: _Static, tab, layout: str):
    """K7's C arguments (kernel name first) on the checked table, and the
    buffers they point to, (params, out), which the caller keeps until the
    launch has run (``walk_cuda``'s checks and errors)."""
    dev, code, keys, stride, best, fpar, probes = _walk_table(st, tab, layout)
    n, tmax = st.n, int(st.final_np.sum())
    params = torch.tensor(list(st.final_np) + list(st.bitw), dtype=torch.int32).to(dev)
    out = torch.empty(tmax + n + 1, dtype=torch.int32, device=dev)
    args = ("path_walk", code, keys, stride, best, fpar, n, st.C, st.bbits, probes,
            params.data_ptr(), tmax, out.data_ptr(), _stream(dev))
    return args, (params, out)


# --- the sharded sig step (parallel/sharded.py): K4's sharded
# instantiation, K5 on the received rows and the self-owned lanes, and K7's
# hop-limited mode


def k4s_rows(M: int, rows: Optional[int] = None) -> int:
    """K4s's rows a block for rows of ``M`` masks: ``rows`` (by default
    K4S_ROWS) at M <= K9S_ROWS_MAX_M, else 0, the warp-strided form (N >=
    6)."""
    rows = K4S_ROWS if rows is None else rows
    if not 0 <= rows <= 8:
        raise ValueError(f"K4s: {rows} rows a block, need 0 .. 8")
    return rows if M <= K9S_ROWS_MAX_M else 0


def expand_sharded_cuda(st: _Static, tab: SigTable, bufs: StepBuffers, counters, ub: int,
                        h3, cand, pend_at: int, hash_params: tuple, ndev: int, me: int,
                        launch=None, coords=None, rows: Optional[int] = None) -> None:
    """K4's sharded instantiation (``sig_expand_sharded``) over K3's compact
    list in ``bufs``: as the unsharded K4, with h3 ((B, M + 1) int32 from
    K12 after the reduce-scatter, or None: the shard reads its own cubes)
    in place of the cube reads, every lane's candidate row written to
    ``cand`` ((B M, 4) int32) and only self-owned lanes matched in their
    home row, the unmatched appended to ``bufs.pend`` from row
    ``pend_at``.  ``hash_params``: partition.owner_params; ``launch`` as
    ``select_best_cuda``'s; ``coords`` the list's (B, N) int32 coordinates
    that ``sig_coords`` wrote this step (None: the kernel decodes each
    row's sig word); ``rows`` the rows form's rows a block (``k4s_rows``;
    0 the warp-strided form)."""
    dev = _check_step(st, tab, counters, cubes=False)
    L = st.B * st.M
    _check(cand, "cand", dev, torch.int32, 4 * L)
    _check(bufs.pend, "pend", dev, torch.int32, 3 * (pend_at + L))
    if h3 is not None:
        _check(h3, "h3", dev, torch.int32, st.B * (st.M + 1))
    elif st.T3:
        _check(st.d_cubes, "cubes", dev, torch.int32, st.T3 * st.S ** 3)
    if coords is not None:
        _check(coords, "coords", dev, torch.int32, st.B * st.n)
    (launch or _kernels.launch)(*_expand_args(
        st, tab, bufs, counters, ub, _stream(dev), entry="sig_expand_sharded",
        cubes=h3 is None, pend_at=pend_at,
        sharded=(None if h3 is None else h3.data_ptr(), cand.data_ptr(), *hash_params, ndev,
                 me, None if coords is None else coords.data_ptr(), k4s_rows(st.M, rows))))


def _check_recv(recv, run, dev, pend_at: int, n_rows: int, lanes: int, name: str) -> None:
    """The sharded insert's received count and flag: int32 words on the
    card; at most ``pend_at`` rows (the received region ends there) and
    room for the lanes of the whole list."""
    _check(recv, "recv", dev, torch.int32)
    if run is not None:
        _check(run, "run", dev, torch.int32)
    if not 0 <= pend_at <= n_rows or lanes < n_rows:
        raise ValueError(f"{name}: received rows end at {pend_at} of {n_rows} pending rows, "
                         f"{lanes} lanes")


def probe_pending_cuda(st: _Static, tab: SigTable, bufs: StepBuffers, counters, fill: int,
                       pend_at: int, recv: torch.Tensor, run: Optional[torch.Tensor] = None,
                       blocks: int = 0, cap: int = K5_CAP, launch=None) -> None:
    """K5 (``sig_probe``) over the pending lanes of the sharded step:
    ``recv[0]`` received rows (a count on the card, which the consensus
    wrote) ending at row ``pend_at`` of ``bufs.pend``, then K4's self-owned
    unmatched lanes from it, ``state[STATE_NPEND]`` lanes in all.  ``run``
    is the insert's flag (default ``bufs.run``); ``launch`` as
    ``select_best_cuda``'s."""
    dev = _check_step(st, tab, counters, cubes=False)
    _check_recv(recv, run, dev, pend_at, bufs.pend.shape[0], bufs.lane_cur.numel(), "K5")
    (launch or _kernels.launch)(*_probe_args(st, tab, bufs, counters, fill, blocks, cap,
                                             _stream(dev), pend_at, recv, run))


def walk_hops_cuda(st: _Static, tab, coord, hops: int, layout: str = "sig",
                   out: Optional[torch.Tensor] = None, run: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """K7's hop-limited mode (``path_walk_hops``): at most ``hops`` steps
    of the walk from ``coord`` on this shard's table of ``layout``,
    stopping at the origin or at a node the table does not hold.  Returns
    the device buffer (hops + N + 1,) int32 (``out``, or a new one): the
    run of masks (0 past its end), the coordinate it stopped at, the run's
    length (no host read).  ``coord``: N ints, or the walk loop's int32
    params on the card ([coordinate, key bit widths], which walk_advance
    moves on); ``run``: the walk loop's flag (the launch returns at once
    when it reads 0).  Raises ValueError as ``walk_cuda``."""
    if not 1 <= hops <= 64:
        raise ValueError(f"K7 hop mode: hops {hops}, need 1 .. 64")
    dev, code, keys, stride, best, fpar, probes = _walk_table(st, tab, layout)
    if isinstance(coord, torch.Tensor):
        _check(coord, "params", dev, torch.int32, 2 * st.n)
        params = coord
    else:
        params = torch.tensor([int(v) for v in coord] + list(st.bitw),
                              dtype=torch.int32).to(dev)
    if out is None:
        out = torch.empty(hops + st.n + 1, dtype=torch.int32, device=dev)
    _check(out, "out", dev, torch.int32, hops + st.n + 1)
    if run is not None:
        _check(run, "run", dev, torch.int32)
    _kernels.launch("path_walk_hops", code, keys, stride, best, fpar, st.n, st.C, st.bbits,
                    probes, params.data_ptr(), hops, out.data_ptr(),
                    None if run is None else run.data_ptr(), _stream(dev))
    if params is not coord:
        out._params = params  # kept alive until the launch has run
    return out


# --- the sharded key-row step (parallel/sharded.py): K9's sharded
# instantiation and K10 on the received rows and the self-owned lanes


def expand_keyrow_sharded_cuda(st: _Static, tab, bufs: StepBuffers, counters, ub: int, h3,
                               cand, pend_at: int, hash_params: tuple, ndev: int, me: int,
                               tag_base: int, launch=None, rows: Optional[int] = None) -> None:
    """K9's sharded instantiation (``keyrow_expand_sharded``) over K3's
    compact list in ``bufs``: as the unsharded K9, with h3 ((B, M + 1) int32
    from K12 after the reduce-scatter, packed only; or None: the shard
    reads the cubes of ``st``) in place of the cube reads, every lane's
    candidate row written to ``cand`` ((B M, 2 + PW) int32: dest, fsort and
    the pending entry) and only self-owned lanes matched in their home row
    (packed) or pending, appended to ``bufs.pend`` from row ``pend_at``,
    their claim tags from ``tag_base``.  ``hash_params``:
    partition.owner_params; ``launch`` as ``select_best_cuda``'s; ``rows``
    the rows form's rows a block (``k9s_launch_shape``; by default
    K9S_ROWS, 0 the block form)."""
    dev, layout = _check_keyrow(st, tab, counters, cubes=h3 is None)
    L = st.B * st.M
    pw = bufs.pend.shape[1]
    if pw != st.W + (5 if layout == "unpacked" else 4):
        raise ValueError(f"pend: {pw} words a row, not the {layout} layout's")
    _check(cand, "cand", dev, torch.int32, (2 + pw) * L)
    if cand.dim() != 2 or cand.shape[1] != 2 + pw:
        raise ValueError(f"cand: shape {tuple(cand.shape)}, need ({L}, {2 + pw})")
    _check(bufs.pend, "pend", dev, torch.int32, pw * (pend_at + L))
    if h3 is not None:
        if layout == "unpacked":
            raise ValueError("the unpacked step reads its cubes: no h3")
        _check(h3, "h3", dev, torch.int32, st.B * (st.M + 1))
    if not 0 <= tag_base or tag_base + L >= 2**31:
        raise ValueError(f"claim tags from {tag_base}: {L} lanes must stay below 2^31")
    (launch or _kernels.launch)(*_keyrow_expand_args(
        st, tab, bufs, counters, ub, _stream(dev), entry="keyrow_expand_sharded",
        cubes=h3 is None, pend_at=pend_at, rows=rows,
        sharded=(None if h3 is None else h3.data_ptr(), cand.data_ptr(), 2 + pw, *hash_params,
                 ndev, me, int(tag_base))))


def insert_pending_cuda(st: _Static, tab, bufs: StepBuffers, counters, fill: int, pend_at: int,
                        recv: torch.Tensor, run: Optional[torch.Tensor] = None, blocks: int = 0,
                        cap: int = K10_CAP, launch=None) -> None:
    """K10 (``keyrow_insert_recv``) over the pending entries of the
    sharded step: ``recv[0]`` received rows (a count on the card, which the
    consensus wrote) ending at row ``pend_at`` of ``bufs.pend``, each
    claiming with its place in the list, then K9's self-owned pending lanes
    from it, ``state[STATE_NPEND]`` entries in all.  ``run`` is the
    insert's flag (default ``bufs.run``); ``launch`` as
    ``select_best_cuda``'s."""
    dev, _ = _check_keyrow(st, tab, counters, cubes=False)
    _check_recv(recv, run, dev, pend_at, bufs.pend.shape[0], bufs.lane_cur.numel(), "K10")
    if not 0 <= cap <= K10_CAP:
        raise ValueError(f"K10 cap {cap}: need 0 .. {K10_CAP}")
    (launch or _kernels.launch)(*_keyrow_insert_args(
        st, tab, bufs, counters, fill, blocks, cap, _stream(dev), pend_at=pend_at, recv=recv,
        run=run))
