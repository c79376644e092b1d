"""The sig layout's search step on the card: kernels K3, K4 and K5.

The JAX engine runs its whole search loop as one compiled program
(``_make_run_loop_sig``, mpi_pastar_msa_tpu/search/engine.py:1882, through
``_make_run_loop_packed`` at :1819); each step is ``_select_sig`` (:1620),
``_expand`` (:497) with ``_candidates_sig`` -> ``_sig_encode`` (:1724,
:400) and ``_insert_sig`` (:1551).  On a CUDA sig table the port runs each
step as three hand-written kernels, launched back to back on the current
stream with no host read between them:

  K3 ``csrc/select_best.cu``  grouped argmin, cut and close (one memset and
                              two launches; ``select_best_cuda``, also the
                              packed layout's select on the card)
  K4 ``csrc/sig_expand.cu``   decode, expand, prune, sig-encode and the
                              round-0 row match of the insert; unmatched
                              lanes go to a pending list (``_launch_expand``)
  K5 ``csrc/sig_probe.cu``    the claimless bucket probe of the pending
                              lanes, then the step's 14 counters and the
                              run flag (``_launch_probe``)

The step loop (``run_chunk_sig_cuda``, K6 of the JAX loop) keeps the 14
counters in a device int64 vector, as the JAX ``while_loop`` does, and the
stop test on the device: K5 ends each step by writing a run flag (f-min <
goal_g and no overflow), and every kernel of the next step returns at once
when it reads 0.  So a chunk is ``chunk_steps`` steps enqueued with no host
read, and the host reads the counters once a chunk (``FrontierSearch``).
Steps enqueued after the stop do nothing.  The plain step
(``engine._run_chunk_plain``) gives the same tables and counters bit for
bit: ``chip_smoke.py`` holds them to each other on the card.

The wrappers (``select_best_cuda``, ``run_chunk_sig_cuda``) check devices,
dtypes and sizes and raise ValueError on anything the kernels do not take;
nothing falls back to the plain code.  The ``_launch_*`` functions launch
one kernel each on checked buffers.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _kernels
from ..core.cost import GAP_EXTENSION, GAP_GAP
from .engine import N_COUNTERS, SigTable, _Static

# the slots of the step's state vector (csrc/step_state.cuh)
STATE_GMAX, STATE_NOPEN, STATE_NSEL, STATE_REOPEN, STATE_FMIN = 0, 1, 2, 3, 4
STATE_NVALID, STATE_NPEND, STATE_CALLS, STATE_CNT = 5, 6, 7, 8
MAX_CALLS = 128
STATE_WORDS = STATE_CNT + MAX_CALLS


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
                     bufs: "StepBuffers" = None):
    """K3 (``csrc/select_best.cu``): ``engine._select_best_plain`` on the
    card, the same outputs: (slots, vmin, active, fmin, n_open, n_selected,
    reopen_ct) with t_closed updated in place.  The four counts are 0-d
    views of the step's state vector.  ``run`` is the step loop's flag (the
    kernels return at once when it reads 0); ``bufs`` the loop's buffers
    (default: new outputs)."""
    dev = _cuda_device(t_best, "t_best")
    _check(t_best, "t_best", dev, torch.int32, st.C)
    _check(t_closed, "t_closed", dev, torch.int32, st.C)
    goal = _scalar(goal_g, "goal_g", dev)
    thr = _scalar(thr, "thr", dev)
    if run is not None:
        _check(run, "run", dev, torch.int32)
    if bufs is None:
        bufs = StepBuffers.select_only(st, dev)
    _launch_select(st, t_best, t_closed, goal, thr, run, bufs, _stream(dev))
    s = bufs.state
    return (bufs.slots, bufs.vmin, bufs.active, s[STATE_FMIN], s[STATE_NOPEN],
            s[STATE_NSEL], s[STATE_REOPEN])


def _launch_select(st, t_best, t_closed, goal, thr, run, bufs, stream) -> None:
    _kernels.launch("select_best", t_best.data_ptr(), t_closed.data_ptr(), st.C, st.B,
                    st.nb, st.f0, goal.data_ptr(), thr.data_ptr(),
                    None if run is None else run.data_ptr(), bufs.slots.data_ptr(),
                    bufs.vmin.data_ptr(), bufs.active.data_ptr(), bufs.state.data_ptr(),
                    stream)


@dataclass
class StepBuffers:
    """Device buffers of the sig step, made once a table size.

    slots, vmin (B,) int64, active (B,) bool: K3's outputs
    state (STATE_WORDS,) int64: the step's counts (csrc/step_state.cuh)
    run (1,) int32: the step loop's run flag
    pend (B * M, 3) int32: K4's pending lanes (home, sig base, packed)
    lane_cur, lane_dest, lane_word (B * M,) int32: K5's lane state
    params int32: pairs, weights, triangles, final coordinate and key bit
    widths for K4 (``_kernel_params``)"""
    slots: torch.Tensor
    vmin: torch.Tensor
    active: torch.Tensor
    state: torch.Tensor
    run: torch.Tensor = None
    pend: torch.Tensor = None
    lane_cur: torch.Tensor = None
    lane_dest: torch.Tensor = None
    lane_word: torch.Tensor = None
    params: torch.Tensor = None

    @classmethod
    def select_only(cls, st: _Static, dev) -> "StepBuffers":
        B = st.B
        return cls(torch.empty(B, dtype=torch.int64, device=dev),
                   torch.empty(B, dtype=torch.int64, device=dev),
                   torch.empty(B, dtype=torch.bool, device=dev),
                   torch.empty(STATE_WORDS, dtype=torch.int64, device=dev))

    @classmethod
    def for_step(cls, st: _Static, dev) -> "StepBuffers":
        bufs = cls.select_only(st, dev)
        cap = st.B * st.M
        bufs.run = torch.zeros(1, dtype=torch.int32, device=dev)
        bufs.pend = torch.empty((cap, 3), dtype=torch.int32, device=dev)
        bufs.lane_cur, bufs.lane_dest, bufs.lane_word = (
            torch.empty(cap, dtype=torch.int32, device=dev) for _ in range(3))
        bufs.params = _kernel_params(st, dev)
        return bufs


def _kernel_params(st: _Static, dev) -> torch.Tensor:
    """K4's constants as one int32 vector: xs, ys, w, w_h (P each), the
    triangles (3T), the final coordinate and the key bit widths (N each)."""
    parts = [st.d_xs, st.d_ys, st.d_w, st.d_w_h]
    if st.T3:
        parts.append(st.d_tri_xyz.reshape(-1))
    parts += [st.d_final, torch.tensor(st.bitw, device=st.device)]
    v = torch.cat([p.to(st.device, torch.int64) for p in parts])
    if int(v.abs().max()) >= 2**31:
        raise ValueError("K4: a pair weight does not fit 32 bits")
    return v.to(dev, torch.int32)


def _step_buffers(st: _Static, dev) -> StepBuffers:
    bufs = getattr(st, "_step_buffers", None)
    if bufs is None or bufs.slots.device != dev:
        bufs = StepBuffers.for_step(st, dev)
        st._step_buffers = bufs
    return bufs


def _check_step(st: _Static, tab, counters):
    """The device of a sig step, after checking the table, the statics and
    the counters."""
    if not isinstance(tab, SigTable):
        raise ValueError(f"the sig step kernels need a SigTable, got {type(tab).__name__}")
    dev = _cuda_device(tab.t_sig, "t_sig")
    for name in ("t_sig", "t_best", "t_closed"):
        _check(getattr(tab, name), name, dev, torch.int32, st.C)
    _check(counters, "counters", dev, torch.int64)
    if counters.numel() != N_COUNTERS:
        raise ValueError(f"counters: {counters.numel()} elements, need {N_COUNTERS}")
    _check(st.d_tables4, "tables4", dev, torch.int32, st.P * st.S * st.S * 8)
    if st.T3:
        _check(st.d_cubes, "cubes", dev, torch.int32, st.T3 * st.S ** 3)
    if not st.sig_ok:
        raise ValueError("the sig step kernels need a sig-eligible table (sig_ok)")
    return dev


def _launch_expand(st, tab, bufs, counters, ub, stream) -> None:
    threads = min(256, 32 * ((st.M + 31) // 32))
    _kernels.launch(
        "sig_expand", tab.t_sig.data_ptr(), tab.t_best.data_ptr(), bufs.slots.data_ptr(),
        bufs.vmin.data_ptr(), bufs.active.data_ptr(), st.d_tables4.data_ptr(),
        st.d_cubes.data_ptr() if st.T3 else None, bufs.params.data_ptr(), st.n, st.P,
        st.T3, st.S, st.nb, st.f0, int(ub), GAP_EXTENSION, GAP_GAP, st.gap_oe, st.bbits,
        st.B, threads, bufs.run.data_ptr(), counters.data_ptr(), bufs.state.data_ptr(),
        bufs.pend.data_ptr(), stream)


def _launch_probe(st, tab, bufs, counters, fill, blocks, stream) -> None:
    _kernels.launch(
        "sig_probe", tab.t_sig.data_ptr(), tab.t_best.data_ptr(), bufs.pend.data_ptr(),
        bufs.lane_cur.data_ptr(), bufs.lane_dest.data_ptr(), bufs.lane_word.data_ptr(),
        st.bbits, st.max_bprobes, st.max_probes, int(fill), bufs.run.data_ptr(),
        counters.data_ptr(), bufs.state.data_ptr(), int(blocks), stream)


def run_chunk_sig_cuda(st: _Static, tab: SigTable, counters: torch.Tensor,
                       chunk_steps: int, ub: int, fill: int,
                       blocks: int = 0) -> torch.Tensor:
    """Up to ``chunk_steps`` steps of a CUDA sig table (``engine._run_chunk``
    on the card), each K3 -> K4 -> K5 with no host read: the plain loop's
    stop test runs on the device.  Like the plain loop, a chunk starts from
    f-min 0, so its first step runs unless goal_g <= 0 or the table
    overflowed.  ``blocks`` sizes K5's grid (0: its own choice).  Returns
    new counters; the table is updated in place."""
    dev = _check_step(st, tab, counters)
    bufs = _step_buffers(st, dev)
    counters = counters.clone()
    counters[1] = 0
    bufs.run.copy_(((counters[0] > 0) & (counters[6] == 0)).view(1))
    goal, thr, stream = counters[0], counters[7], _stream(dev)
    for _ in range(chunk_steps):
        _launch_select(st, tab.t_best, tab.t_closed, goal, thr, bufs.run, bufs, stream)
        _launch_expand(st, tab, bufs, counters, ub, stream)
        _launch_probe(st, tab, bufs, counters, fill, blocks, stream)
    return counters
