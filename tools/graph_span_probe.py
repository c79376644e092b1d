"""Probe: can one CUDA graph span two cards of one process?

The several-card chunked driver of the sharded engine
(``parallel/sharded.py``) captures one step of the whole mesh as one graph,
each card's work on its own stream, the phases joined by events between the
cards' streams.  This probe checks that design on two cards before the
engine relies on it:

1. ordering: card 0 spins (a large in-place multiply), then bumps a wire of
   int32 rows; card 1, after an event from card 0, runs the port's own
   ``exchange`` kernel (``csrc/shard_loop.cu``), which reads the wire on
   card 0 through its device address, and a peer copy of it (the
   ``copy_table`` host entry); card 0, after an event from card 1, copies
   card 1's result back.  Five replays: every copy must hold the bumped
   rows of its replay (a missing edge would read them stale);
2. cost: the replay of a graph of two tiny kernels joined by events, with
   the second on card 1, on a second stream of card 0, and on the same
   stream, each timed over 200 replays (CUDA events);
3. the cost of one node in a chain of 16 on card 0's stream, a graph
   replayed 100 times: a copy of 12 KB from card 1 (``copy_table``, a
   peer copy node), the same copy within card 0, a tiny PyTorch kernel,
   the port's ``exchange`` reading 12 KB of card 1's wire, and a round
   trip to card 1 and back by events (a tiny kernel on each side).

Needs two cards or more; prints one JSON line and exits 0 when every check
holds.  Run: ``python3 tools/graph_span_probe.py``.
"""
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpi_pastar_msa_tpu_torch import _kernels  # noqa: E402


def copies(rows, stream) -> None:
    """Device-to-device copies (dst, src) on ``stream``, by copy_table."""
    tab = torch.tensor([[d.data_ptr(), s.data_ptr(), d.numel() * d.element_size()]
                        for d, s in rows], dtype=torch.int64)
    _kernels.call("copy_table", tab.data_ptr(), len(rows), stream.cuda_stream)


def ordering(c0, c1) -> dict:
    cap, pw = 4096, 3
    spin = torch.ones(1 << 26, dtype=torch.float32, device=c0)
    wire = torch.zeros((cap, pw), dtype=torch.int32, device=c0)
    pend = torch.full((cap, pw), -1, dtype=torch.int32, device=c1)
    peer = torch.full((cap, pw), -1, dtype=torch.int32, device=c1)
    back = torch.full((cap, pw), -1, dtype=torch.int32, device=c0)
    # the exchange of one sender and one receiver: A[0][0] = cap rows
    cons = torch.zeros(10 + 4 + 1, dtype=torch.int64, device=c1)
    cons[-1] = cap
    flag = torch.ones(1, dtype=torch.int32, device=c1)
    xtab = torch.tensor([wire.data_ptr(), pend.data_ptr(), flag.data_ptr(), 0],
                        dtype=torch.int64)
    s1 = torch.cuda.Stream(c1)
    e0, e1 = torch.cuda.Event(), torch.cuda.Event()

    def step():
        s0 = torch.cuda.current_stream(c0)
        for _ in range(20):
            spin.mul_(1.0)
        wire.add_(1)
        e0.record(s0)
        s1.wait_event(e0)
        with torch.cuda.device(c1), torch.cuda.stream(s1):
            _kernels.launch("exchange", cons.data_ptr(), 1, cap, 0, 0, cap, pw, xtab.data_ptr(), 1,
                            s1.cuda_stream)
            copies([(peer, wire)], s1)
        e1.record(s1)
        s0.wait_event(e1)
        copies([(back, pend)], s0)

    with torch.cuda.device(c0):
        step()  # each entry's first call outside the capture
        torch.cuda.synchronize(c0)
        torch.cuda.synchronize(c1)
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(c0)
        side.wait_stream(torch.cuda.current_stream(c0))
        with torch.cuda.stream(side):
            g.capture_begin()
            try:
                step()
            finally:
                g.capture_end()
        torch.cuda.current_stream(c0).wait_stream(side)
        bad = []
        for k in range(5):
            g.replay()
            torch.cuda.synchronize(c0)
            want = int(wire[0, 0])
            got = [int(pend.min()), int(pend.max()), int(peer.min()), int(peer.max()),
                   int(back.min()), int(back.max())]
            if want != k + 2 or any(v != want for v in got):
                bad.append((k, want, got))
    return {"replays": 5, "stale": bad}


def replay_us(c0, c1, reps: int = 200) -> float:
    """One replay of a graph of two tiny kernels joined by events, the
    second on ``c1`` (None: the same stream as the first)."""
    a = torch.zeros(1, dtype=torch.int32, device=c0)
    b = torch.zeros(1, dtype=torch.int32, device=c1 or c0)
    s1 = torch.cuda.Stream(c1) if c1 is not None else None
    e0, e1 = torch.cuda.Event(), torch.cuda.Event()

    def step():
        s0 = torch.cuda.current_stream(c0)
        a.add_(1)
        if s1 is None:
            b.add_(1)
            return
        e0.record(s0)
        s1.wait_event(e0)
        with torch.cuda.device(s1.device), torch.cuda.stream(s1):
            b.add_(1)
        e1.record(s1)
        s0.wait_event(e1)

    with torch.cuda.device(c0):
        step()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(c0)
        side.wait_stream(torch.cuda.current_stream(c0))
        with torch.cuda.stream(side):
            g.capture_begin()
            try:
                step()
            finally:
                g.capture_end()
        torch.cuda.current_stream(c0).wait_stream(side)
        for _ in range(10):
            g.replay()
        torch.cuda.synchronize(c0)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            g.replay()
        t1.record()
        torch.cuda.synchronize(c0)
        return t0.elapsed_time(t1) / reps * 1e3


def chain_us(kind: str, c0, c1, n: int = 16, reps: int = 100) -> float:
    """µs a node of a chain of ``n`` nodes of ``kind`` (see the module's
    third check) in one graph on ``c0``'s stream."""
    rows, pw = 1024, 3  # 12 KB of int32 rows
    src = torch.arange(rows * pw, dtype=torch.int32, device=c1).view(rows, pw)
    dst = torch.zeros((rows, pw), dtype=torch.int32, device=c0)
    near = torch.ones((rows, pw), dtype=torch.int32, device=c0)
    a = torch.zeros(1, dtype=torch.int32, device=c0)
    b = torch.zeros(1, dtype=torch.int32, device=c1)
    cons = torch.zeros(15, dtype=torch.int64, device=c0)
    cons[-1] = rows
    flag = torch.ones(1, dtype=torch.int32, device=c0)
    xtab = torch.tensor([src.data_ptr(), dst.data_ptr(), flag.data_ptr(), 0], dtype=torch.int64)
    s1 = torch.cuda.Stream(c1)
    e0, e1 = torch.cuda.Event(), torch.cuda.Event()

    def node():
        s0 = torch.cuda.current_stream(c0)
        if kind == "peer_copy":
            copies([(dst, src)], s0)
        elif kind == "local_copy":
            copies([(dst, near)], s0)
        elif kind == "kernel":
            a.add_(1)
        elif kind == "peer_kernel":
            _kernels.launch("exchange", cons.data_ptr(), 1, rows, 0, 0, rows, pw, xtab.data_ptr(),
                            1, s0.cuda_stream)
        else:  # a round trip to card 1 and back
            e0.record(s0)
            s1.wait_event(e0)
            with torch.cuda.device(c1), torch.cuda.stream(s1):
                b.add_(1)
            e1.record(s1)
            s0.wait_event(e1)
            a.add_(1)

    with torch.cuda.device(c0):
        node()
        torch.cuda.synchronize(c0)
        torch.cuda.synchronize(c1)
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(c0)
        side.wait_stream(torch.cuda.current_stream(c0))
        with torch.cuda.stream(side):
            g.capture_begin()
            try:
                for _ in range(n):
                    node()
            finally:
                g.capture_end()
        torch.cuda.current_stream(c0).wait_stream(side)
        for _ in range(5):
            g.replay()
        torch.cuda.synchronize(c0)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            g.replay()
        t1.record()
        torch.cuda.synchronize(c0)
        return t0.elapsed_time(t1) / reps / n * 1e3


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("graph_span_probe: needs two cards or more")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print("\n".join(smi))
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    t = time.perf_counter()
    _kernels.build_all(["exchange"])
    build_s = time.perf_counter() - t
    _kernels.enable_peer_access([c0, c1])
    out = {"cards": torch.cuda.device_count(), "name": torch.cuda.get_device_name(0),
           "build_s": build_s}
    try:
        out["ordering"] = ordering(c0, c1)
        out["one_graph_spans_cards"] = not out["ordering"]["stale"]
    except Exception as e:  # a capture or a replay that fails: the answer, not a crash
        out["one_graph_spans_cards"] = False
        out["error"] = f"{type(e).__name__}: {e}"
    if out["one_graph_spans_cards"]:
        out["replay_us"] = {"two_cards": replay_us(c0, c1),
                            "two_streams_one_card": replay_us(c0, c0),
                            "one_stream": replay_us(c0, None)}
        out["chain_node_us"] = {k: chain_us(k, c0, c1) for k in (
            "peer_copy", "local_copy", "kernel", "peer_kernel", "round_trip")}
    print(json.dumps(out))
    return 0 if out["one_graph_spans_cards"] else 1


if __name__ == "__main__":
    sys.exit(main())
