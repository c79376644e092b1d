"""The sharded loop's ``exchange`` (csrc/shard_loop.cu) reading other
processes' wires through CUDA IPC, as each rank of a ProcessMesh of cards
runs its ragged exchange.

Started once a rank, as ``torchrun`` starts a program (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``): every rank makes its own wire
(seeded random int32 rows) on its card, maps every other rank's wire into
its process (``ProcessMesh.map_peers``: one all_gather_object of the
handles over gloo, so no NCCL communicator is made and several ranks may
share one card), and runs ``exchange`` for itself as the receiver from
the mapped wires, under the ragged allowance of seeded send counts: bit
for bit against ``exchange_plain`` on the same rows rebuilt from the
seeds on the CPU, in several cases (the first at kinase's sizes on four
shards, a later one clipping the allowance).  Then it times the kernel
from the mapped wires (the wrapper's call: CUDA events over many
launches; the kernel: its CUPTI durations under torch.profiler) and its
plain version on the card, and closes the mappings behind a barrier
(``unmap_peers``).  Each rank prints one line ``IPC_CHECK {...}``: its
rank, card, the largest difference, the rows and words it received, the
bytes the exchange must move and of them the bytes read from other
ranks' wires (over NVLink where the ranks hold several cards), the
wrapper's, the kernel's and the plain version's ms.

    WORLD_SIZE=2 RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
        python3 tools/ipc_exchange_check.py --one-card

``--one-card`` puts every rank on card 0 (two processes on one card),
else rank r takes card r modulo the cards.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpi_pastar_msa_tpu_torch import _kernels  # noqa: E402
from mpi_pastar_msa_tpu_torch.parallel import sharded as SH  # noqa: E402
from mpi_pastar_msa_tpu_torch.parallel.mesh import ProcessMesh  # noqa: E402
from mpi_pastar_msa_tpu_torch.parallel.multihost import init_distributed  # noqa: E402

# (exchange cap, words a row, the send counts' upper end): kinase's packed
# wire on four shards (cap 7,936, 7 words a row, a step's few thousand rows),
# then a cap that clips the allowance, and the widest row
CASES = ((7936, 7, 1500), (50, 3, 150), (600, 16, 900))
REPS = 200  # the wrapper's launches timed (the plain version's: a twentieth)


def wire_of(rank: int, case: int, rows: int, pw: int) -> torch.Tensor:
    """Rank ``rank``'s wire in case ``case``, the same on every rank."""
    rng = np.random.default_rng(1000 * case + rank)
    return torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (rows, pw)), dtype=torch.int32)


def device_ms(fn, reps: int) -> float:
    """The exchange kernel's mean CUPTI duration over ``reps`` calls of
    ``fn`` (torch.profiler); 0.0 where the session recorded none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "exchange_kernel" in e.key and e.count]
    return sum(e.device_time_total for e in ev) / max(sum(e.count for e in ev), 1) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--one-card", action="store_true", help="every rank on card 0")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the exchange reads mapped card memory", file=sys.stderr)
        return 2
    rank = init_distributed()
    ndev = torch.distributed.get_world_size()
    dev = torch.device("cuda", 0 if args.one_card else rank % torch.cuda.device_count())
    mesh = ProcessMesh(dev)
    out = dict(rank=rank, world=ndev, device=str(dev), name=torch.cuda.get_device_name(dev),
               cases=[])
    err = 0
    for case, (cap, pw, hi) in enumerate(CASES):
        R = ndev * cap
        counts = np.random.default_rng(case).integers(0, hi, (ndev, ndev))
        A = SH.route_sizes(counts, ndev, cap, True)
        cons = SH.fresh_cons(ndev, dev)
        SH.cons_sizes(cons, ndev)[:] = torch.as_tensor(A, device=dev)
        # a wire holds every row its rank sends (the engine's: max(ndev cap,
        # its candidates and ring)), and some rows past them
        rows = max(R, int(A.sum(1).max())) + 64
        own = wire_of(rank, case, rows, pw).to(dev)
        try:
            wires = mesh.map_peers([own])
        except RuntimeError as e:
            raise RuntimeError(f"case {case} (cap {cap}, {pw} words a row): {e}") from e
        pend = torch.full((R + 64, pw), -5, dtype=torch.int32, device=dev)
        flag = torch.ones(1, dtype=torch.int32, device=dev)
        xtab = SH.exchange_table(wires, [pend], [flag], [rank])
        SH.exchange_cuda(cons, ndev, cap, True, R, pw, xtab)
        torch.cuda.synchronize(dev)
        want = torch.full((R + 64, pw), -5, dtype=torch.int32)
        SH.exchange_plain(cons.cpu(), ndev, cap, True, R,
                          [wire_of(i, case, rows, pw) for i in range(ndev)], [want],
                          [torch.ones(1, dtype=torch.int32)], [rank])
        diff = int((pend.cpu().long() - want.long()).abs().max())
        err = max(err, diff)
        n = int(A[:, rank].sum())
        info = dict(cap=cap, row_words=pw, rows=n, sizes=A.tolist(), max_abs_err=diff)
        if case == 0:
            # the rows read and written, the flag and the receiver's column
            # of A; of them the rows read from the other ranks' wires
            nbytes = n * pw * 4 * 2 + 4 + ndev * 8
            remote = (n - int(A[rank, rank])) * pw * 4
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            for label, fn in (("ms", lambda: SH.exchange_cuda(cons, ndev, cap, True, R, pw,
                                                              xtab)),
                              ("plain_ms", lambda: SH.exchange_plain(
                                  cons, ndev, cap, True, R, [own] * ndev, [pend], [flag],
                                  [rank]))):
                reps = REPS if label == "ms" else REPS // 20
                fn()
                torch.cuda.synchronize(dev)
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                torch.cuda.synchronize(dev)
                info[label] = start.elapsed_time(end) / reps
            info.update(bytes=nbytes, remote_bytes=remote, peers=ndev - 1,
                        device_ms=device_ms(lambda: SH.exchange_cuda(
                            cons, ndev, cap, True, R, pw, xtab), 50))
        out["cases"].append(info)
        mesh.unmap_peers()
        del wires, xtab
    out["max_abs_err"] = err
    out["launches"] = _kernels.launches["exchange"]
    print("IPC_CHECK " + json.dumps(out), flush=True)
    return 0 if err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
