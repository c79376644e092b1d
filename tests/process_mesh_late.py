"""One rank of a ProcessMesh of cards (NCCL), the ragged exchange under the
chunked driver, with one rank late: not a test file, the program that
tests/test_torch_cuda.py::test_process_mesh_ragged_late_rank starts once a
rank (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

Kinase, one chunk of 256 steps, in turns: the host driver, the chunked
driver, and the chunked driver with rank ``--late`` spinning ``--cycles``
clock cycles (``torch.cuda._sleep``, captured into its step graphs) before
its pack, which writes the wire its peers read, and before its exchange,
which reads theirs.  The step's collectives alone order those reads and
writes (``ShardedFrontierSearch._step_ranks``), so every run leaves the
same words.  Each run prints ``LATE_RUN {...}``: the rank, the driver, the
cycles, the exchange, steps, host reads and the hash of the rank's words
(tools/process_mesh_turns.py::words_hash).
"""
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from mpi_pastar_msa_tpu_torch.core.problem import Problem  # noqa: E402
from mpi_pastar_msa_tpu_torch.parallel import sharded as SH  # noqa: E402
from mpi_pastar_msa_tpu_torch.parallel.mesh import ProcessMesh  # noqa: E402
from mpi_pastar_msa_tpu_torch.parallel.multihost import init_distributed  # noqa: E402
from process_mesh_turns import words_hash  # noqa: E402


def late(fn, cycles: int):
    def go(*args, **kw):
        torch.cuda._sleep(cycles)
        return fn(*args, **kw)
    return go


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--late", type=int, default=1, help="the late rank")
    ap.add_argument("--cycles", type=int, default=200_000)
    ap.add_argument("--steps", type=int, default=256)
    args = ap.parse_args()
    rank = init_distributed()
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    gold = json.load(open(os.path.join(ROOT, "tests", "goldens.json")))["kinase.fasta"]
    problem = Problem(tuple(r.replace("-", "") for r in gold["alignment"]))
    mesh = ProcessMesh(dev)
    pack, exchange = SH._Shard.pack, SH._Card.exchange
    for driver, cycles in (("host", 0), ("chunked", 0), ("chunked", args.cycles)):
        if cycles and rank == args.late:
            SH._Shard.pack, SH._Card.exchange = late(pack, cycles), late(exchange, cycles)
        eng = SH.ShardedFrontierSearch(problem, devices=mesh, driver=driver,
                                       chunk_steps=args.steps, max_steps=args.steps)
        try:
            eng.run()
        except RuntimeError as e:
            if "max_steps exceeded" not in str(e):
                raise
        torch.cuda.synchronize(dev)
        SH._Shard.pack, SH._Card.exchange = pack, exchange
        st = eng.last_stats
        print("LATE_RUN " + json.dumps(dict(
            rank=rank, driver=st["driver"], cycles=cycles, exchange=eng.exchange,
            steps=st["steps"], host_reads=st["host_reads"], hash=words_hash(eng))), flush=True)
        del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
