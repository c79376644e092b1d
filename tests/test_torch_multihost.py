"""The port's multi-process path on the CPU: two processes of one
torch.distributed group over gloo (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, as torchrun sets them).  Rank 0 reads the FASTA and
broadcasts the sequences (parallel/multihost.py); the CLI runs one shard a
rank on a ProcessMesh (parallel/mesh.py) and both ranks print the golden
Final Score of PF08184.  ``broadcast_problem`` alone round-trips the
sequences to a rank that read nothing."""
import json
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLD = json.load(open(os.path.join(HERE, "goldens.json")))
TIMEOUT = 240  # each process's own limit (subprocess timeout), well inside the lane's


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(argv, world=2):
    """Start ``world`` processes of ``argv`` as the ranks of one group and
    return their (exit code, output)."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        env.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, env=env, cwd=ROOT))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def fasta(tmp_path, name):
    path = tmp_path / name
    path.write_text("".join(f">s{k}\n{r.replace('-', '')}\n"
                            for k, r in enumerate(GOLD[name]["alignment"])))
    return str(path)


@pytest.mark.parametrize("exchange", ["dense", "ragged"])
def test_two_process_cli_reaches_golden(tmp_path, exchange):
    path = fasta(tmp_path, "PF08184.fasta")
    outs = run_ranks([sys.executable, "-m", "mpi_pastar_msa_tpu_torch", "--device", "cpu",
                      "--engine", "frontier", "--devices", "2", "--exchange", exchange, path])
    want = f"g - {GOLD['PF08184.fasta']['optimal_g']}"
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}"
        assert want in out, out[-3000:]
        assert f"shards: 2, one a process; rank {rank} on cpu" in out
        assert f"exchange {exchange} " in out and "migrated" in out


def test_broadcast_problem_round_trips():
    seqs = ("ACDEFGHIK", "WY", "MNPQRSTV")
    code = (
        "from mpi_pastar_msa_tpu_torch.core.problem import Problem\n"
        "from mpi_pastar_msa_tpu_torch.parallel.multihost import broadcast_problem, "
        "init_distributed\n"
        "rank = init_distributed()\n"
        f"p = broadcast_problem(Problem({seqs!r}) if rank == 0 else None)\n"
        "print('SEQS', rank, p.seqs)\n")
    outs = run_ranks([sys.executable, "-c", code])
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, out[-3000:]
        assert f"SEQS {rank} {seqs!r}" in out, out[-3000:]


def test_single_process_is_a_passthrough(monkeypatch):
    from mpi_pastar_msa_tpu_torch.core.problem import Problem
    from mpi_pastar_msa_tpu_torch.parallel.multihost import broadcast_problem, init_distributed

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == 0
    p = Problem(("ACD", "AD"))
    assert broadcast_problem(p) is p
    with pytest.raises(ValueError):
        broadcast_problem(None)
