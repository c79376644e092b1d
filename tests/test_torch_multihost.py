"""The port's multi-process path on the CPU: processes of one
torch.distributed group over gloo (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, as torchrun sets them).  Rank 0 reads the FASTA and
broadcasts the sequences (parallel/multihost.py); the CLI runs one shard a
rank on a ProcessMesh (parallel/mesh.py) and both ranks print the golden
Final Score of PF08184, under the chunked driver with the dense exchange
(and auto, which resolves to it) and under the host driver with the
ragged one.  ``tools/process_mesh_turns.py`` on 2 and 4 ranks runs the
chunked driver (the step's rank form, the mesh's collectives between its
phases) and the host driver, dense, on PF08184 and test2: the golden g
and alignment, every shard's table words equal (a hash a rank), one host
read a chunk; with the ragged exchange, which a CPU rank sizes on its
host, the host driver reaches the golden and the chunked one raises.
``broadcast_problem`` alone round-trips the sequences to a rank that read
nothing."""
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


@pytest.mark.parametrize("exchange", ["dense", "ragged", "auto"])
def test_two_process_cli_reaches_golden(tmp_path, exchange):
    """auto resolves to dense on a ProcessMesh, whose chunked driver needs
    it; ragged takes the host driver there."""
    path = fasta(tmp_path, "PF08184.fasta")
    outs = run_ranks([sys.executable, "-m", "mpi_pastar_msa_tpu_torch", "--device", "cpu",
                      "--engine", "frontier", "--devices", "2", "--exchange", exchange, path])
    want = f"g - {GOLD['PF08184.fasta']['optimal_g']}"
    ragged = exchange == "ragged"
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}"
        assert want in out, out[-3000:]
        assert f"shards: 2, one a process; rank {rank} on cpu" in out
        assert f"exchange {'ragged' if ragged else 'dense'} " in out and "migrated" in out
        assert f"driver {'host' if ragged else 'chunked'}," in out, out[-3000:]


def rank_runs(out: str) -> dict:
    """A rank's RANK_RUN lines of tools/process_mesh_turns.py, by driver."""
    runs = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
            if line.startswith("RANK_RUN ")]
    return {r["driver"]: r for r in runs}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["PF08184.fasta", "test2.fasta"])
def test_process_mesh_chunked_equals_host_driver(tmp_path, name, world):
    """A ProcessMesh of ``world`` gloo ranks, one shard each, dense: the
    chunked driver (chunks of 16 steps) and then the host driver on each
    rank.  Both reach the golden g and the golden alignment, every rank's
    shard leaves the same words under both (its hash), and the chunked run
    reads the host once a chunk (ceil(steps / 16)) and its walk once every
    WALK_ROUNDS rounds, the host run once a step and once a round."""
    chunk = 16
    outs = run_ranks([sys.executable, os.path.join("tools", "process_mesh_turns.py"),
                      fasta(tmp_path, name), "--device", "cpu", "--chunk", str(chunk),
                      "--drivers", "chunked,host"], world)
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}"
        runs = rank_runs(out)
        c, h = runs["chunked"], runs["host"]
        assert c["rank"] == h["rank"] == rank and c["world"] == world
        assert c["exchange"] == h["exchange"] == "dense"
        assert c["g"] == h["g"] == GOLD[name]["optimal_g"]
        assert c["alignment"] == h["alignment"] == GOLD[name]["alignment"]
        assert c["hash"] == h["hash"], f"rank {rank}: the drivers' words differ"
        assert c["steps"] == h["steps"] > chunk
        assert c["host_reads"] == -(-c["steps"] // chunk) and h["host_reads"] == h["steps"]
        assert c["walk_rounds"] == h["walk_rounds"] == h["walk_reads"]
        assert c["walk_reads"] == -(-c["walk_rounds"] // 32)


@pytest.mark.parametrize("driver", ["host", "chunked"])
def test_process_mesh_cpu_ragged(tmp_path, driver):
    """A ProcessMesh of 2 gloo ranks with the ragged exchange: a CPU rank
    maps no peer's wire, so the host driver sizes the exchange on its
    host (``ProcessMesh.all_to_all_ragged``) and reaches the golden g and
    alignment, one host read a step; the chunked driver raises ValueError
    there, with no fallback."""
    name = "PF08184.fasta"
    outs = run_ranks([sys.executable, os.path.join("tools", "process_mesh_turns.py"),
                      fasta(tmp_path, name), "--device", "cpu", "--chunk", "16",
                      "--drivers", driver, "--exchange", "ragged"])
    for rank, (rc, out) in enumerate(outs):
        if driver == "chunked":
            assert rc != 0 and "ValueError" in out and "maps no peer" in out, out[-3000:]
            continue
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}"
        r = rank_runs(out)["host"]
        assert (r["rank"], r["exchange"], r["g"]) == (rank, "ragged", GOLD[name]["optimal_g"])
        assert r["alignment"] == GOLD[name]["alignment"]
        assert r["host_reads"] == r["steps"] > 16 and r["wire_rows_a_step"] > 0


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
