"""Multi-process (jax.distributed) localhost fake-cluster test
(SURVEY.md §4.5b): 2 processes x 4 virtual CPU devices, contigs must be
identical to the golden single-host result."""

import os
import socket
import subprocess
import sys

import pytest

from genome_tpu.golden import assemble_golden
from genome_tpu.io import random_genome, read_fastx, simulate_reads
from genome_tpu.params import AssemblyParams


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_localhost_assembly(tmp_path):
    reads = simulate_reads(random_genome(600, seed=70), read_len=70,
                           coverage=10, error_rate=0.01, seed=71)
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    out = tmp_path / "contigs.fasta"
    port = _free_port()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + env.get("PYTHONPATH", "").split(os.pathsep))

    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "genome_tpu.dist.launch", str(fq),
             "-o", str(out), "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--k", "15", "--cpu-devices", "4", "--forbid-replicated"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    params = AssemblyParams(k=15)
    golden = assemble_golden(reads, params)
    assert read_fastx(out) == golden
    # the parallel writer (per-process slice build + sorted-shard merge,
    # dist/emit.py write_fasta_parallel) must be BYTE-identical to a
    # single-process write_fasta of the sorted contig set, and must
    # clean up its intermediate shard files
    from genome_tpu.io import write_fasta
    ref = tmp_path / "golden.fasta"
    write_fasta(ref, golden)
    assert out.read_bytes() == ref.read_bytes()
    assert not list(tmp_path.glob("contigs.fasta.shard*"))


@pytest.mark.slow
def test_kill_one_process_between_phases_resume(tmp_path):
    """SURVEY §5.3-§5.4 distributed: per-shard phase checkpoints + fault
    injection. Process 1 is hard-killed right after the build-phase
    artifacts are saved (GENOME_TPU_CRASH_AFTER), the surviving process
    is torn down (gang-scheduled SPMD job dies with it), and a restarted
    job with --resume loads count+build from the per-shard .npz files and
    produces byte-identical contigs to an uninterrupted run."""
    reads = simulate_reads(random_genome(600, seed=72), read_len=70,
                           coverage=10, error_rate=0.01, seed=73)
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    out = tmp_path / "contigs.fasta"
    ckdir = tmp_path / "ckpt"

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + env.get("PYTHONPATH", "").split(os.pathsep))

    def launch(extra_env, resume):
        port = _free_port()
        e = dict(env, **extra_env)
        args = [sys.executable, "-m", "genome_tpu.dist.launch", str(fq),
                "-o", str(out), "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "2", "--k", "15", "--cpu-devices", "4",
                "--forbid-replicated", "--checkpoint-dir", str(ckdir)]
        if resume:
            args.append("--resume")
        return [subprocess.Popen(args + ["--process-id", str(pid)],
                                 env=e, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
                for pid in range(2)]

    # run 1: process 1 crashes after saving its build shard
    procs = launch({"GENOME_TPU_CRASH_AFTER": "dist_build:1"}, resume=False)
    _, se1 = procs[1].communicate(timeout=600)
    assert procs[1].returncode == 7, se1.decode()[-2000:]
    assert b"injected crash" in se1
    # failure detector analog: tear down the survivor, job is dead
    procs[0].kill()
    procs[0].communicate()

    # both processes saved count+build shards before the crash
    for phase in ("dist_count", "dist_build"):
        for shard in (0, 1):
            assert (ckdir / f"{phase}.shard{shard}.npz").exists()

    # run 2: restart from checkpoints
    procs = launch({}, resume=True)
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    resumed = read_fastx(out)

    assert resumed == assemble_golden(reads, AssemblyParams(k=15))


@pytest.mark.slow
def test_resume_rejects_modified_input(tmp_path):
    """End-to-end: checkpoints saved for input A must NOT be
    resumed against modified input B (the manifest pins an input-stream
    digest); the restarted job recomputes and produces B's contigs."""
    genome = random_genome(600, seed=80)
    reads_a = simulate_reads(genome, read_len=70, coverage=10,
                             error_rate=0.0, seed=81)
    # B: same read count/shapes, one read replaced by its mutant
    reads_b = list(reads_a)
    reads_b[3] = ("T" if reads_b[3][0] != "T" else "A") + reads_b[3][1:]

    fq = tmp_path / "reads.fastq"
    out = tmp_path / "contigs.fasta"
    ckdir = tmp_path / "ckpt"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + env.get("PYTHONPATH", "").split(os.pathsep))

    def write_fq(reads):
        with open(fq, "w") as f:
            for i, r in enumerate(reads):
                f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")

    def run(resume):
        port = _free_port()
        args = [sys.executable, "-m", "genome_tpu.dist.launch", str(fq),
                "-o", str(out), "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "2", "--k", "15", "--cpu-devices", "4",
                "--forbid-replicated", "--checkpoint-dir", str(ckdir)]
        if resume:
            args.append("--resume")
        procs = [subprocess.Popen(args + ["--process-id", str(pid)],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE)
                 for pid in range(2)]
        for p in procs:
            _, se = p.communicate(timeout=600)
            assert p.returncode == 0, se.decode()[-2000:]

    write_fq(reads_a)
    run(resume=False)  # checkpoints now hold A's artifacts
    write_fq(reads_b)
    run(resume=True)   # must reject A's checkpoints and recompute
    assert read_fastx(out) == assemble_golden(reads_b, AssemblyParams(k=15))
