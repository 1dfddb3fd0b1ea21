"""Aux subsystem tests: CLI, fault injection / resume, determinism CI
(SURVEY.md §5.2-§5.4, §4.6)."""

import json
import os

import numpy as np
import pytest

from genome_tpu.assemble import cli
from genome_tpu.io import random_genome, simulate_reads, read_fastx


@pytest.fixture()
def fastq(tmp_path):
    reads = simulate_reads(random_genome(600, seed=50), read_len=70,
                           coverage=12, error_rate=0.01, seed=51)
    p = tmp_path / "reads.fastq"
    with open(p, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return p


def _run(args):
    return cli.main([str(a) for a in args])


def test_cli_native_vs_python_io_identical(fastq, tmp_path):
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    assert _run([fastq, "-o", a, "--k", "15", "--io", "native", "--quiet"]) == 0
    assert _run([fastq, "-o", b, "--k", "15", "--io", "python", "--quiet"]) == 0
    assert read_fastx(a) == read_fastx(b)
    assert len(read_fastx(a)) > 0


def test_cli_device_vs_golden_identical(fastq, tmp_path):
    a, b = tmp_path / "a.fasta", tmp_path / "g.fasta"
    assert _run([fastq, "-o", a, "--k", "15", "--quiet"]) == 0
    assert _run([fastq, "-o", b, "--k", "15", "--backend", "golden",
                 "--quiet"]) == 0
    assert read_fastx(a) == read_fastx(b)


def test_cli_metrics_jsonl(fastq, tmp_path):
    m = tmp_path / "m.jsonl"
    assert _run([fastq, "-o", tmp_path / "o.fasta", "--k", "15",
                 "--metrics", m, "--quiet"]) == 0
    events = [json.loads(line) for line in open(m)]
    phases = {e.get("phase") for e in events if e["event"] == "phase_end"}
    assert {"read_input", "count", "build", "simplify", "contigs"} <= phases
    done = [e for e in events if e["event"] == "done"]
    assert done and done[0]["n_contigs"] > 0


def test_determinism_same_input_twice(fastq, tmp_path):
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    assert _run([fastq, "-o", a, "--quiet"]) == 0
    assert _run([fastq, "-o", b, "--quiet"]) == 0
    assert open(a).read() == open(b).read()


def test_crash_between_phases_resume(fastq, tmp_path):
    """Fault injection: job dies after counting; restart reuses the count
    checkpoint and completes identically (SURVEY §5.3)."""
    from genome_tpu.assemble.checkpoint import PhaseCheckpointer
    from genome_tpu.assemble.pipeline import count_reads, run_pipeline
    from genome_tpu.params import AssemblyParams

    reads = read_fastx(fastq)
    params = AssemblyParams(k=15)
    ck = tmp_path / "ck"

    # "crashed" job: only the count phase completed
    ckpt = PhaseCheckpointer(str(ck), params)
    res = count_reads(reads, params)
    ckpt.save("count", table_hi=res["table_hi"], table_lo=res["table_lo"],
              counts=res["counts"], n_unique=int(res["n_unique"]),
              n_windows=res["n_windows"])

    out = run_pipeline(reads, params, ckpt=PhaseCheckpointer(str(ck), params))
    full = run_pipeline(reads, params)
    assert out["contigs"] == full["contigs"]


def test_corrupted_checkpoint_recomputed(fastq, tmp_path):
    from genome_tpu.assemble.checkpoint import PhaseCheckpointer
    from genome_tpu.assemble.pipeline import run_pipeline
    from genome_tpu.params import AssemblyParams

    reads = read_fastx(fastq)
    params = AssemblyParams(k=15)
    ck = tmp_path / "ck"
    base = run_pipeline(reads, params, ckpt=PhaseCheckpointer(str(ck), params))
    # corrupt the simplify artifact in place
    target = ck / "simplify.shard0.npz"
    data = target.read_bytes()
    target.write_bytes(data[: len(data) // 2])
    again = run_pipeline(reads, params, ckpt=PhaseCheckpointer(str(ck), params))
    assert again["contigs"] == base["contigs"]


def test_checkpoint_ignored_on_shard_count_change(fastq, tmp_path):
    from genome_tpu.assemble.checkpoint import PhaseCheckpointer
    from genome_tpu.params import AssemblyParams
    params = AssemblyParams(k=15)
    a = PhaseCheckpointer(str(tmp_path / "ck"), params, shard=0, num_shards=1)
    a.save("count", x=np.arange(4))
    b = PhaseCheckpointer(str(tmp_path / "ck"), params, shard=0, num_shards=2)
    assert b.load("count") is None
    assert a.load("count") is not None


def test_checkpoint_ignored_on_topology_or_input_change(tmp_path):
    """Resume must reject a changed device topology (owner
    hashing is per device) or a modified input read stream, both of which
    pass the params/num_shards checks."""
    from genome_tpu.assemble.checkpoint import PhaseCheckpointer, input_digest
    from genome_tpu.params import AssemblyParams
    params = AssemblyParams(k=15)
    reads_a = ["ACGTACGTACGTACGTAC", "TTTTGGGGCCCCAAAATT"]
    reads_b = ["ACGTACGTACGTACGTAC", "TTTTGGGGCCCCAAAATA"]  # one base off
    a = PhaseCheckpointer(str(tmp_path / "ck"), params, n_devices=8,
                          input_digest=input_digest(reads_a))
    a.save("count", x=np.arange(4))
    assert a.load("count") is not None
    # different total device count, same process count -> reject
    b = PhaseCheckpointer(str(tmp_path / "ck"), params, n_devices=4,
                          input_digest=input_digest(reads_a))
    assert b.load("count") is None
    # modified input reads -> reject
    c = PhaseCheckpointer(str(tmp_path / "ck"), params, n_devices=8,
                          input_digest=input_digest(reads_b))
    assert c.load("count") is None
    # code-matrix and string digests are both deterministic
    m = np.array([[0, 1, 2, 3]], dtype=np.uint8)
    assert input_digest(m) == input_digest(m.copy())
    assert input_digest(reads_a) != input_digest(reads_b)


def test_assembly_stats():
    from genome_tpu.assemble.stats import assembly_stats
    assert assembly_stats([]) == {"n_contigs": 0, "total_bp": 0, "longest": 0,
                                  "n50": 0, "l50": 0, "mean_len": 0}
    s = assembly_stats(["A" * 100, "A" * 50, "A" * 30])
    assert s["n_contigs"] == 3 and s["total_bp"] == 180
    assert s["longest"] == 100 and s["n50"] == 100 and s["l50"] == 1
    s = assembly_stats(["A" * 60, "A" * 50, "A" * 40, "A" * 30])
    assert s["n50"] == 50 and s["l50"] == 2


def test_streaming_with_bucket_counter_matches(fastq, tmp_path):
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    assert _run([fastq, "-o", a, "--k", "15", "--counter", "bucket",
                 "--max-device-kmers", "2000", "--quiet"]) == 0
    assert _run([fastq, "-o", b, "--k", "15", "--quiet"]) == 0
    assert read_fastx(a) == read_fastx(b)


def test_write_fasta_gz_and_fai(tmp_path):
    from genome_tpu.io import read_fastx, write_fasta
    seqs = ["ACGT" * 30, "GGCA" * 7, "T" * 3]
    plain = tmp_path / "o.fasta"
    gz = tmp_path / "o.fasta.gz"
    write_fasta(plain, seqs, index=True)
    write_fasta(gz, seqs)
    assert read_fastx(plain) == seqs == read_fastx(gz)
    data = open(plain, "rb").read()
    lines = open(str(plain) + ".fai").read().splitlines()
    assert len(lines) == len(seqs)
    for line, s in zip(lines, seqs):
        name, ln, off, bl, byl = line.split("\t")
        assert int(ln) == len(s) and int(bl) == 80 and int(byl) == 81
        raw = data[int(off): int(off) + int(ln) + int(ln) // 80 + 1]
        assert raw.replace(b"\n", b"")[: int(ln)].decode() == s


def test_fixtures_cli(tmp_path):
    """Fixture generator CLI: deterministic FASTQ + truth FASTA with the
    realism knobs (repeats, het) — the reference's shipped-test-read-set
    analog (SURVEY §4)."""
    from genome_tpu.io import read_fastx
    from genome_tpu.io.fixtures import main

    fq, fa = tmp_path / "r.fastq", tmp_path / "g.fasta"
    main(["-o", str(fq), "--genome-len", "3000", "--coverage", "8",
          "--repeats", "--het", "0.002", "--truth", str(fa),
          "--seed", "3"])
    reads = read_fastx(str(fq))
    assert len(reads) == 240  # 2 haplotypes x ceil(4 * 3000 / 100)
    truth = read_fastx(str(fa))
    assert len(truth) == 1 and len(truth[0]) == 3000
    fq2 = tmp_path / "r2.fastq"
    main(["-o", str(fq2), "--genome-len", "3000", "--coverage", "8",
          "--repeats", "--het", "0.002", "--seed", "3"])
    assert read_fastx(str(fq2)) == reads
