"""Smoke run of the assembler on NVIDIA GPUs, through its normal entry points.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the sharded path on four cards

One card, in order:
  a. the cards' name and power limit (nvidia-smi); the `gpu`-marked tests
     in a child process, before this process opens the card (a JAX process
     reserves most of a card's memory, so only one may hold it); then JAX's
     platform must be "gpu";
  b. the CLI (`genome_tpu.assemble.cli.main`, default `--counter sort
     --io native`) on the E. coli-scale legacy and repeat workloads of
     io/benchdata.py written as FASTQ, each run cold and then warm; the
     contigs' SHA-256 must equal the cached golden digest
     (bench_golden_cache.json). Per-phase walls are printed: they are
     smoke timings, not benchmark results;
  c. the bucket and hashtable counting engines through run_pipeline at
     200 kbp, 30x, compared with assemble_golden in this process;
  d. the last line of standard output, one JSON object:
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

--four-cards runs only the path across cards and its comparison: the
launcher (genome_tpu.dist.launch) as 4 processes on this host, one card
each, then assemble_sharded over a flat 4-card ("shard",) mesh in this
process, both on the legacy E. coli-scale workload against the golden
digest.

Any failure exits non-zero before the last line is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_CACHE = os.path.join(REPO, "bench_golden_cache.json")
GPU_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]

ONE_CARD_PHASES = ("gpu_tests", "cli_legacy", "cli_repeat", "counters")
FOUR_CARD_PHASES = ("launcher_4proc", "sharded_4card")


class SmokeError(RuntimeError):
    pass


def parse_gpu_query(text: str) -> list[tuple[str, str]]:
    """nvidia-smi `name,power.limit` csv -> [(name, power_limit)]."""
    cards = []
    for line in text.splitlines():
        if not line.strip():
            continue
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip() or not limit.strip():
            raise SmokeError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    if not cards:
        raise SmokeError("nvidia-smi lists no GPU")
    return cards


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def phases_for(four_cards: bool) -> tuple[str, ...]:
    return FOUR_CARD_PHASES if four_cards else ONE_CARD_PHASES


def require_gpu(devices, count: int) -> None:
    """The run measures the card: any other platform is a failure."""
    if not devices:
        raise SmokeError("JAX finds no device")
    platform = devices[0].platform
    if platform != "gpu":
        raise SmokeError(f"JAX platform is {platform!r}, not 'gpu'")
    if len(devices) < count:
        raise SmokeError(f"need {count} GPUs, JAX finds {len(devices)}")


def query_cards() -> list[tuple[str, str]]:
    try:
        out = subprocess.run(GPU_QUERY, capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise SmokeError(f"nvidia-smi failed: {e}") from None
    return parse_gpu_query(out)


def _golden_digest(w, params) -> str:
    from genome_tpu.io.benchdata import workload_key
    with open(GOLDEN_CACHE) as f:
        cache = json.load(f)
    key = workload_key(w, params.params_hash())
    if key not in cache:
        raise SmokeError(f"no cached golden digest for workload {key}")
    return cache[key]


def _write_fastq(path: str, codes, num_reads: int) -> None:
    import numpy as np
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    seqs = lut[codes[:num_reads]]
    qual = b"I" * seqs.shape[1]
    with open(path, "wb") as f:
        for i, row in enumerate(seqs):
            f.write(b"@r%d\n%b\n+\n%b\n" % (i, row.tobytes(), qual))


def _contigs_sha(path: str) -> tuple[str, int]:
    from genome_tpu.io import read_fastx
    from genome_tpu.io.benchdata import contigs_sha
    contigs = read_fastx(path)
    return contigs_sha(contigs), len(contigs)


def _workload(repeats: bool):
    from genome_tpu.io.benchdata import bench_workload
    from genome_tpu.params import AssemblyParams
    w = bench_workload(1.0, repeats=repeats)
    params = AssemblyParams(k=w["k"], min_coverage=2)
    return w, params, _golden_digest(w, params)


def phase_gpu_tests() -> None:
    """`python -m pytest tests -m gpu` in a child; every test must pass."""
    with tempfile.TemporaryDirectory() as td:
        xml = os.path.join(td, "gpu.xml")
        cmd = [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
               "-p", "no:cacheprovider", f"--junitxml={xml}"]
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=900)
        tail = proc.stdout.strip().splitlines()[-1:] or ["(no output)"]
        print(f"[gpu_tests] rc={proc.returncode} {tail[0]}", flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SmokeError("gpu-marked tests failed")
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
        n = {k: int(suite.get(k, 0))
             for k in ("tests", "failures", "errors", "skipped")}
        if n["tests"] == 0 or n["failures"] or n["errors"] or n["skipped"]:
            raise SmokeError(f"gpu-marked tests did not all pass: {n}")


def phase_cli(tmp: str, repeats: bool) -> None:
    """The CLI on one E. coli-scale workload, cold then warm."""
    from genome_tpu.assemble import cli
    name = "repeat" if repeats else "legacy"
    w, params, want = _workload(repeats)
    fq = os.path.join(tmp, f"{name}.fastq")
    _write_fastq(fq, w["err"], w["num_reads"])
    for run in ("cold", "warm"):
        out = os.path.join(tmp, f"{name}_{run}.fasta")
        mpath = os.path.join(tmp, f"{name}_{run}.jsonl")
        t0 = time.perf_counter()
        rc = cli.main([fq, "-o", out, "--metrics", mpath, "--quiet",
                       "--k", str(params.k),
                       "--min-coverage", str(params.min_coverage)])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SmokeError(f"cli on {name} exited {rc}")
        sha, n_contigs = _contigs_sha(out)
        with open(mpath) as f:
            ends = {e["phase"]: e for e in map(json.loads, f)
                    if e["event"] == "phase_end"}
        count, contigs = ends["count"], ends["contigs"]
        print(f"[cli_{name}] {run}: wall_s={wall:.3f} "
              f"read_input_s={ends['read_input']['wall_s']} "
              f"native_parser={ends['read_input']['native']} "
              f"count_s={count['wall_s']} build_s={ends['build']['wall_s']} "
              f"simplify_s={ends['simplify']['wall_s']} "
              f"contigs_s={contigs['wall_s']} final_s={contigs['final_s']} "
              f"emit_s={contigs['emit_s']} n_windows={count['n_windows']} "
              f"n_unique={count['n_unique']} n_contigs={n_contigs} "
              f"sha={sha[:16]} golden={want[:16]}", flush=True)
        if sha != want:
            raise SmokeError(f"{name} contigs differ from golden")


def phase_counters() -> None:
    """bucket and hashtable engines vs golden at 200 kbp, 30x."""
    from genome_tpu.assemble.pipeline import run_pipeline
    from genome_tpu.golden import assemble_golden
    from genome_tpu.io import random_genome, simulate_reads
    from genome_tpu.params import AssemblyParams
    reads = simulate_reads(random_genome(200_000, seed=5), read_len=100,
                           coverage=30, error_rate=0.002, seed=6)
    params = AssemblyParams(k=21, min_coverage=2)
    want = assemble_golden(reads, params)
    for counter in ("bucket", "hashtable"):
        for run in ("cold", "warm"):
            t0 = time.perf_counter()
            got = run_pipeline(reads, params, counter=counter)["contigs"]
            wall = time.perf_counter() - t0
            print(f"[counters] {counter} {run}: wall_s={wall:.3f} "
                  f"n_contigs={len(got)} golden_contigs={len(want)} "
                  f"match={got == want}", flush=True)
            if got != want:
                raise SmokeError(f"--counter {counter} differs from golden")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_launcher(tmp: str, n: int = 4) -> None:
    """dist/launch.py as n processes on this host, one card each."""
    w, params, want = _workload(False)
    fq = os.path.join(tmp, "legacy.fastq")
    _write_fastq(fq, w["err"], w["num_reads"])
    out = os.path.join(tmp, "launcher.fasta")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    t0 = time.perf_counter()
    try:
        for pid in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "genome_tpu.dist.launch", fq,
                 "-o", out, "--coordinator", f"localhost:{port}",
                 "--num-processes", str(n), "--process-id", str(pid),
                 "--local-device-ids", str(pid), "--k", str(params.k),
                 "--min-coverage", str(params.min_coverage)],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE))
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(err.decode(errors="replace")[-4000:], file=sys.stderr)
            raise SmokeError(f"launcher process {pid} exited {p.returncode}")
    sha, n_contigs = _contigs_sha(out)
    print(f"[launcher_{n}proc] wall_s={wall:.3f} (ingest and compile "
          f"included) n_contigs={n_contigs} sha={sha[:16]} "
          f"golden={want[:16]}", flush=True)
    if sha != want:
        raise SmokeError("launcher contigs differ from golden")


def phase_sharded(n: int = 4) -> None:
    """assemble_sharded over a flat n-card mesh, in this process."""
    from genome_tpu.dist import assemble_sharded
    from genome_tpu.io.benchdata import codes_to_reads, contigs_sha
    w, params, want = _workload(False)
    reads = codes_to_reads(w["err"], w["num_reads"])
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        contigs = assemble_sharded(reads, params, num_shards=n)
        wall = time.perf_counter() - t0
        sha = contigs_sha(contigs)
        print(f"[sharded_{n}card] {run}: wall_s={wall:.3f} "
              f"n_contigs={len(contigs)} sha={sha[:16]} golden={want[:16]}",
              flush=True)
        if sha != want:
            raise SmokeError("sharded contigs differ from golden")


def run(four_cards: bool) -> str:
    """Every phase in order; returns the result line."""
    from genome_tpu.runtime import enable_compile_cache
    n_cards = 4 if four_cards else 1
    cards = query_cards()
    for name, limit in cards:
        print(f"card: {name}, {limit}", flush=True)
    if len(cards) < n_cards:
        raise SmokeError(f"need {n_cards} GPUs, nvidia-smi lists {len(cards)}")
    print(f"phases: {', '.join(phases_for(four_cards))}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        # children that open cards run before this process opens any
        if four_cards:
            phase_launcher(tmp, n_cards)
        else:
            phase_gpu_tests()
        print(f"compile cache: {enable_compile_cache()}", flush=True)
        import jax
        devices = jax.devices()
        require_gpu(devices, n_cards)
        if four_cards:
            phase_sharded(n_cards)
        else:
            phase_cli(tmp, repeats=False)
            phase_cli(tmp, repeats=True)
            phase_counters()
    return result_line(devices[0].platform, devices[0].device_kind,
                       len(devices))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path and the 4-process "
                         "launcher, on four cards")
    args = ap.parse_args(argv)
    try:
        line = run(args.four_cards)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
