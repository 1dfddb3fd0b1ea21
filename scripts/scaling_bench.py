"""Multi-host reads/s scaling table (efficiency at >= 2 hosts) — one command produces the table the moment hardware exists.

On a real slice: run `python -m genome_tpu.dist.launch ... --bench` once
with 1 host and once with N hosts (see dist/launch.py docstring) and feed
the two JSONL files to `--from-jsonl base.jsonl scaled.jsonl`.

Without hardware this script drives localhost fake clusters (P processes
x D virtual CPU devices each) to prove the plumbing end-to-end; the
efficiency numbers it prints are NOT meaningful (one machine oversubscribed
P ways) and are labeled as such.

Usage:
    python scripts/scaling_bench.py [--procs 1 2] [--cpu-devices 2]
    python scripts/scaling_bench.py --from-jsonl base.jsonl scaled.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_cluster(fq: str, out: str, num_procs: int, cpu_devices: int,
                k: int, bench_out: str) -> None:
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "genome_tpu.dist.launch", fq, "-o", out,
         "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(num_procs), "--process-id", str(pid),
         "--k", str(k), "--cpu-devices", str(cpu_devices),
         "--bench", "--bench-out", bench_out, "--forbid-replicated"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(num_procs)]
    for pr in procs:
        _, se = pr.communicate(timeout=1200)
        if pr.returncode != 0:
            raise RuntimeError(se.decode()[-2000:])


def total_rate(jsonl: str) -> tuple[float, dict]:
    """Aggregate reads/s for one run (max over processes of the total-rate
    field — every process reports the same allgathered totals)."""
    recs = [json.loads(l) for l in open(jsonl) if l.strip()]
    assert recs, jsonl
    rate = max(r["reads_per_sec_total"] for r in recs)
    return rate, recs[0]


def table(base_rate: float, rows: list[tuple[int, float]]) -> None:
    print(f"{'hosts':>6} {'reads/s':>12} {'speedup':>8} {'efficiency':>10}")
    for n, rate in rows:
        sp = rate / base_rate
        print(f"{n:>6} {rate:>12.1f} {sp:>8.2f} {sp / n:>9.1%}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--cpu-devices", type=int, default=2)
    ap.add_argument("--k", type=int, default=15)
    ap.add_argument("--genome", type=int, default=20000)
    ap.add_argument("--coverage", type=int, default=12)
    ap.add_argument("--from-jsonl", nargs="+", default=None,
                    help="skip running; aggregate existing bench JSONL "
                         "files (first = 1-host baseline)")
    ap.add_argument("--out-dir", default=None,
                    help="copy each bench_pN.jsonl here (per-round "
                         "committed artifact)")
    args = ap.parse_args()

    if args.from_jsonl:
        rates = [total_rate(p) for p in args.from_jsonl]
        base = rates[0][0]
        rows = [(max(1, r[1]["num_processes"]), r[0]) for r in rates]
        table(base, rows)
        return 0

    from genome_tpu.io import random_genome, simulate_reads
    tmp = tempfile.mkdtemp(prefix="scaling_bench_")
    fq = os.path.join(tmp, "reads.fastq")
    reads = simulate_reads(random_genome(args.genome, seed=9),
                           read_len=100, coverage=args.coverage,
                           error_rate=0.005, seed=10)
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    print(f"[scaling_bench] {len(reads)} reads, localhost fake clusters "
          f"(numbers prove plumbing, NOT scaling)", flush=True)

    rows = []
    base = None
    for np_ in args.procs:
        jl = os.path.join(tmp, f"bench_p{np_}.jsonl")
        out = os.path.join(tmp, f"contigs_p{np_}.fasta")
        run_cluster(fq, out, np_, args.cpu_devices, args.k, jl)
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            import shutil
            shutil.copy(jl, os.path.join(args.out_dir,
                                         f"bench_p{np_}.jsonl"))
        rate, _ = total_rate(jl)
        if base is None:
            base = rate
        rows.append((np_, rate))
        print(f"[scaling_bench] P={np_}: {rate:.1f} reads/s", flush=True)
    table(base, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
