"""Multi-process SPMD worker/launcher for partitioned assembly.

Worker (one per host/process):

    python -m genome_tpu.dist.launch --coordinator host0:12355 \
        --num-processes 2 --process-id 0 reads.fastq -o contigs.fasta

Each process reads the SAME input file and takes its own contiguous read
shard (process_id-th of num_processes); process 0 writes the output.
For the localhost fake-cluster CI pattern (SURVEY §4.5), run every
process on one machine with JAX_PLATFORMS=cpu. Several processes on one
GPU host each open their own card: `--local-device-ids <process_id>`
(a JAX process reserves most of a card's memory, so two processes cannot
share one).

Scaling bench (reads/s efficiency at >= 2 hosts): add
`--bench --bench-out scaling.jsonl`. Each process then assembles twice
(first run pays compile; the second is timed), and every process appends
one JSON line: reads/s for its shard, aggregate reads/s, per-phase wall
seconds. Run once with 1 host and once with N hosts; efficiency =
reads_per_sec_total(N) / (N * reads_per_sec_total(1)). On one machine,
`python scripts/scaling_bench.py` drives the whole table on a localhost
fake cluster (plumbing proof; real numbers need real hosts).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from genome_tpu.runtime import enable_compile_cache, parse_device_ids


def _load_local_shard(paths, pid: int, num_processes: int):
    """Decode only this process's contiguous record shard (uint8 codes).

    Same split as dist.assemble.shard_reads (per = ceil(total/P), shard
    i = records [i*per, (i+1)*per)), but each process range-reads its
    slice via the native parser's record index instead of parsing the
    whole input and keeping 1/P of it — ingest cost stays ~flat in P.
    """
    import numpy as np
    from genome_tpu.io.native import count_fastx_records, parse_fastx_codes

    counts = [count_fastx_records(p) for p in paths]
    total = sum(counts)
    per = (total + num_processes - 1) // num_processes
    lo, hi = pid * per, min(total, (pid + 1) * per)
    mats = []
    base = 0
    for p, c in zip(paths, counts):
        a, b = max(lo - base, 0), min(hi - base, c)
        if b > a:
            mats.append(parse_fastx_codes(p, record_range=(a, b)))
        base += c
    if not mats:
        return np.zeros((0, 1), dtype=np.uint8)
    L = max(m.shape[1] for m in mats)
    out = np.full((sum(m.shape[0] for m in mats), L), 4, dtype=np.uint8)
    at = 0
    for m in mats:
        out[at : at + m.shape[0], : m.shape[1]] = m
        at += m.shape[0]
    return out


def _device_ids(text: str) -> list[int]:
    try:
        return parse_device_ids(text)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="genome_tpu.dist.launch")
    p.add_argument("reads", nargs="+")
    p.add_argument("-o", "--output", default="contigs.fasta")
    p.add_argument("--coordinator", default="localhost:12355")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--k", type=int, default=21)
    p.add_argument("--min-coverage", type=int, default=2)
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="force N virtual CPU devices (testing)")
    p.add_argument("--local-device-ids", type=_device_ids, default=None,
                   help="comma-separated local GPU ids this process opens "
                        "(e.g. its process id when each process on a host "
                        "takes one card; default: every local card)")
    p.add_argument("--bench", action="store_true",
                   help="time a second (compile-warm) assembly and emit "
                        "a reads/s JSON line per process")
    p.add_argument("--bench-out", default="",
                   help="append bench JSON lines here (default stderr)")
    p.add_argument("--forbid-replicated", action="store_true",
                   help="fail instead of falling back to the replicated "
                        "simplify path (CI guard)")
    p.add_argument("--checkpoint-dir", default="",
                   help="save per-process phase artifacts (.npz per "
                        "shard) here after count/build/simplify")
    p.add_argument("--resume", action="store_true",
                   help="skip phases whose per-process artifacts all "
                        "match (params hash + shard count + content "
                        "hash); requires --checkpoint-dir")
    args = p.parse_args(argv)

    if args.cpu_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{args.cpu_devices}").strip()
        os.environ["JAX_PLATFORMS"] = "cpu"

    from genome_tpu.dist.multihost import assemble_multihost, initialize
    import jax
    if args.cpu_devices:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    initialize(args.coordinator, args.num_processes, args.process_id,
               local_device_ids=args.local_device_ids)

    from genome_tpu.params import AssemblyParams

    t_ing = time.perf_counter()
    local = _load_local_shard(args.reads, args.process_id,
                              args.num_processes)
    ingest_s = time.perf_counter() - t_ing
    params = AssemblyParams(k=args.k, min_coverage=args.min_coverage)
    ckpt = None
    if args.checkpoint_dir:
        from genome_tpu.assemble.checkpoint import (PhaseCheckpointer,
                                                    input_digest)
        # pin total device count (owner hashing is per DEVICE, not per
        # process) and the local read-shard digest so resume under a
        # different topology or modified input is rejected
        ckpt = PhaseCheckpointer(args.checkpoint_dir, params,
                                 shard=args.process_id,
                                 num_shards=args.num_processes,
                                 load_enabled=args.resume,
                                 n_devices=len(jax.devices()),
                                 input_digest=input_digest(local))
    # output is written INSIDE assemble_multihost (out_path mode): on the
    # sharded path every process builds + writes its 1/P contig slice
    # and process 0 streams the sorted merge (write_fasta_parallel)
    n_contigs = assemble_multihost(
        local, params, forbid_replicated=args.forbid_replicated,
        ckpt=ckpt, out_path=args.output)

    if args.bench:
        # second, compile-warm run is the measured one (same SPMD program;
        # every process re-enters together so collectives stay matched)
        from jax.experimental import multihost_utils
        import jax.numpy as jnp
        phases: dict = {}
        multihost_utils.process_allgather(jnp.zeros((1,)))  # barrier
        t0 = time.perf_counter()
        n_contigs = assemble_multihost(
            local, params, forbid_replicated=args.forbid_replicated,
            phase_times=phases, out_path=args.output)
        wall = time.perf_counter() - t0
        n_total = int(multihost_utils.process_allgather(
            jnp.asarray([len(local)])).sum())
        ledger = phases.pop("exchange_ledger", None)
        rec = {
            "metric": "reads_per_sec",
            "process_id": args.process_id,
            "num_processes": args.num_processes,
            "local_reads": len(local),
            "wall_s": round(wall, 3),
            "ingest_s": round(ingest_s, 3),
            "reads_per_sec_local": round(len(local) / wall, 1),
            "reads_per_sec_total": round(n_total / wall, 1),
            "phases_s": {k2: round(v, 3) for k2, v in phases.items()},
            "n_contigs": n_contigs,
            "exchange_ledger": ledger,
        }
        line = json.dumps(rec)
        if args.bench_out:
            with open(args.bench_out, "a") as f:
                f.write(line + "\n")
        else:
            print(line, file=sys.stderr)

    if args.process_id == 0:
        print(f"[genome_tpu.dist] wrote {n_contigs} contigs to "
              f"{args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
