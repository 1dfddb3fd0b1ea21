"""CLI driver (reference analog: the Scala `main`, SURVEY.md §2.1 R11).

    python -m genome_tpu.assemble.cli reads.fastq [more.fastq ...] \
        -o contigs.fasta --k 21 --min-coverage 2 [--backend device|golden] \
        [--checkpoint-dir ck/ --resume] [--metrics run.jsonl] [--profile dir/]
"""

from __future__ import annotations

import argparse
import sys

from genome_tpu.assemble.checkpoint import PhaseCheckpointer
from genome_tpu.assemble.metrics import Metrics
from genome_tpu.io import read_fastx, write_fasta
from genome_tpu.params import AssemblyParams


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="genome_tpu",
        description="de novo genome assembler (winger/genome capability "
                    "set, built on JAX/XLA)")
    p.add_argument("reads", nargs="+", help="FASTA/FASTQ input file(s), .gz ok")
    p.add_argument("-o", "--output", default="contigs.fasta",
                   help="output FASTA path (default: %(default)s; .gz ok)")
    p.add_argument("--fai", action="store_true",
                   help="also write a samtools-style .fai index")
    p.add_argument("--k", type=int, default=21, help="k-mer length (odd, <=31)")
    p.add_argument("--min-coverage", type=int, default=2,
                   help="k-mer count threshold (default: %(default)s)")
    p.add_argument("--tip-len", type=int, default=None,
                   help="max tip chain length in nodes (default: 2k)")
    p.add_argument("--bubble-len", type=int, default=None,
                   help="max bubble side length in nodes (default: 2k+1)")
    p.add_argument("--min-contig-len", type=int, default=0,
                   help="drop contigs shorter than this many bases")
    p.add_argument("--max-rounds", type=int, default=64,
                   help="simplification round bound")
    p.add_argument("--capacity", type=int, default=None,
                   help="k-mer table capacity (default: auto with retry)")
    p.add_argument("--max-device-kmers", type=int, default=None,
                   help="stream counting in chunks of this many windows "
                        "(bounds device memory; default: one shot)")
    p.add_argument("--counter",
                   choices=["sort", "bucket", "hashtable"],
                   default="sort",
                   help="counting engine: global sort + run-length "
                        "encoding (default), bucket-partition sort, or a "
                        "batched open-addressing hash table in device "
                        "memory")
    p.add_argument("--backend", choices=["device", "golden"], default="device",
                   help="device = JAX pipeline, golden = NumPy reference")
    p.add_argument("--io", choices=["native", "python"], default="native",
                   help="input parser: native C++ fast path (if built) or "
                        "pure Python (golden backend always uses python)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for phase-boundary checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="reuse matching phase checkpoints (requires "
                        "--checkpoint-dir)")
    p.add_argument("--metrics", default=None, help="JSONL metrics output path")
    p.add_argument("--profile", default=None,
                   help="dump a jax.profiler trace to this directory")
    p.add_argument("--quiet", action="store_true", help="suppress progress log")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        params = AssemblyParams(
            k=args.k, min_coverage=args.min_coverage, tip_len=args.tip_len,
            bubble_len=args.bubble_len, max_rounds=args.max_rounds,
            min_contig_len=args.min_contig_len)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    import time as _time

    metrics = Metrics(path=args.metrics, quiet=args.quiet)
    use_native = args.io == "native" and args.backend == "device"
    if args.backend == "device":
        from genome_tpu.runtime import enable_compile_cache
        enable_compile_cache()
    t0 = _time.perf_counter()
    try:
        if use_native:
            import numpy as np
            from genome_tpu.io.native import (native_available,
                                              parse_fastx_codes)
            use_native = native_available()
            mats = [parse_fastx_codes(p) for p in args.reads]
            L = max((m.shape[1] for m in mats), default=0)
            rows = sum(m.shape[0] for m in mats)
            reads = np.full((rows, L), 4, dtype=np.uint8)
            at = 0
            for m in mats:
                reads[at : at + m.shape[0], : m.shape[1]] = m
                at += m.shape[0]
            n_reads, total_bp = rows, int((reads < 4).sum())
        else:
            reads = []
            for path in args.reads:
                reads.extend(read_fastx(path))
            n_reads, total_bp = len(reads), sum(map(len, reads))
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    metrics.log("phase_end", phase="read_input",
                wall_s=round(_time.perf_counter() - t0, 4),
                n_reads=n_reads, total_bp=total_bp, native=use_native)

    if args.resume and not args.checkpoint_dir:
        print("error: --resume requires --checkpoint-dir", file=sys.stderr)
        return 2

    if args.backend == "golden":
        from genome_tpu.golden import assemble_golden
        with metrics.phase("assemble_golden") as info:
            contigs = assemble_golden(reads, params)
            info["n_contigs"] = len(contigs)
    else:
        from genome_tpu.assemble.pipeline import run_pipeline
        # without --resume, checkpoints are written but never read back.
        # The manifest pins the device topology and an input digest so a
        # resume against a changed mesh or modified reads is rejected
        # instead of silently producing wrong contigs.
        ndev = digest = None
        if args.checkpoint_dir:
            import jax
            from genome_tpu.assemble.checkpoint import input_digest
            ndev = len(jax.devices())
            digest = input_digest(reads)
        ckpt = PhaseCheckpointer(args.checkpoint_dir, params,
                                 load_enabled=args.resume,
                                 n_devices=ndev, input_digest=digest)
        result = run_pipeline(reads, params, capacity=args.capacity,
                              metrics=metrics, ckpt=ckpt,
                              profile_dir=args.profile,
                              max_device_kmers=args.max_device_kmers,
                              counter=args.counter)
        contigs = result["contigs"]

    write_fasta(args.output, contigs, index=args.fai)
    from genome_tpu.assemble.stats import assembly_stats
    metrics.log("done", output=args.output,
                params_hash=params.params_hash(), **assembly_stats(contigs))
    metrics.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
