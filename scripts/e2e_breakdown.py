"""Measure the e2e wall phase-by-phase on the real chip (round-3 diagnosis).

Mirrors bench.py's e2e workload exactly (E. coli scale, 0.2% error) and
times: count, build, each simplify pass, final_chain_state, emission split
into device->host transfer and host string assembly.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from genome_tpu.runtime import enable_compile_cache
enable_compile_cache()

from genome_tpu.graph.build import build_graph_device
from genome_tpu.graph.contigs import emit_contigs
from genome_tpu.graph.simplify import (clip_tips_pass, final_chain_state,
                                       pop_bubbles_pass)
from genome_tpu.kernels.count import count_kmers_device
from genome_tpu.kernels.extract import extract_canonical_kmers
from genome_tpu.params import AssemblyParams


def sync(x):
    jax.block_until_ready(jnp.asarray(x).sum() if hasattr(x, "sum") else x)


def main():
    scale = float(os.environ.get("BENCH_SCALE", "1.0"))
    k = 21
    genome_len = int(4_600_000 * scale)
    read_len = 100
    num_reads = int(genome_len * 24 / read_len)
    batch = 4096
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - read_len + 1, size=num_reads)
    capacity = 1 << max(13, int(np.ceil(np.log2(genome_len * 1.5))))
    num_padded = ((num_reads + batch - 1) // batch) * batch
    all_codes = np.full((num_padded, read_len), 4, dtype=np.uint8)
    all_codes[:num_reads] = genome[starts[:, None] + np.arange(read_len)[None, :]]
    codes_err = all_codes.copy()
    err = rng.random((num_reads, read_len)) < 0.002
    nerr = int(err.sum())
    codes_err[:num_reads][err] = (
        (all_codes[:num_reads][err] + rng.integers(1, 4, nerr, dtype=np.uint8)) % 4)

    params = AssemblyParams(k=k, min_coverage=2)

    @jax.jit
    def count_full(codes):
        his, los = extract_canonical_kmers(codes, k)
        r = count_kmers_device(his, los, 2, capacity)
        return (r["table_hi"], r["table_lo"], r["counts"], r["n_unique"],
                r["overflow"])

    build_jit = jax.jit(lambda a, b, m: build_graph_device(a, b, m, k))

    codes_dev = jnp.asarray(codes_err)

    def run(report):
        T = {}
        t0 = time.perf_counter()
        th, tl, cnts, n_uni, _ = count_full(codes_dev)
        n = int(n_uni)
        T["count"] = time.perf_counter() - t0
        step = max(256, 1 << max(0, n.bit_length() - 6))
        cap2 = min(capacity, -(-n // step) * step)
        th, tl, cnts = th[:cap2], tl[:cap2], cnts[:cap2]
        t0 = time.perf_counter()
        succ, okh, okl = build_jit(th, tl, n_uni)
        sync(succ[0, 0])
        T["build"] = time.perf_counter() - t0
        alive = jnp.ones((cap2,), dtype=jnp.bool_)
        valid = jnp.arange(cap2, dtype=jnp.int32) < n_uni
        tip_len = jnp.int32(params.tip_len_eff)
        bub_len = jnp.int32(params.bubble_len_eff)
        rounds = []
        for rnd in range(params.max_rounds):
            t0 = time.perf_counter()
            alive, c1 = clip_tips_pass(succ, okh, okl, cnts, alive, valid,
                                       tip_len, max_len=params.tip_len_eff)
            c1 = bool(c1)
            t1 = time.perf_counter()
            alive, c2 = pop_bubbles_pass(succ, okh, okl, cnts, alive, valid,
                                         bub_len, max_len=params.bubble_len_eff)
            c2 = bool(c2)
            t2 = time.perf_counter()
            rounds.append((round(t1 - t0, 3), round(t2 - t1, 3), c1, c2))
            if not (c1 or c2):
                break
        T["simplify_rounds"] = rounds
        T["simplify"] = sum(a + b for a, b, _, _ in rounds)
        t0 = time.perf_counter()
        fs = final_chain_state(succ, okh, okl, cnts, alive, valid)
        sync(fs["head"][0])
        T["final"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        from genome_tpu.graph.contigs import emit_contigs_device
        contigs = emit_contigs_device(fs, okh, okl, k, params.min_contig_len)
        T["emit_transfer"] = time.perf_counter() - t0
        T["emit_host"] = 0.0
        if report:
            total = (T["count"] + T["build"] + T["simplify"] + T["final"]
                     + T["emit_transfer"] + T["emit_host"])
            print(f"n_unique={n} cap2={cap2} contigs={len(contigs)} "
                  f"bp={sum(map(len, contigs))}")
            for kk in ("count", "build", "simplify", "final",
                       "emit_transfer", "emit_host"):
                print(f"  {kk:14s} {T[kk]:7.3f} s")
            print(f"  {'TOTAL':14s} {total:7.3f} s")
            print(f"  rounds: {rounds}")
        return contigs

    print("warmup (compiles)...", flush=True)
    run(report=False)
    print("timed run:", flush=True)
    run(report=True)


if __name__ == "__main__":
    main()
