"""Steady-state decomposition of the e2e count phase: run the production
pipeline once (warmup/compile), then re-run with fine timers around
extract_stream internals and the count dispatch. Run on the GPU."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from genome_tpu.runtime import enable_compile_cache
enable_compile_cache()


def main():
    from genome_tpu.assemble import pipeline as P
    from genome_tpu.assemble.metrics import Metrics
    from genome_tpu.io.benchdata import bench_workload
    from genome_tpu.params import AssemblyParams

    w = bench_workload(1.0)
    params = AssemblyParams(k=w["k"], min_coverage=2)

    print("warmup run_pipeline ...", flush=True)
    t0 = time.perf_counter()
    P.run_pipeline(w["err"], params, capacity=w["capacity"],
                   metrics=Metrics(quiet=True))
    print(f"warmup done in {time.perf_counter()-t0:.1f} s", flush=True)

    # instrument: wrap extract + count internals
    orig_codes = P._extract_stream_codes

    def timed_codes(codes, k, batch_reads, chunk_rows=1 << 21):
        t0 = time.perf_counter()
        r = orig_codes(codes, k, batch_reads, chunk_rows)
        jax.block_until_ready(r)
        print(f"  extract_stream_codes: {time.perf_counter()-t0:.3f} s",
              flush=True)
        return r

    P._extract_stream_codes = timed_codes

    from genome_tpu.kernels import count as C
    orig_count = C.count_kmers_device

    def timed_count(hi, lo, mc, cap, sorter=None):
        t0 = time.perf_counter()
        r = orig_count(hi, lo, mc, cap, sorter)
        jax.block_until_ready(r["counts"])
        print(f"  count_kmers_device(cap={cap}): {time.perf_counter()-t0:.3f}"
              f" s overflow={bool(r['overflow'])} n={int(r['n_unique'])}",
              flush=True)
        return r

    P.count_kmers_device = timed_count

    m = Metrics(quiet=True)
    t0 = time.perf_counter()
    res = P.run_pipeline(w["err"], params, capacity=w["capacity"], metrics=m)
    dt = time.perf_counter() - t0
    phases = {e["phase"]: round(e["wall_s"], 3) for e in m.events
              if e["event"] == "phase_end"}
    print(f"timed e2e: {dt:.2f} s phases={phases}", flush=True)


if __name__ == "__main__":
    main()
