"""Compare ruler-ranking variants for final_chain_state at bench scale on
the real graph (count -> build -> simplify first). Run on the GPU.

Times (with REAL scalar-forced syncs):
  A. _rank_rulers (while_loop, production)
  B. _rank_rulers_unrolled (fixed-round unrolled)
  C. emit_contigs_device total (host decode included)
and checks B's (head, dist) == A's on the alive set.
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


def timeit(label, f, reps=3):
    f()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        f()
        ts.append(time.perf_counter() - t0)
    print(f"{label}: {min(ts)*1e3:.0f} ms", flush=True)


def main():
    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    from genome_tpu.assemble.metrics import Metrics
    from genome_tpu.assemble.pipeline import count_reads, simplify_with_metrics
    from genome_tpu.graph.build import build_graph_device
    from genome_tpu.graph import simplify as S
    from genome_tpu.graph.contigs import emit_contigs_device
    from genome_tpu.io.benchdata import bench_workload
    from genome_tpu.params import AssemblyParams

    w = bench_workload(scale)
    k = w["k"]
    params = AssemblyParams(k=k, min_coverage=2)
    res = count_reads(w["err"], params, w["capacity"])
    n = int(res["n_unique"])
    step = max(256, 1 << max(0, n.bit_length() - 6))
    cap2 = min(res["table_hi"].shape[0], -(-n // step) * step)
    th, tl, counts = (res["table_hi"][:cap2], res["table_lo"][:cap2],
                      res["counts"][:cap2])
    succ, okv_hi, okv_lo = build_graph_device(th, tl, res["n_unique"], k)
    valid_node = jnp.arange(cap2, dtype=jnp.int32) < res["n_unique"]
    alive = jnp.ones((cap2,), dtype=jnp.bool_)
    alive, links = simplify_with_metrics(succ, okv_hi, okv_lo, counts, alive,
                                         valid_node, params,
                                         Metrics(quiet=True), with_links=True)
    print(f"n={n} cap2={cap2} links={'yes' if links else 'no'}", flush=True)
    if links is None:
        links = S._links_of(succ, alive, valid_node)
    next_u, prev_u = links

    ranker_a = jax.jit(S._rank_rulers)
    ranker_b = jax.jit(S._rank_rulers_unrolled)

    def run(f):
        def g():
            h, d, ok = f(next_u, prev_u)
            _ = (h[-1].item(), d[-1].item(), bool(ok))
        return g

    timeit("A rank_rulers (while_loop)", run(ranker_a))
    timeit("B rank_rulers_unrolled", run(ranker_b))

    ha, da, oka = ranker_a(next_u, prev_u)
    hb, db, okb = ranker_b(next_u, prev_u)
    alive_o = np.repeat(np.asarray(alive & valid_node), 2)
    ha, da = np.asarray(ha)[alive_o], np.asarray(da)[alive_o]
    hb, db = np.asarray(hb)[alive_o], np.asarray(db)[alive_o]
    print(f"ok A={bool(oka)} B={bool(okb)} equal_head={(ha == hb).all()} "
          f"equal_dist={(da == db).all()}", flush=True)

    def fs_run():
        fs = S.final_chain_state(succ, okv_hi, okv_lo, counts, alive,
                                 valid_node, links=links)
        _ = fs["head"][0].item()
        return fs
    timeit("final_chain_state total", fs_run)
    fs = fs_run()

    def emit_run():
        return emit_contigs_device(fs, okv_hi, okv_lo, k,
                                   params.min_contig_len)
    timeit("emit_contigs_device total", emit_run)
    print(f"contigs={len(emit_run())}", flush=True)

    # ---- simplify pass cost structure (steady state, no kills) ----
    tip_len = jnp.int32(params.tip_len_eff)
    bubble_len = jnp.int32(params.bubble_len_eff)

    def deg_run():
        od, us = S._degrees_jit(succ, alive, valid_node)
        _ = od[-1].item()
    timeit("degrees (full recompute)", deg_run)
    deg = S._degrees_jit(succ, alive, valid_node)

    def links_run():
        nx, pv = S._links_of(succ, alive, valid_node)
        _ = nx[-1].item()
    timeit("links_of (degrees + links)", links_run)

    def tips_run():
        r = S.run_pass_inc("tips", succ, okv_hi, okv_lo, counts, alive,
                           valid_node, tip_len, params.tip_len_eff, deg)
        _ = bool(r[1])
    timeit("tips pass (carried degrees)", tips_run)

    def bub_run():
        r = S.run_pass_inc("bubbles", succ, okv_hi, okv_lo, counts, alive,
                           valid_node, bubble_len, params.bubble_len_eff, deg)
        _ = bool(r[1])
    timeit("bubbles pass (carried degrees)", bub_run)


if __name__ == "__main__":
    main()
