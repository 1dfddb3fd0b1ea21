"""Final-phase probe: can ruler ranking's phase 1 get faster at bench
scale? Two candidates vs production, on the REAL post-simplify
graph state (not synthetic chains):

A. production `_rank_rulers` (stride 16, packed, early-exit while_loop)
B. hybrid: first `PRE` doubling rounds UNROLLED (they always run —
   min rounds ≈ log2(mean ruler gap) ≈ 4), while_loop for the tail.
   The FULLY unrolled variant pays rounds that never run; the hybrid
   only unrolls rounds that do.
C. stride-8 scheme point at scale 1 (fewer phase-1 rounds, 2x phase-2
   arrays — measures the stride tradeoff directly on real data).

Every variant's (head, dist) is asserted equal to production's. Prints
'[fin]' lines; record the outcome in PERF.md either way.
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def _sync(x):
    return x.reshape(-1)[0].item()


def _timed(fn, *args, reps=3):
    best = None
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out[0])
        dt = time.perf_counter() - t0
        best = dt if best is None or dt < best else best
    return best, out


def main() -> int:
    import functools

    import jax
    import jax.numpy as jnp
    from genome_tpu.runtime import enable_compile_cache
    enable_compile_cache()

    from genome_tpu.assemble.pipeline import run_pipeline, count_reads, \
        simplify_with_metrics
    from genome_tpu.graph.build import build_graph_device
    from genome_tpu.graph import simplify as GS
    from genome_tpu.io.benchdata import bench_workload
    from genome_tpu.params import AssemblyParams

    w = bench_workload(float(os.environ.get("BENCH_SCALE", "1.0")))
    params = AssemblyParams(k=w["k"], min_coverage=2)

    # build the real post-simplify state (same path as run_pipeline)
    res = count_reads(w["err"], params, capacity=w["capacity"])
    th, tl, cnts = res["table_hi"], res["table_lo"], res["counts"]
    n_host = res["n_unique_host"]
    step = max(256, 1 << max(0, n_host.bit_length() - 6))
    cap2 = min(th.shape[0], -(-max(n_host, 1) // step) * step)
    th, tl, cnts = th[:cap2], tl[:cap2], cnts[:cap2]
    succ, okv_hi, okv_lo = build_graph_device(th, tl, res["n_unique"],
                                              params.k)
    valid = jnp.arange(cap2, dtype=jnp.int32) < res["n_unique"]
    alive = jnp.ones((cap2,), dtype=jnp.bool_)
    alive, links = simplify_with_metrics(succ, okv_hi, okv_lo, cnts,
                                         alive, valid, params,
                                         with_links=True)
    if links is None:
        links = GS._links_of(succ, alive, valid)
    nxt, prv = links
    n2 = int(nxt.shape[0])
    print(f"[fin] n2={n2} alive={int((alive & valid).sum())}", flush=True)

    # A: production ranking (jitted standalone for a clean timing)
    rank_prod = jax.jit(GS._rank_rulers)
    dtA, outA = _timed(rank_prod, nxt, prv)
    headA, distA = np.asarray(outA[0]), np.asarray(outA[1])
    print(f"[fin] A production _rank_rulers: {dtA*1e3:.1f} ms "
          f"(ok={bool(outA[2])})", flush=True)

    # B: hybrid pre-unroll
    def rank_hybrid(next_u, prev_u, pre, stride, d_bits):
        ids = jnp.arange(n2, dtype=jnp.int32)
        p_bits = 32 - d_bits
        sat = jnp.uint32((1 << d_bits) - 1)
        pm = jnp.uint32((1 << p_bits) - 1)
        sh = jnp.uint32(p_bits)
        umask = jnp.uint32(stride - 1)
        p0 = jnp.where(prev_u >= 0, prev_u, ids).astype(jnp.uint32)
        d0 = jnp.where(prev_u >= 0, jnp.uint32(1), jnp.uint32(0))
        x = p0 | (d0 << sh)
        for _ in range(pre):  # unrolled always-run rounds
            p = x & pm
            g = x[p]
            d2 = jnp.minimum((x >> sh) + (g >> sh), sat)
            adv = (p & umask) != 0
            x = jnp.where(adv, (g & pm) | (d2 << sh), x)
        rounds = max(1, (n2 - 1).bit_length() + 1)

        def cond(c):
            _, i, ch = c
            return (i < rounds) & ch

        def body(c):
            x, i, _ = c
            p = x & pm
            g = x[p]
            d2 = jnp.minimum((x >> sh) + (g >> sh), sat)
            adv = (p & umask) != 0
            x2 = jnp.where(adv, (g & pm) | (d2 << sh), x)
            return x2, i + 1, (adv & ((g & pm) != p)).any()

        x, _, _ = jax.lax.while_loop(cond, body,
                                     (x, jnp.int32(pre), jnp.bool_(True)))
        p = (x & pm).astype(jnp.int32)
        d = (x >> sh).astype(jnp.int32)
        return p, d

    for pre in (3, 4, 5):
        f = jax.jit(functools.partial(rank_hybrid, pre=pre, stride=16,
                                      d_bits=8))
        dtB, outB = _timed(f, nxt, prv)
        print(f"[fin] B hybrid pre={pre} phase1-only: {dtB*1e3:.1f} ms",
              flush=True)

    # phase-1-only production baseline for a like-for-like comparison
    f0 = jax.jit(functools.partial(rank_hybrid, pre=0, stride=16,
                                   d_bits=8))
    dt0, out0 = _timed(f0, nxt, prv)
    print(f"[fin] B0 while-only phase1: {dt0*1e3:.1f} ms", flush=True)

    # C: stride-8 full ranking at scale 1
    rank8 = jax.jit(functools.partial(GS._rank_rulers_impl, stride=8,
                                      d_bits=6, sat_k=1 << 17,
                                      packed=True))
    dtC, outC = _timed(rank8, nxt, prv)
    headC, distC = np.asarray(outC[0]), np.asarray(outC[1])
    same = bool(outC[2]) and np.array_equal(headC, headA) \
        and np.array_equal(distC, distA)
    print(f"[fin] C stride-8 full ranking: {dtC*1e3:.1f} ms "
          f"(matches production: {same})", flush=True)

    # the full production final phase for context (links handed over)
    def full_final():
        return GS.final_chain_state(succ, okv_hi, okv_lo, cnts, alive,
                                    valid, links=links)["head"]
    t0 = time.perf_counter()
    _sync(full_final())
    t1 = time.perf_counter()
    _sync(full_final())
    print(f"[fin] full final_chain_state: first {t1-t0:.2f} s, "
          f"second {time.perf_counter()-t1:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
