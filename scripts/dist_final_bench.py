"""A/B bench: exact sharded final (full remote doubling + cycle
machinery) vs the ruler-ranking fast final (dist/simplify.py
make_sharded_final_fast) on one synthetic sharded graph.

Runs on a virtual CPU mesh (fake-cluster pattern, SURVEY §4.5a) — wall
times are plumbing numbers, but the exchange-structure difference they
measure (full-size all_to_all rounds per variant) is the thing that
scales to real multi-card meshes. Prints one JSON line per variant.

Usage: python scripts/dist_final_bench.py [--devices 8] [--genome 400000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--genome", type=int, default=400_000)
    ap.add_argument("--coverage", type=int, default=12)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count="
                               f"{args.devices}").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from genome_tpu.dist.simplify import (make_sharded_final,
                                          make_sharded_final_fast,
                                          simplify_sharded)
    from genome_tpu.io import random_genome, simulate_reads
    from genome_tpu.params import AssemblyParams

    S = args.devices
    mesh = Mesh(np.array(jax.devices()[:S]), ("shard",))
    params = AssemblyParams(k=args.k, min_coverage=2)
    reads = simulate_reads(random_genome(args.genome, seed=5),
                           read_len=100, coverage=args.coverage,
                           error_rate=0.004, seed=6)

    # build the sharded graph through the production path pieces
    from genome_tpu.assemble.pipeline import _pow2_at_least, extract_stream
    from genome_tpu.dist.build import make_sharded_build
    from genome_tpu.dist.count import make_sharded_count
    from genome_tpu.dist.assemble import shard_reads
    from genome_tpu.kernels.extract import SENTINEL

    shards = shard_reads(reads, S)
    his, los = [], []
    for sh in shards:
        h, l = extract_stream(sh, params.k)
        his.append(np.asarray(h))
        los.append(np.asarray(l))
    m_dev = max(max(h.size for h in his), 1)
    hi = np.full((S, m_dev), SENTINEL, np.uint32)
    lo = np.full((S, m_dev), SENTINEL, np.uint32)
    for i, (h, l) in enumerate(zip(his, los)):
        hi[i, : h.size] = h
        lo[i, : l.size] = l
    local_cap = _pow2_at_least(m_dev)
    bucket_cap = max(64, int(1.35 * m_dev / S) + 64)
    counter = make_sharded_count(mesh, "shard", bucket_cap, local_cap)
    th, tl, cnts, n_uni, ovf = counter(
        jnp.asarray(hi.reshape(-1)), jnp.asarray(lo.reshape(-1)),
        jnp.asarray([params.min_coverage], jnp.uint32))
    assert not bool(np.asarray(ovf).any())
    from genome_tpu.dist.count import shrink_tables
    th, tl, cnts, local_cap = shrink_tables(mesh, "shard", local_cap,
                                            th, tl, cnts, n_uni)
    query_cap = max(64, int(1.35 * 8 * local_cap / S) + 64)
    builder = make_sharded_build(mesh, "shard", params.k, local_cap,
                                 query_cap)
    succ, okv_hi, okv_lo, bovf = builder(th, tl, n_uni)
    assert not bool(np.asarray(bovf).any())
    alive0 = jnp.ones((S * local_cap,), dtype=jnp.bool_)
    alive, ovf_s = simplify_sharded(mesh, "shard", local_cap, succ,
                                    okv_hi, okv_lo, cnts, alive0, n_uni,
                                    params)
    assert not ovf_s

    variants = {
        "exact": make_sharded_final(mesh, "shard", local_cap),
        "fast": make_sharded_final_fast(mesh, "shard", local_cap),
    }
    results = {}
    for name, fn in variants.items():
        outs = fn(succ, okv_hi, okv_lo, cnts, alive, n_uni)  # warm
        jax.block_until_ready(outs)
        best = None
        for _ in range(args.reps):
            t0 = time.perf_counter()
            outs = fn(succ, okv_hi, okv_lo, cnts, alive, n_uni)
            jax.block_until_ready(outs)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        results[name] = outs
        print(json.dumps({"variant": name, "devices": S,
                          "genome": args.genome,
                          "local_cap": local_cap,
                          "wall_s": round(best, 4)}))

    # cross-check: identical (head, dist, primary) on alive nodes
    eh, ed, ep = (np.asarray(x) for x in results["exact"][:3])
    fh, fd, fp, _, fok, _ = (np.asarray(x) for x in results["fast"])
    assert np.asarray(fok).all(), "fast final flagged fallback"
    ao = np.asarray(results["exact"][3])
    assert (eh[ao] == fh[ao]).all() and (ed[ao] == fd[ao]).all() \
        and (ep[ao] == fp[ao]).all(), "fast != exact"
    print(json.dumps({"parity": "exact==fast on alive nodes"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
