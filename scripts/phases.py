"""Phase-level timing of the bench workload (count vs build vs extract).

Usage: python scripts/phases.py [scale]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from genome_tpu.runtime import enable_compile_cache
enable_compile_cache()

from genome_tpu.graph.build import build_graph_device
from genome_tpu.kernels.count import count_kmers_device
from genome_tpu.kernels.extract import extract_canonical_kmers


def t(fn, *args, reps=3):
    out = fn(*args)
    _ = np.asarray(jax.tree.leaves(out)[0])
    best = 1e9
    for _i in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _ = np.asarray(jax.tree.leaves(out)[0])
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    k = 21
    genome_len = int(4_600_000 * scale)
    read_len = 100
    num_reads = int(genome_len * 24 / read_len)
    batch = 1 << 17
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - read_len + 1, size=num_reads)
    capacity = 1 << max(13, int(np.ceil(np.log2(genome_len * 1.5))))
    num_padded = ((num_reads + batch - 1) // batch) * batch
    codes = np.full((num_padded, read_len), 4, dtype=np.uint8)
    codes[:num_reads] = genome[starts[:, None] + np.arange(read_len)[None, :]]
    codes = jnp.asarray(codes)

    extract = jax.jit(lambda c: [x.astype(jnp.uint32).sum() for x in
                                 extract_canonical_kmers(c, k)][0])
    print(f"extract: {t(extract, codes)*1e3:.0f} ms", flush=True)

    @jax.jit
    def count_scalar(c):
        his, los = extract_canonical_kmers(c, k)
        r = count_kmers_device(his, los, 2, capacity)
        return r["n_unique"] + r["counts"][::4096].sum()

    dt = t(count_scalar, codes)

    @jax.jit
    def count(c):
        his, los = extract_canonical_kmers(c, k)
        r = count_kmers_device(his, los, 2, capacity)
        return r["table_hi"], r["table_lo"], r["n_unique"]

    th, tl, n_uni = count(codes)
    n = int(n_uni)
    print(f"extract+count: {dt*1e3:.0f} ms (unique={n})", flush=True)

    step = max(256, 1 << max(0, n.bit_length() - 6))
    cap2 = -(-n // step) * step
    th2, tl2 = th[:cap2], tl[:cap2]

    @jax.jit
    def build(a, b, m):
        succ, _, _ = build_graph_device(a, b, m, k)
        return succ.sum()

    print(f"build: {t(build, th2, tl2, n_uni)*1e3:.0f} ms (cap2={cap2})",
          flush=True)

    # sort-only within count, for the record
    @jax.jit
    def sort_only(c):
        his, los = extract_canonical_kmers(c, k)
        sh, sl = jax.lax.sort((his, los), num_keys=2)
        return sh[::4096].astype(jnp.uint64).sum() + sl[-1]

    print(f"extract+sort2: {t(sort_only, codes)*1e3:.0f} ms", flush=True)


if __name__ == "__main__":
    main()
