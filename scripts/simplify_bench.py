"""Time the simplify passes + final chain state at bench scale on device.

Usage: python scripts/simplify_bench.py [scale]
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
from genome_tpu.graph.simplify import (clip_tips_pass, final_chain_state,
                                       pop_bubbles_pass)
from genome_tpu.kernels.count import count_kmers_device
from genome_tpu.kernels.extract import extract_canonical_kmers


def sync(x):
    return np.asarray(jax.tree.leaves(x)[0].sum() if hasattr(
        jax.tree.leaves(x)[0], "sum") else jax.tree.leaves(x)[0])


def main():
    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    k = 21
    genome_len = int(4_600_000 * scale)
    read_len = 100
    num_reads = int(genome_len * 24 / read_len)
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - read_len + 1, size=num_reads)
    capacity = 1 << max(13, int(np.ceil(np.log2(genome_len * 1.5))))
    num_padded = ((num_reads + 4095) // 4096) * 4096
    codes = np.full((num_padded, read_len), 4, dtype=np.uint8)
    codes[:num_reads] = genome[starts[:, None] + np.arange(read_len)[None, :]]
    codes = jnp.asarray(codes)

    @jax.jit
    def count(c):
        his, los = extract_canonical_kmers(c, k)
        r = count_kmers_device(his, los, 2, capacity)
        return r["table_hi"], r["table_lo"], r["counts"], r["n_unique"]

    th, tl, cnts, n_uni = count(codes)
    n = int(n_uni)
    step = max(256, 1 << max(0, n.bit_length() - 6))
    cap2 = -(-n // step) * step
    th, tl, cnts = th[:cap2], tl[:cap2], cnts[:cap2]
    print(f"unique={n} cap2={cap2}", flush=True)

    succ, okh, okl = jax.jit(lambda a, b, m: build_graph_device(a, b, m, k))(
        th, tl, n_uni)
    alive = jnp.ones((cap2,), dtype=bool)
    valid = jnp.arange(cap2) < n_uni
    tip_len = jnp.int32(42)
    bub_len = jnp.int32(43)

    def t(fn, *a, reps=2):
        out = fn(*a)
        _ = sync(out)
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(*a)
            _ = sync(out)
            best = min(best, time.perf_counter() - t0)
        return best, out

    dt, (alive1, ch) = t(lambda *a: clip_tips_pass(*a, max_len=42),
                         succ, okh, okl, cnts, alive, valid, tip_len)
    print(f"tip pass: {dt*1e3:.0f} ms (changed={bool(ch)})", flush=True)

    dt, (alive2, ch2) = t(lambda *a: pop_bubbles_pass(*a, max_len=43),
                          succ, okh, okl, cnts, alive1, valid, bub_len)
    print(f"bubble pass: {dt*1e3:.0f} ms (changed={bool(ch2)})", flush=True)

    dt, fs = t(final_chain_state, succ, okh, okl, cnts, alive2, valid)
    print(f"final_chain_state: {dt*1e3:.0f} ms", flush=True)


if __name__ == "__main__":
    main()
