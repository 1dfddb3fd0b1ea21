"""Probe the e2e wall's components on the real chip: host pack, host->
device transfer bandwidth, extraction dispatch, and the contigs phase's
internals (final_chain_state vs emit vs host decode). Run on the GPU."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from genome_tpu.runtime import enable_compile_cache
enable_compile_cache()


def t(label, f, reps=2):
    f()  # warmup
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        f()
        ts.append(time.perf_counter() - t0)
    print(f"{label}: {min(ts)*1e3:.0f} ms", flush=True)
    return min(ts)


def main():
    from genome_tpu.io.benchdata import bench_workload
    from genome_tpu.kernels.extract import (extract_canonical_kmers_packed,
                                            pack_codes_host)

    w = bench_workload(1.0)
    codes = w["err"]
    k = w["k"]
    print(f"codes {codes.shape} = {codes.nbytes/1e6:.0f} MB", flush=True)

    # raw link bandwidth at a few sizes
    for mb in (1, 8, 32):
        a = np.random.default_rng(0).integers(
            0, 255, size=mb << 20, dtype=np.uint8)
        dt = t(f"  put {mb} MB", lambda: jax.block_until_ready(jnp.asarray(a)))
        print(f"    -> {mb/1024/dt:.1f} GB/s", flush=True)

    # host pack
    dt_pack = t("pack_codes_host", lambda: pack_codes_host(codes))
    packed, invalid = pack_codes_host(codes)
    print(f"  packed {packed.nbytes/1e6:.1f} MB + invalid "
          f"{invalid.nbytes/1e6:.1f} MB", flush=True)

    # transfer
    def xfer():
        p = jnp.asarray(packed)
        iv = jnp.asarray(invalid)
        jax.block_until_ready((p, iv))
        return p, iv
    dt_x = t("transfer packed+invalid", xfer)
    p_d, iv_d = xfer()

    # extraction dispatch on resident data
    L = codes.shape[1]
    Lp = ((L + 7) // 8) * 8

    def ext():
        hi, lo = extract_canonical_kmers_packed(p_d, iv_d, k, Lp)
        jax.block_until_ready((hi, lo))
        return hi, lo
    # note: shapes differ from pipeline path (full matrix at once)
    try:
        t("extract (resident, one dispatch)", ext)
    except Exception as e:
        print(f"extract probe failed: {e}", flush=True)

    # full pipeline count phase for comparison
    from genome_tpu.assemble.pipeline import extract_stream
    def full():
        hi, lo = extract_stream(codes, k)
        jax.block_until_ready((hi, lo))
    t("pipeline extract_stream(codes)", full)

    # ---- contigs phase internals ----
    from genome_tpu.assemble.metrics import Metrics
    from genome_tpu.assemble.pipeline import count_reads, simplify_with_metrics
    from genome_tpu.graph.build import build_graph_device
    from genome_tpu.graph.contigs import _chain_emit_device, emit_contigs_device
    from genome_tpu.graph.simplify import final_chain_state
    from genome_tpu.params import AssemblyParams

    params = AssemblyParams(k=k, min_coverage=2)
    res = count_reads(codes, params, w["capacity"])
    th, tl, counts, n_unique = (res["table_hi"], res["table_lo"],
                                res["counts"], res["n_unique"])
    n_int = int(n_unique)
    step = max(256, 1 << max(0, n_int.bit_length() - 6))
    cap2 = min(th.shape[0], -(-n_int // step) * step)
    th, tl, counts = th[:cap2], tl[:cap2], counts[:cap2]
    succ, okv_hi, okv_lo = build_graph_device(th, tl, n_unique, k)
    valid_node = jnp.arange(cap2, dtype=jnp.int32) < n_unique
    alive = jnp.ones((cap2,), dtype=jnp.bool_)
    t0 = time.perf_counter()
    alive, links = simplify_with_metrics(succ, okv_hi, okv_lo, counts, alive,
                                         valid_node, params, Metrics(quiet=True),
                                         with_links=True)
    jax.block_until_ready(alive)
    print(f"simplify: {(time.perf_counter()-t0)*1e3:.0f} ms (first run incl"
          " any compile)", flush=True)

    def fs_run():
        fs = final_chain_state(succ, okv_hi, okv_lo, counts, alive,
                               valid_node, links=links)
        jax.block_until_ready(fs["head"])
        return fs
    t("final_chain_state (with links)", fs_run)
    fs = fs_run()

    def fs_nolinks():
        fs2 = final_chain_state(succ, okv_hi, okv_lo, counts, alive,
                                valid_node, links=None)
        jax.block_until_ready(fs2["head"])
    t("final_chain_state (no links)", fs_nolinks)

    n2 = int(fs["head"].shape[0])
    cap_em = max(4096, n2 >> 6)

    def emit_dev():
        r = _chain_emit_device(fs["head"], fs["dist"], fs["primary"],
                               fs["alive_o"], okv_hi, okv_lo,
                               contig_cap=cap_em, node_primary=False)
        jax.block_until_ready(r[0])
    t("chain_emit_device (device side)", emit_dev)

    def emit_full():
        return emit_contigs_device(fs, okv_hi, okv_lo, k,
                                   params.min_contig_len)
    t("emit_contigs_device (total incl host)", emit_full)


if __name__ == "__main__":
    main()
