"""T3/T4: partitioned assembly driver (SURVEY.md §3.4).

reads --DP split--> per-shard extraction (host->device)
      --all_to_all #1--> sharded counting at k-mer owners
      --all_to_all #2/#3--> sharded graph build (boundary probes + replies)
      --> sharded simplification (dist/simplify.py remote-gather pointer
          doubling) --> contig emission.

Counting, graph build, and simplification all run sharded; every pin is
k-mer-value-based, so contigs are bit-identical to the single-device
pipeline for every shard count (CI-enforced).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from genome_tpu.assemble.metrics import Metrics
from genome_tpu.assemble.pipeline import extract_stream, _pow2_at_least
from genome_tpu.dist.build import make_sharded_build
from genome_tpu.dist.count import make_sharded_count
from genome_tpu.graph.contigs import emit_contigs
from genome_tpu.graph.simplify import final_chain_state, simplify_device
from genome_tpu.kernels.extract import SENTINEL
from genome_tpu.params import AssemblyParams


def _default_mesh(num_shards: int) -> Mesh:
    devs = jax.devices()
    if len(devs) >= num_shards:
        return Mesh(np.array(devs[:num_shards]), ("shard",))
    # fewer devices than shards: replicate devices round-robin is invalid
    # for shard_map; callers on 1 device should use the single-host path.
    raise ValueError(
        f"need >= {num_shards} devices for {num_shards} shards, "
        f"have {len(devs)}")


def shard_reads(reads: list[str], num_shards: int) -> list[list[str]]:
    """Contiguous DP split of the read set (read batches
    stream data-parallel). Output is invariant to the split (CI-tested)."""
    per = (len(reads) + num_shards - 1) // num_shards
    return [reads[i * per : (i + 1) * per] for i in range(num_shards)]


def assemble_sharded(reads: list[str], params: AssemblyParams | None = None,
                     num_shards: int = 2, mesh: Mesh | None = None,
                     metrics: Metrics | None = None,
                     local_capacity: int | None = None,
                     sharded_simplify: bool = True) -> list[str]:
    """Partitioned assembly over a device mesh; contigs == single-host."""
    params = params or AssemblyParams()
    metrics = metrics or Metrics(quiet=True)
    mesh = mesh or _default_mesh(num_shards)
    S = num_shards
    from genome_tpu.dist.ledger import LEDGER
    LEDGER.reset_invocations()

    # --- per-shard extraction (DP) ---
    with metrics.phase("dist_extract") as info:
        parts = []
        for chunk in shard_reads(reads, S):
            hi, lo = extract_stream(chunk, params.k)
            parts.append((np.asarray(hi), np.asarray(lo)))
        m_local = max((p[0].size for p in parts), default=1)
        m_local = max(m_local, 8)
        ghi = np.full((S, m_local), SENTINEL, dtype=np.uint32)
        glo = np.full((S, m_local), SENTINEL, dtype=np.uint32)
        for r, (h, l) in enumerate(parts):
            ghi[r, : h.size] = h
            glo[r, : l.size] = l
        ghi, glo = ghi.reshape(-1), glo.reshape(-1)
        info["windows"] = int(ghi.size)

    # --- sharded count (all_to_all #1), capacity retry on overflow ---
    bucket_cap = max(64, int(1.3 * m_local / S) + 64)
    local_cap = local_capacity or _pow2_at_least(max(64, m_local))
    min_cov = jnp.asarray([params.min_coverage], jnp.uint32)
    with metrics.phase("dist_count") as info:
        while True:
            counter = make_sharded_count(mesh, "shard", bucket_cap, local_cap)
            th, tl, cnts, n_uni, ovf = counter(ghi, glo, min_cov)
            LEDGER.invoke("dist_count")
            if not bool(np.asarray(ovf).any()):
                break
            bucket_cap *= 2
            local_cap *= 2
            metrics.log("dist_capacity_overflow", bucket_cap=bucket_cap,
                        local_cap=local_cap)
        info["n_unique_total"] = int(np.asarray(n_uni).sum())
        from genome_tpu.dist.count import shrink_tables
        th, tl, cnts, local_cap = shrink_tables(
            mesh, "shard", local_cap, th, tl, cnts, n_uni)
        info["local_cap"] = local_cap

    # --- sharded graph build (all_to_all #2/#3: boundary probes) ---
    query_cap = max(64, int(1.3 * 8 * local_cap / S) + 64)
    with metrics.phase("dist_build") as info:
        while True:
            builder = make_sharded_build(mesh, "shard", params.k, local_cap,
                                         query_cap)
            succ, okv_hi, okv_lo, bovf = builder(th, tl, n_uni)
            LEDGER.invoke("dist_build")
            if not bool(np.asarray(bovf).any()):
                break
            query_cap *= 2
            metrics.log("dist_query_overflow", query_cap=query_cap)

    # --- simplify: sharded pointer doubling over the mesh (remote-gather
    # exchanges, dist/simplify.py). simplify_sharded retries internally
    # with doubled routing slack on overflow; only an exhausted retry
    # ladder falls back to the replicated passes (correctness escape).
    # Both implement the same value-based pins, so contigs are identical
    # either way (CI-enforced). ---
    n_loc = np.asarray(n_uni)
    valid = (np.arange(S * local_cap).reshape(S, local_cap)
             % local_cap < n_loc[:, None]).reshape(-1)
    alive_sh = None
    if sharded_simplify:
        from genome_tpu.dist.simplify import simplify_sharded
        with metrics.phase("dist_simplify_sharded") as info:
            alive0 = jnp.ones((S * local_cap,), dtype=jnp.bool_)
            alive_sh, ovf_s = simplify_sharded(
                mesh, "shard", local_cap, succ, okv_hi, okv_lo, cnts,
                alive0, n_uni, params)
            info["overflow"] = bool(ovf_s)
            if ovf_s:
                alive_sh = None
                metrics.log("dist_simplify_overflow_fallback")

    if alive_sh is not None:
        # --- sharded emission: head/dist/primary stay sharded over the
        # mesh (the final chain state never materializes a global-graph
        # array on one device); only the emission tuples cross to the
        # host, where string assembly happens anyway ---
        from genome_tpu.dist.simplify import final_state_sharded
        with metrics.phase("dist_final_sharded") as info:
            head, dist, primary, alive_o, f_ovf = final_state_sharded(
                mesh, "shard", local_cap, succ, okv_hi, okv_lo, cnts,
                alive_sh, n_uni, metrics=metrics)
            info["overflow"] = bool(f_ovf)
        if not f_ovf:
            # sharded emission: blocks routed by hash(head, dist//B); no
            # device or host buffer ever holds the global chain state
            from genome_tpu.dist.emit import emit_contigs_sharded
            with metrics.phase("dist_contigs") as info:
                contigs, ok = emit_contigs_sharded(
                    mesh, "shard", local_cap, head, dist, primary,
                    alive_o, okv_hi, okv_lo, params.k,
                    params.min_contig_len)
                if not ok:
                    metrics.log("dist_emit_overflow_fallback")
                    contigs = emit_contigs(
                        dict(head=head, dist=dist, primary=primary,
                             alive_o=alive_o),
                        okv_hi, okv_lo, params.k, params.min_contig_len,
                        node_primary=True)
                info["n_contigs"] = len(contigs)
            # per-program collective/byte costs x invocation counts: the
            # scaling-evidence record
            metrics.log("exchange_ledger", **LEDGER.summary())
            return contigs
        metrics.log("dist_final_overflow_fallback")

    # replicated fallback path (single device holds the global graph)
    with metrics.phase("dist_simplify") as info:
        dev = jax.devices()[0]
        succ_g = jax.device_put(np.asarray(succ), dev)
        okv_hi_g = jax.device_put(np.asarray(okv_hi), dev)
        okv_lo_g = jax.device_put(np.asarray(okv_lo), dev)
        counts_g = jax.device_put(np.asarray(cnts), dev)
        valid_g = jax.device_put(valid, dev)
        if alive_sh is not None:
            alive = jax.device_put(np.asarray(alive_sh), dev)
        else:
            alive = jnp.ones((S * local_cap,), dtype=jnp.bool_)
            alive = simplify_device(succ_g, okv_hi_g, okv_lo_g, counts_g,
                                    alive, valid_g, params)
        fs = final_chain_state(succ_g, okv_hi_g, okv_lo_g, counts_g, alive,
                               valid_g)
        info["alive"] = int(alive.sum())

    with metrics.phase("dist_contigs") as info:
        contigs = emit_contigs(fs, okv_hi_g, okv_lo_g, params.k,
                               params.min_contig_len)
        info["n_contigs"] = len(contigs)
    return contigs
