"""T4: single-host assembly pipeline driver (SURVEY.md §3.1 analog).

reads -> pack (host) -> extract+count (device) -> graph build (device)
-> simplify fixpoint (device) -> contigs (host). Static shapes come from
read batching and a power-of-two k-mer table capacity with overflow retry
(SURVEY.md §7 "hard parts": capacity-planned buffers + overflow counters).

Aux subsystems wired here (SURVEY.md §5): per-phase metrics + jax.profiler
tracing, phase-boundary checkpoint/resume.
"""

from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp
import numpy as np

from genome_tpu.assemble.checkpoint import PhaseCheckpointer
from genome_tpu.assemble.metrics import Metrics
from genome_tpu.graph.build import build_graph_device
from genome_tpu.graph.contigs import emit_contigs_device
from genome_tpu.graph.simplify import (clip_tips_pass, final_chain_state,
                                       pop_bubbles_pass)
from genome_tpu.kernels.count import count_kmers_device
from genome_tpu.kernels.extract import extract_canonical_kmers, pack_reads
from genome_tpu.params import AssemblyParams


def _pow2_at_least(n: int) -> int:
    # floor of 2^13 bounds the number of distinct compiled capacities
    return 1 << max(13, (max(n, 1) - 1).bit_length())


def extract_stream(reads, k: int, batch_reads: int = 65536,
                   read_len: int | None = None):
    """Host->device extraction in fixed-shape batches; returns flat (hi, lo).

    `reads` is a list of strings or a pre-parsed uint8 code matrix [R, L]
    (native-IO fast path). Batching keeps [B, L] static: one XLA
    compilation regardless of read count; the final partial batch is
    padded with invalid reads.
    """
    if isinstance(reads, np.ndarray):
        return _extract_stream_codes(reads, k, batch_reads)
    if not reads:
        z = jnp.zeros((0,), dtype=jnp.uint32)
        return z, z
    L = read_len or max(len(r) for r in reads)
    # bucket read length at granularity 8: bounded compiled shapes, and only
    # ~L/8 padding columns of sentinel windows riding the count sort (the
    # old granularity 64 inflated a 100 bp stream by 35%)
    L = ((L + 7) // 8) * 8

    def _pack(i):
        chunk = reads[i : i + batch_reads]
        # pad batch count to a power of two (>=256): static shapes, few compiles
        b = batch_reads if len(reads) > batch_reads else \
            1 << max(8, (len(chunk) - 1).bit_length())
        codes = pack_reads(chunk, L)
        if len(chunk) < b:
            pad = np.full((b - len(chunk), L), 4, dtype=np.uint8)
            codes = np.concatenate([codes, pad])
        return codes

    # host/device overlap: pack batch i+1 on a worker thread while the
    # device extracts batch i (JAX dispatch is async; Python-side string
    # packing is the serial cost this hides — SURVEY.md §5 aux ladder)
    from concurrent.futures import ThreadPoolExecutor
    his, los = [], []
    starts = list(range(0, len(reads), batch_reads))
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(_pack, starts[0])
        for j, i in enumerate(starts):
            codes = fut.result()
            if j + 1 < len(starts):
                fut = pool.submit(_pack, starts[j + 1])
            hi, lo = extract_canonical_kmers(jnp.asarray(codes), k)
            his.append(hi)
            los.append(lo)
    return jnp.concatenate(his), jnp.concatenate(los)


def _extract_stream_codes(codes: np.ndarray, k: int, batch_reads: int,
                          chunk_rows: int = 1 << 21):
    """Code-matrix variant of extract_stream (native-IO fast path).

    Unlike the strings path, codes go to the device PACKED (4 bases/byte
    + validity bitmask, kernels/extract.py pack_codes_host): the
    host->device copy moves ~3.2x fewer bytes. Rows are padded to a 1/32-pow2
    step so compiled shapes stay bounded; inputs beyond `chunk_rows`
    stream in large chunks to bound device memory.
    """
    from genome_tpu.kernels.extract import (extract_canonical_kmers_packed,
                                            pack_codes_host)
    r = codes.shape[0]
    if r == 0 or codes.shape[1] < k:
        z = jnp.zeros((0,), dtype=jnp.uint32)
        return z, z
    L = ((codes.shape[1] + 7) // 8) * 8
    his, los = [], []
    for i in range(0, r, chunk_rows):
        chunk = codes[i : i + chunk_rows]
        cr = chunk.shape[0]
        step = max(256, 1 << max(0, (cr - 1).bit_length() - 5))
        rpad = -(-cr // step) * step
        # native packer pads rows/columns in the packed domain directly;
        # numpy fallback materializes the padded code buffer first
        try:
            from genome_tpu.io.native.cio import pack_codes_native
            pk = pack_codes_native(np.ascontiguousarray(chunk),
                                   L_out=L, rows_out=rpad)
        except Exception:
            pk = None
        if pk is None:
            buf = np.full((rpad, L), 4, dtype=np.uint8)
            buf[:cr, : codes.shape[1]] = chunk
            packed, invalid = pack_codes_host(buf)
            has_invalid = True
        else:
            packed, invalid, has_invalid = pk
        if has_invalid:
            hi, lo = extract_canonical_kmers_packed(
                jnp.asarray(packed), jnp.asarray(invalid), k, L)
        else:
            # no N in the real region: skip the mask transfer (~1/3 of
            # the host->device bytes) and rebuild validity from bounds on
            # device
            from genome_tpu.kernels.extract import (
                extract_canonical_kmers_packed_nomask)
            hi, lo = extract_canonical_kmers_packed_nomask(
                jnp.asarray(packed), k, L, codes.shape[1],
                jnp.int32(cr))
        his.append(hi)
        los.append(lo)
    if len(his) == 1:
        return his[0], los[0]
    return jnp.concatenate(his), jnp.concatenate(los)


def count_reads(reads, params: AssemblyParams,
                capacity: int | None = None, metrics: Metrics | None = None,
                max_device_kmers: int | None = None, counter: str = "sort"):
    """reads -> counted k-mer table dict (count_kmers_device result).

    Doubles capacity and retries on overflow (table sizes are data-dependent;
    shapes must be static — SURVEY §7). If the window stream exceeds
    `max_device_kmers`, counting streams in chunks whose partial tables are
    merged on device (bounded HBM; threshold applied only on the complete
    merged counts)."""
    hi, lo = extract_stream(reads, params.k)
    n_windows = int(hi.shape[0])
    if max_device_kmers and n_windows > max_device_kmers:
        return _count_streaming(hi, lo, params, capacity, metrics,
                                max_device_kmers, n_windows, counter)
    cap = capacity or _pow2_at_least(n_windows or 1)
    if counter == "hashtable":
        from genome_tpu.kernels.hash_table import count_kmers_hashtable
        cap = _pow2_at_least(cap)
        count_fn = count_kmers_hashtable
    elif counter == "bucket":
        import functools as _ft
        from genome_tpu.kernels.sort_bucket import count_kmers_bucket, default_seg
        seg = default_seg(n_windows or 1)
        count_fn = None  # built per retry below (seg grows too)
    else:
        count_fn = count_kmers_device
    while True:
        if counter == "bucket":
            import functools as _ft
            from genome_tpu.kernels.sort_bucket import count_kmers_bucket
            count_fn = _ft.partial(count_kmers_bucket, k=params.k, seg=seg)
        res = count_fn(hi, lo, params.min_coverage, cap)
        # one device->host fetch for both scalars
        ovf_n = np.asarray(jnp.stack([res["overflow"].astype(jnp.int32),
                                      res["n_unique"]]))
        if not int(ovf_n[0]):
            res = dict(res)
            res["n_windows"] = n_windows
            res["n_unique_host"] = int(ovf_n[1])
            return res
        if metrics:
            metrics.log("capacity_overflow", capacity=cap, retry=2 * cap)
        cap *= 2
        if counter == "bucket":
            seg *= 2


def _count_streaming(hi, lo, params, capacity, metrics, chunk, n_windows,
                     counter: str = "sort"):
    """Chunked count + on-device table merges (SURVEY §3.2 streaming)."""
    from genome_tpu.kernels.count import filter_table, merge_tables
    if counter == "bucket":
        import functools as _ft
        from genome_tpu.kernels.sort_bucket import count_kmers_bucket
        chunk_fn = _ft.partial(count_kmers_bucket, k=params.k)
    elif counter == "hashtable":
        from genome_tpu.kernels.hash_table import count_kmers_hashtable
        chunk_fn = count_kmers_hashtable
    else:
        chunk_fn = count_kmers_device
    cap = capacity or _pow2_at_least(min(n_windows, 4 * chunk))
    while True:
        running = None
        overflowed = False
        for i in range(0, n_windows, chunk):
            part_hi, part_lo = hi[i : i + chunk], lo[i : i + chunk]
            if part_hi.shape[0] < chunk:
                pad = chunk - part_hi.shape[0]
                fill = jnp.full((pad,), 0xFFFFFFFF, dtype=jnp.uint32)
                part_hi = jnp.concatenate([part_hi, fill])
                part_lo = jnp.concatenate([part_lo, fill])
            part = chunk_fn(part_hi, part_lo, 1, cap)
            running = part if running is None else merge_tables(
                running, part, 1, cap)
            if bool(running["overflow"]) or bool(part["overflow"]):
                overflowed = True
                break
        if not overflowed:
            res = dict(filter_table(running, params.min_coverage))
            res["n_windows"] = n_windows
            return res
        if metrics:
            metrics.log("capacity_overflow", capacity=cap, retry=2 * cap)
        cap *= 2


def simplify_with_metrics(succ, okv_hi, okv_lo, counts, alive, valid_node,
                          params, metrics: Metrics | None = None,
                          with_links: bool = False):
    """Fixpoint loop (host-driven): tips then bubbles per round (SEMANTICS §5).

    with_links: also return the final round's (next_u, prev_u) links for
    final_chain_state (None if the loop never reached a clean fixpoint)."""
    from genome_tpu.graph.simplify import run_pass_inc
    tip_len = jnp.int32(params.tip_len_eff)
    bubble_len = jnp.int32(params.bubble_len_eff)
    links = None
    deg = None
    lc = None
    for rnd in range(params.max_rounds):
        t0 = time.perf_counter()
        alive, c1, _l1, deg, lc = run_pass_inc(
            "tips", succ, okv_hi, okv_lo, counts, alive, valid_node,
            tip_len, params.tip_len_eff, deg, lc)
        alive, c2, l2, deg, lc = run_pass_inc(
            "bubbles", succ, okv_hi, okv_lo, counts, alive, valid_node,
            bubble_len, params.bubble_len_eff, deg, lc)
        # one device->host fetch per round: changed flags + alive count
        c1b, c2b, n_alive = jax.device_get(
            (c1, c2, (alive & valid_node).sum()))
        changed = bool(c1b) or bool(c2b)
        if metrics:
            metrics.log("simplify_round", round=rnd, tips=bool(c1b),
                        bubbles=bool(c2b), alive=int(n_alive),
                        wall_s=round(time.perf_counter() - t0, 4))
        if not changed:
            links = l2
            break
    return (alive, links) if with_links else alive


# kept as the simple name used elsewhere
simplify_device = simplify_with_metrics


def run_pipeline(reads, params: AssemblyParams,
                 capacity: int | None = None,
                 metrics: Metrics | None = None,
                 ckpt: PhaseCheckpointer | None = None,
                 profile_dir: str | None = None,
                 max_device_kmers: int | None = None,
                 counter: str = "sort") -> dict:
    """Full single-host pipeline with metrics/checkpoint/profiling.

    Returns {"contigs": [...], "stats": {...}}.
    """
    metrics = metrics or Metrics(quiet=True)
    ckpt = ckpt or PhaseCheckpointer(None, params)
    stats: dict = {}

    prof = (jax.profiler.trace(profile_dir) if profile_dir
            else contextlib.nullcontext())
    with prof:
        # ---- phase: count ----
        saved = ckpt.load("count")
        if saved is not None:
            metrics.log("resume", phase="count")
            table_hi = jnp.asarray(saved["table_hi"])
            table_lo = jnp.asarray(saved["table_lo"])
            counts = jnp.asarray(saved["counts"])
            n_host = int(saved["n_unique"])
            n_unique = jnp.int32(n_host)
            stats["n_windows"] = int(saved["n_windows"])
        else:
            with metrics.phase("count") as info:
                t0 = time.perf_counter()
                res = count_reads(reads, params, capacity, metrics,
                                  max_device_kmers=max_device_kmers,
                                  counter=counter)
                table_hi, table_lo = res["table_hi"], res["table_lo"]
                counts, n_unique = res["counts"], res["n_unique"]
                # count_reads already fetched this scalar; reuse it
                n_host = res.get("n_unique_host")
                if n_host is None:
                    n_host = int(n_unique)
                dt = time.perf_counter() - t0
                stats["n_windows"] = res["n_windows"]
                info["n_windows"] = res["n_windows"]
                info["n_unique"] = n_host
                info["kmers_per_s"] = round(res["n_windows"] / max(dt, 1e-9))
            ckpt.save("count", table_hi=table_hi, table_lo=table_lo,
                      counts=counts, n_unique=n_host,
                      n_windows=stats["n_windows"])
        stats["n_unique"] = n_host

        # compact the table toward n_unique before build/simplify: probe
        # and chain work scale with capacity, not real nodes. Rounded so
        # compiled shapes stay bounded (<= 8 per power-of-two decade).
        n_int = n_host
        # 1/64 granularity: build sorts 4*cap2 records, so table slack is
        # the biggest build-phase cost knob (1/8 steps padded up to ~19%)
        step = max(256, 1 << max(0, n_int.bit_length() - 6))
        cap2 = min(table_hi.shape[0], -(-max(n_int, 1) // step) * step)
        table_hi, table_lo = table_hi[:cap2], table_lo[:cap2]
        counts = counts[:cap2]

        # ---- phase: build ----
        with metrics.phase("build") as info:
            succ, okv_hi, okv_lo = build_graph_device(
                table_hi, table_lo, n_unique, params.k)
            jax.block_until_ready(succ)
            info["nodes"] = int(n_unique)

        # ---- phase: simplify ----
        saved = ckpt.load("simplify")
        links = None
        if saved is not None and saved["alive"].shape[0] == table_hi.shape[0]:
            metrics.log("resume", phase="simplify")
            alive = jnp.asarray(saved["alive"])
        else:
            with metrics.phase("simplify") as info:
                cap = table_hi.shape[0]
                valid_node = jnp.arange(cap, dtype=jnp.int32) < n_unique
                alive = jnp.ones((cap,), dtype=jnp.bool_)
                alive, links = simplify_with_metrics(
                    succ, okv_hi, okv_lo, counts, alive, valid_node, params,
                    metrics, with_links=True)
                jax.block_until_ready(alive)
                info["alive"] = int((alive & valid_node).sum())
            ckpt.save("simplify", alive=alive)
        cap = table_hi.shape[0]
        valid_node = jnp.arange(cap, dtype=jnp.int32) < n_unique
        stats["n_alive"] = int((alive & valid_node).sum())

        # ---- phase: contigs ----
        with metrics.phase("contigs") as info:
            cap = table_hi.shape[0]
            valid_node = jnp.arange(cap, dtype=jnp.int32) < n_unique
            t0 = time.perf_counter()
            fs = final_chain_state(succ, okv_hi, okv_lo, counts, alive,
                                   valid_node, links=links)
            jax.block_until_ready(fs)
            info["final_s"] = round(time.perf_counter() - t0, 4)
            t0 = time.perf_counter()
            contigs = emit_contigs_device(fs, okv_hi, okv_lo, params.k,
                                          params.min_contig_len)
            info["emit_s"] = round(time.perf_counter() - t0, 4)
            info["n_contigs"] = len(contigs)
            info["total_bp"] = sum(map(len, contigs))
    stats["n_contigs"] = len(contigs)
    return {"contigs": contigs, "stats": stats}


def assemble_device(reads: list[str], params: AssemblyParams | None = None,
                    capacity: int | None = None) -> list[str]:
    """reads -> sorted canonical contigs, computed on the JAX backend.

    Bit-identical to golden.assemble / tiny.assemble (SEMANTICS.md).
    """
    params = params or AssemblyParams()
    return run_pipeline(reads, params, capacity=capacity)["contigs"]
