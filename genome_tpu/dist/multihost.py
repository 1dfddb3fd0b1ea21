"""T3: multi-host (multi-process) assembly (SURVEY.md §2.3, §3.4).

Reference analog: `PartitionedDNAMap`'s JVM cluster — here it is
`jax.distributed.initialize()` + one global mesh over every chip of every
host; the shard_map programs in dist/count.py and dist/build.py are
already SPMD, so they run unchanged over a process-spanning mesh with the
all_to_all collectives riding NVLink within a host and the network
across hosts.

Per-process flow (SPMD, every host runs the same program on its read
shard):  local reads -> extract -> global sharded arrays
         -> sharded count/build/simplify/final (collectives; no device
         ever holds a global-graph-sized array) -> chain-state tuples
         allgathered to HOST memory -> every process assembles the same
         contig strings (process 0 writes them out).

The replicated path (allgather the graph onto one device and simplify
locally) survives only as the correctness escape when the sharded
simplify's routing-capacity retry ladder is exhausted.

Tested in CI with the localhost fake-cluster pattern (SURVEY §4.5): two
processes, each with 4 virtual CPU devices.
"""

from __future__ import annotations

import numpy as np

from genome_tpu.params import AssemblyParams


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_device_ids: list[int] | None = None) -> None:
    """jax.distributed bootstrap (call before any jax backend use).

    local_device_ids: the local cards this process opens (None = all)."""
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def assemble_multihost(local_reads, params: AssemblyParams | None = None,
                       local_capacity: int | None = None,
                       forbid_replicated: bool = False,
                       phase_times: dict | None = None,
                       ckpt=None, out_path: str | None = None):
    """SPMD entry: every process passes its own read shard; returns the
    full contig list on every process (written out by process 0).

    out_path: when set, the output FASTA is written by THIS call and the
    return value is the total contig count (int) instead of the list.
    On the sharded-emit path every process builds and writes only its
    1/P contig slice (emit local_slice + write_fasta_parallel — the
    stitch+write serial tail parallelizes); fallback paths write via
    process 0. Requires a shared filesystem across processes.

    forbid_replicated: raise instead of taking the replicated-graph
    correctness escape (CI asserts the sharded path is really taken).
    phase_times: optional dict filled with per-phase wall seconds
    (extract/count/build/simplify/final/emit) for the scaling bench.
    ckpt: optional PhaseCheckpointer (SURVEY §5.3-§5.4 distributed): each
    process saves ITS shard of every phase artifact as .npz
    (<phase>.shard<process_id>.npz); on restart a phase is skipped only
    when EVERY process holds a matching artifact (allgathered decision —
    deterministic SPMD control flow), and phases chain (build resumes
    only on top of a resumed count, etc). Fault injection for CI: env
    GENOME_TPU_CRASH_AFTER="<phase>[:<process_id>]" hard-exits that
    process right after the phase artifact is saved.
    """
    import os
    import time as _time
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from genome_tpu.assemble.pipeline import extract_stream, _pow2_at_least
    from genome_tpu.dist.build import make_sharded_build
    from genome_tpu.dist.count import make_sharded_count
    from genome_tpu.graph.contigs import emit_contigs
    from genome_tpu.graph.simplify import final_chain_state, simplify_device
    from genome_tpu.kernels.extract import SENTINEL

    params = params or AssemblyParams()
    pt = phase_times if phase_times is not None else {}
    _t = _time.perf_counter
    from genome_tpu.dist.ledger import LEDGER
    LEDGER.reset_invocations()

    def _mark(name, t0):
        pt[name] = pt.get(name, 0.0) + (_t() - t0)

    devs = jax.devices()  # global, all processes
    S = len(devs)
    mesh = Mesh(np.array(devs), ("shard",))
    n_local_dev = len(jax.local_devices())
    sharding = NamedSharding(mesh, P("shard"))

    def _local_np(garr):
        """This process's rows of a shard-sharded global array."""
        shards = sorted(garr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards])

    def _agreed(flag: bool) -> bool:
        """True iff every process passes `flag` (allgathered decision)."""
        return bool(multihost_utils.process_allgather(
            jnp.asarray([1 if flag else 0])).min() == 1)

    def _crash_hook(phase: str) -> None:
        want = os.environ.get("GENOME_TPU_CRASH_AFTER", "")
        if not want:
            return
        ph, _, pid = want.partition(":")
        if ph == phase and (pid == "" or int(pid) == jax.process_index()):
            os.write(2, f"[genome_tpu.dist] injected crash after "
                        f"{phase}\n".encode())
            os._exit(7)

    # --- count phase (resume: skip extraction too — its only consumer) ---
    ck = ckpt.load("dist_count") if ckpt is not None else None
    if _agreed(ck is not None):
        local_cap = int(ck["meta"][0])
        th = jax.make_array_from_process_local_data(sharding, ck["th"])
        tl = jax.make_array_from_process_local_data(sharding, ck["tl"])
        cnts = jax.make_array_from_process_local_data(sharding, ck["cnts"])
        n_uni = jax.make_array_from_process_local_data(sharding, ck["n_uni"])
        count_resumed = True
    else:
        count_resumed = False
        # local extraction (DP over this host's reads)
        t0 = _t()
        hi, lo = extract_stream(local_reads, params.k)
        hi, lo = np.asarray(hi), np.asarray(lo)
        _mark("extract", t0)

        # agree on the per-device stream length across processes
        m_dev_local = -(-max(hi.size, 1) // n_local_dev)
        m_dev = int(multihost_utils.process_allgather(
            jnp.asarray([m_dev_local])).max())
        lhi = np.full((n_local_dev * m_dev,), SENTINEL, dtype=np.uint32)
        llo = np.full((n_local_dev * m_dev,), SENTINEL, dtype=np.uint32)
        lhi[: hi.size] = hi
        llo[: lo.size] = lo

        ghi = jax.make_array_from_process_local_data(sharding, lhi)
        glo = jax.make_array_from_process_local_data(sharding, llo)

        # sharded count with overflow retry (flags are global; all
        # processes see the same decision — deterministic SPMD control)
        bucket_cap = max(64, int(1.3 * m_dev / S) + 64)
        local_cap = local_capacity or _pow2_at_least(max(64, m_dev))
        min_cov = jnp.asarray([params.min_coverage], jnp.uint32)
        t0 = _t()
        while True:
            counter = make_sharded_count(mesh, "shard", bucket_cap,
                                         local_cap)
            th, tl, cnts, n_uni, ovf = counter(ghi, glo, min_cov)
            LEDGER.invoke("dist_count")
            if not bool(multihost_utils.process_allgather(
                    ovf, tiled=True).any()):
                break
            bucket_cap *= 2
            local_cap *= 2
        from genome_tpu.dist.count import shrink_tables
        th, tl, cnts, local_cap = shrink_tables(
            mesh, "shard", local_cap, th, tl, cnts, n_uni)
        _mark("count", t0)
        if ckpt is not None:
            ckpt.save("dist_count", th=_local_np(th), tl=_local_np(tl),
                      cnts=_local_np(cnts), n_uni=_local_np(n_uni),
                      meta=np.asarray([local_cap], np.int64))
            _crash_hook("dist_count")

    # --- build phase (resume chains on a resumed count: the checkpoint's
    # table layout is only known to match when both came from disk) ---
    ck = (ckpt.load("dist_build")
          if ckpt is not None and count_resumed else None)
    if _agreed(ck is not None and int(ck["meta"][0]) == local_cap):
        succ = jax.make_array_from_process_local_data(sharding, ck["succ"])
        okv_hi = jax.make_array_from_process_local_data(sharding,
                                                        ck["okv_hi"])
        okv_lo = jax.make_array_from_process_local_data(sharding,
                                                        ck["okv_lo"])
        build_resumed = True
    else:
        build_resumed = False
        query_cap = max(64, int(1.3 * 8 * local_cap / S) + 64)
        t0 = _t()
        while True:
            builder = make_sharded_build(mesh, "shard", params.k, local_cap,
                                         query_cap)
            succ, okv_hi, okv_lo, bovf = builder(th, tl, n_uni)
            LEDGER.invoke("dist_build")
            if not bool(multihost_utils.process_allgather(
                    bovf, tiled=True).any()):
                break
            query_cap *= 2
        _mark("build", t0)
        if ckpt is not None:
            ckpt.save("dist_build", succ=_local_np(succ),
                      okv_hi=_local_np(okv_hi), okv_lo=_local_np(okv_lo),
                      meta=np.asarray([local_cap], np.int64))
            _crash_hook("dist_build")

    # --- sharded simplify over the process-spanning mesh (the same
    # remote-gather pointer-doubling passes as the single-process sharded
    # path; flags are allgathered so every process branches identically)
    from genome_tpu.dist.simplify import final_state_sharded, simplify_sharded

    ck = (ckpt.load("dist_simplify")
          if ckpt is not None and build_resumed else None)
    if _agreed(ck is not None and int(ck["meta"][0]) == local_cap):
        alive_sh = jax.make_array_from_process_local_data(
            sharding, ck["alive"])
        ovf_s = False
    else:
        alive0 = jax.make_array_from_process_local_data(
            sharding, np.ones((n_local_dev * local_cap,), dtype=bool))
        t0 = _t()
        alive_sh, ovf_s = simplify_sharded(mesh, "shard", local_cap, succ,
                                           okv_hi, okv_lo, cnts, alive0,
                                           n_uni, params)
        _mark("simplify", t0)
        if ckpt is not None and not ovf_s:
            ckpt.save("dist_simplify", alive=_local_np(alive_sh),
                      meta=np.asarray([local_cap], np.int64))
            _crash_hook("dist_simplify")

    if not ovf_s:
        # --- sharded final chain state; emission tuples cross to HOST
        # memory only (string assembly is host work; process 0 writes)
        t0 = _t()

        class _FinalRec:  # captures observed fast-final doubling rounds
            def log(self, event, **kw):
                if event == "dist_final_fast_rounds":
                    _final_rounds.update(kw)

        _final_rounds: dict = {}
        head, dist, primary, alive_o, f_ovf = final_state_sharded(
            mesh, "shard", local_cap, succ, okv_hi, okv_lo, cnts,
            alive_sh, n_uni, metrics=_FinalRec())
        _mark("final", t0)
        if not f_ovf:
            # sharded emission: blocks routed by hash(head, dist//B);
            # only packed bases + per-block records reach host memory.
            # out_path mode: each process builds only its 1/P contig
            # slice and the FASTA write parallelizes too.
            from genome_tpu.dist.emit import (emit_contigs_sharded,
                                              write_fasta_parallel)
            sl = ((jax.process_index(), jax.process_count())
                  if out_path is not None else None)
            t0 = _t()
            contigs, ok = emit_contigs_sharded(
                mesh, "shard", local_cap, head, dist, primary, alive_o,
                okv_hi, okv_lo, params.k, params.min_contig_len,
                local_slice=sl)
            if not ok:
                fs = dict(
                    head=multihost_utils.process_allgather(head, tiled=True),
                    dist=multihost_utils.process_allgather(dist, tiled=True),
                    primary=multihost_utils.process_allgather(primary,
                                                              tiled=True),
                    alive_o=multihost_utils.process_allgather(alive_o,
                                                              tiled=True),
                )
                okh_h = multihost_utils.process_allgather(okv_hi, tiled=True)
                okl_h = multihost_utils.process_allgather(okv_lo, tiled=True)
                contigs = emit_contigs(fs, okh_h, okl_h, params.k,
                                       params.min_contig_len,
                                       node_primary=True)
            _mark("emit", t0)
            pt["exchange_ledger"] = dict(LEDGER.summary(),
                                         final_fast_rounds=_final_rounds)
            if out_path is None:
                return contigs
            t0 = _t()
            if ok:
                total = write_fasta_parallel(out_path, contigs)
            else:
                if jax.process_index() == 0:
                    from genome_tpu.io import write_fasta
                    write_fasta(out_path, contigs)
                multihost_utils.process_allgather(jnp.asarray([0]))
                total = len(contigs)
            _mark("write", t0)
            return total

    if forbid_replicated:
        raise RuntimeError(
            "sharded simplify/final overflowed after all retries and the "
            "replicated correctness escape is forbidden")

    # correctness escape: replicate the surviving graph on every process,
    # simplify locally (only reached when the retry ladders exhausted)
    succ_g = multihost_utils.process_allgather(succ, tiled=True)
    okv_hi_g = multihost_utils.process_allgather(okv_hi, tiled=True)
    okv_lo_g = multihost_utils.process_allgather(okv_lo, tiled=True)
    cnts_g = multihost_utils.process_allgather(cnts, tiled=True)
    n_loc = multihost_utils.process_allgather(n_uni, tiled=True)

    dev0 = jax.local_devices()[0]
    succ_j = jax.device_put(np.asarray(succ_g), dev0)
    okh_j = jax.device_put(np.asarray(okv_hi_g), dev0)
    okl_j = jax.device_put(np.asarray(okv_lo_g), dev0)
    cnt_j = jax.device_put(np.asarray(cnts_g), dev0)
    n_loc = np.asarray(n_loc)
    valid = (np.arange(S * local_cap).reshape(S, local_cap)
             % local_cap < n_loc[:, None]).reshape(-1)
    valid_j = jax.device_put(valid, dev0)
    alive = jnp.ones((S * local_cap,), dtype=jnp.bool_)
    alive = simplify_device(succ_j, okh_j, okl_j, cnt_j, alive, valid_j,
                            params)
    fs = final_chain_state(succ_j, okh_j, okl_j, cnt_j, alive, valid_j)
    contigs = emit_contigs(fs, okh_j, okl_j, params.k, params.min_contig_len)
    if out_path is not None:
        if jax.process_index() == 0:
            from genome_tpu.io import write_fasta
            write_fasta(out_path, contigs)
        multihost_utils.process_allgather(jnp.asarray([0]))
        return len(contigs)
    return contigs
