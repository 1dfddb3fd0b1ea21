"""T3: sharded k-mer counting over a device mesh (SURVEY.md §3.4).

Reference analog: `PartitionedDNAMap` inserts routed to owner hosts
Here every shard extracts k-mers from its own
read shard (data parallel), buckets them by owner hash, and one
`all_to_all` over the mesh delivers each bucket to its owner, which then
counts locally with the sort+segmented-reduce kernel. Bucket capacities
are static with overflow flags (ragged all_to_all is capacity-planned,
SURVEY §7).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from genome_tpu.dist.ledger import LEDGER, record_a2a
from genome_tpu.dist.partition import owner_of
from genome_tpu.kernels.count import count_kmers_device
from genome_tpu.kernels.extract import SENTINEL

I32 = jnp.int32
U32 = jnp.uint32


def route_buckets(vals: tuple, owner, num_shards: int, bucket_cap: int,
                  axis: str):
    """Bucket values by owner and exchange via all_to_all.

    Each element of `vals` is a local [M] uint32 array; `owner` is [M] in
    [0, num_shards) or >= num_shards to drop the slot. Returns
    (received tuple of [num_shards * bucket_cap] arrays with SENTINEL in
    empty slots, send_pos [M] int32 flat send-slot per element (-1 if
    dropped), overflow flag).

    all_to_all layout: send row j -> lands on shard j at row = my index,
    same positions; routing back a response buffer restores sender slots.
    """
    m = owner.shape[0]
    owner = jnp.where(owner < num_shards, owner, num_shards)
    # stable sort by owner to get per-bucket dense ranks
    idx = jnp.arange(m, dtype=I32)
    so, sidx = jax.lax.sort((owner, idx), num_keys=1)
    per = jax.ops.segment_sum(jnp.ones((m,), I32), so,
                              num_segments=num_shards + 1)
    start = jnp.concatenate([jnp.zeros((1,), I32), jnp.cumsum(per)[:-1]])
    pos = idx - start[so]  # rank within bucket (sorted order)
    overflow = (per[:num_shards] > bucket_cap).any()
    dest = jnp.where((so < num_shards) & (pos < bucket_cap),
                     so * bucket_cap + pos, num_shards * bucket_cap)
    # send_pos maps original slot -> flat send slot
    send_pos = jnp.full((m,), -1, dtype=I32).at[sidx].set(
        jnp.where(dest < num_shards * bucket_cap, dest, -1), mode="drop")

    # ONE all_to_all for all arrays: buffers are stacked column-wise to
    # [S, len(vals)*cap] so the exchange count is independent of payload
    # arity (same bytes on the wire, k-1 fewer collective launches — the
    # latency term that dominates small cross-host rounds). Row i of the result
    # is what shard i sent, with each array in its own column section.
    bufs = []
    for v in vals:
        buf = jnp.full((num_shards * bucket_cap,), SENTINEL, dtype=U32)
        buf = buf.at[dest].set(v[sidx], mode="drop")
        bufs.append(buf.reshape(num_shards, bucket_cap))
    stacked = bufs[0] if len(bufs) == 1 else jnp.concatenate(bufs, axis=1)
    out = jax.lax.all_to_all(stacked, axis, split_axis=0, concat_axis=0,
                             tiled=True)
    # per-shard wire volume = the whole [S, len*cap] buffer (row `me`
    # stays local; the crossing fraction is applied in the summary)
    record_a2a(1, num_shards, num_shards * len(vals) * bucket_cap)
    received = tuple(
        out[:, j * bucket_cap : (j + 1) * bucket_cap].reshape(-1)
        for j in range(len(vals)))
    return received, send_pos, overflow


def make_sharded_count(mesh: Mesh, axis: str, bucket_cap: int,
                       local_capacity: int):
    """Builds the jitted sharded counting program.

    In:  hi, lo global [num_shards * M_local] (sharded over `axis`).
    Out: per-shard sorted owned tables, global shapes
         table_hi/lo/counts [num_shards * local_capacity],
         n_unique [num_shards], overflow [num_shards] (any set -> retry).
    """
    num_shards = mesh.shape[axis]

    def shard_fn(hi, lo, min_cov):
        LEDGER.program("dist_count")
        hi, lo = hi.reshape(-1), lo.reshape(-1)
        valid = hi != SENTINEL
        own = jnp.where(valid, owner_of(hi, lo, num_shards), num_shards)
        (rhi, rlo), _, ovf_route = route_buckets(
            (hi, lo), own, num_shards, bucket_cap, axis)
        res = count_kmers_device(rhi, rlo, min_cov[0], local_capacity)
        ovf = ovf_route | res["overflow"]
        return (res["table_hi"], res["table_lo"], res["counts"],
                res["n_unique"][None], ovf[None])

    fn = jax.shard_map(shard_fn, mesh=mesh, check_vma=False,
                       in_specs=(P(axis), P(axis), P()),
                       out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)))
    return jax.jit(fn)


def shrink_tables(mesh: Mesh, axis: str, local_cap: int, th, tl, cnts,
                  n_uni):
    """Compact the per-shard count tables to the smallest pow2 holding
    the largest shard's unique count.

    The count capacity is sized from the k-mer STREAM (reads x windows),
    which at 20-30x coverage is ~10-20x the unique-k-mer count — without
    this, every downstream build/simplify/final sort and exchange pays
    that padding factor. Mirrors the single-host pipeline's pre-build
    table compaction (assemble/pipeline.py cap2). Safe by construction:
    entries beyond n_uni[s] are sentinel padding, and the new capacity
    bounds every shard's n_uni. Multihost-safe (allgathered n_max, same
    decision on every process). Returns (th, tl, cnts, new_local_cap).
    """
    import numpy as _np
    S = mesh.shape[axis]
    if getattr(n_uni, "is_fully_addressable", True):
        n_max = int(_np.asarray(n_uni).max())
    else:
        from jax.experimental import multihost_utils
        n_max = int(multihost_utils.process_allgather(
            n_uni, tiled=True).max())
    cap2 = 1 << max(13, (max(n_max, 1) - 1).bit_length())
    if cap2 >= local_cap:
        return th, tl, cnts, local_cap
    from jax.sharding import NamedSharding
    sh = NamedSharding(mesh, P(axis))
    f = jax.jit(lambda x: x.reshape(S, -1)[:, :cap2].reshape(-1),
                out_shardings=sh)
    return f(th), f(tl), f(cnts), cap2
