"""T3: sharded de Bruijn graph build — boundary k-mer exchange
(SURVEY.md §3.4: boundary k-mers exchange via all_to_all).

Each shard owns a sorted local table of canonical k-mers. To build the
successor array it must probe extensions whose canonical form is owned by
*other* shards: queries are bucketed by owner hash, exchanged (all_to_all
#1), answered by a local binary search at the owner, and the response
buffer is exchanged back (all_to_all #2) — positions in the bucket are
preserved, so responses land exactly in their query's slot. This is the
device-mesh mirror of `PartitionedDNAMap`'s cross-host probe.

Global oriented node id: v = 2 * (shard * local_capacity + j) + s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from genome_tpu.dist.count import route_buckets
from genome_tpu.dist.ledger import LEDGER, record_a2a
from genome_tpu.dist.partition import owner_of
from genome_tpu.graph.build import searchsorted_pair
from genome_tpu.kernels import u64
from genome_tpu.kernels.extract import SENTINEL

I32 = jnp.int32
U32 = jnp.uint32


def oriented_values(table_hi, table_lo, k: int):
    """okv arrays [2C]: even = stored k-mer, odd = its reverse complement."""
    rh, rl = u64.revcomp(table_hi, table_lo, k)
    okv_hi = jnp.stack([table_hi, rh], axis=1).reshape(-1)
    okv_lo = jnp.stack([table_lo, rl], axis=1).reshape(-1)
    return okv_hi, okv_lo


def make_sharded_build(mesh: Mesh, axis: str, k: int, local_capacity: int,
                       query_cap: int):
    """Builds the jitted sharded graph-build program.

    In:  table_hi/lo/n_unique from make_sharded_count (global shapes).
    Out: succ [num_shards * 2*local_capacity, 4] int32 with *global*
         oriented ids, okv_hi/lo (same sharded layout), overflow [S].
    """
    num_shards = mesh.shape[axis]
    cl = local_capacity

    def shard_fn(table_hi, table_lo, n_loc):
        LEDGER.program("dist_build")
        table_hi, table_lo = table_hi.reshape(-1), table_lo.reshape(-1)
        me = jax.lax.axis_index(axis)
        n = n_loc.reshape(())
        ids = jnp.arange(cl, dtype=I32)
        valid_node = ids < n
        okv_hi, okv_lo = oriented_values(table_hi, table_lo, k)
        valid_o = jnp.repeat(valid_node, 2)

        # extension queries: 2*cl oriented nodes x 4 bases -> canonical
        sh, sl = u64.shl(okv_hi, okv_lo, 2)
        if k > 16:
            sh = sh & U32((1 << (2 * k - 32)) - 1)
        else:
            sh = jnp.zeros_like(sh)
            sl = sl & U32((1 << (2 * k)) - 1) if k < 16 else sl
        q_hi, q_lo, q_orient, q_valid = [], [], [], []
        for b in range(4):
            eh, el = sh, sl | U32(b)
            ch, cl_ = u64.canonical(eh, el, k)
            q_hi.append(ch)
            q_lo.append(cl_)
            q_orient.append((~u64.eq(eh, el, ch, cl_)).astype(I32))
            q_valid.append(valid_o)
        q_hi = jnp.concatenate(q_hi)       # [8*cl], base-major
        q_lo = jnp.concatenate(q_lo)
        q_orient = jnp.concatenate(q_orient)
        q_valid = jnp.concatenate(q_valid)

        own = jnp.where(q_valid, owner_of(q_hi, q_lo, num_shards), num_shards)
        (rq_hi, rq_lo), send_pos, ovf = route_buckets(
            (q_hi, q_lo), own, num_shards, query_cap, axis)

        # answer received queries against the local table
        pos = searchsorted_pair(table_hi, table_lo, n, rq_hi, rq_lo)
        pos_c = jnp.minimum(pos, cl - 1)
        found = (pos < n) & u64.eq(table_hi[pos_c], table_lo[pos_c],
                                   rq_hi, rq_lo) & (rq_hi != SENTINEL)
        resp = jnp.where(found, (me.astype(I32) * cl + pos_c), -1)
        # responses ride the same bucket layout back (uint32 for transport)
        resp_buf = resp.astype(U32).reshape(num_shards, query_cap)
        back = jax.lax.all_to_all(resp_buf, axis, split_axis=0,
                                  concat_axis=0, tiled=True)
        record_a2a(1, num_shards, num_shards * query_cap)
        back = back.reshape(-1).astype(I32)

        # gather each query's response from its send slot
        g = jnp.where((send_pos >= 0) & q_valid,
                      back[jnp.clip(send_pos, 0, None)], -1)
        succ_flat = jnp.where(g >= 0, 2 * g + q_orient, -1)
        succ = succ_flat.reshape(4, 2 * cl).T  # [2*cl, 4]
        # overflow means some queries were dropped: result unusable
        return succ, okv_hi, okv_lo, ovf[None]

    fn = jax.shard_map(shard_fn, mesh=mesh, check_vma=False,
                       in_specs=(P(axis), P(axis), P(axis)),
                       out_specs=(P(axis), P(axis), P(axis), P(axis)))
    return jax.jit(fn)
