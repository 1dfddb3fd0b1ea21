"""T1 alternative: batched open-addressing HBM hash table counting
(a cuckoo-style table in device memory; SURVEY.md §2.4).

This is the direct structural analog of the reference's `DNAMap`
open-addressing hashmap, reformulated for a SIMD machine with no atomics:
instead of per-element probe loops, whole batches insert in lock-step
*rounds*. Each round every pending element probes one slot
(linear probing by round offset); matches accumulate via scatter-add
(duplicate-index adds are well-defined), empty slots are claimed by
scatter-min of element index (unique winner), and losers advance their
probe offset. Rounds iterate under lax.while_loop until all elements land
(bounded by max_rounds -> overflow flag; retry with larger capacity).

The sort-based counter (kernels.count) is the default/fast path; this one
exists for parity with the reference design space and as the better
choice when the stream is much larger than the unique set.
Output contract matches count_kmers_device (sorted, filtered, compacted).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from genome_tpu.dist.partition import _fmix32_jnp
from genome_tpu.kernels.count import count_weighted
from genome_tpu.kernels.extract import SENTINEL

I32 = jnp.int32
U32 = jnp.uint32


@functools.partial(jax.jit, static_argnames=("capacity", "max_rounds"))
def count_kmers_hashtable(hi, lo, min_coverage, capacity: int,
                          max_rounds: int = 64):
    """Canonical k-mer stream -> sorted unique table via HBM hash table.

    capacity must be a power of two and should be >= 2x the expected
    unique count (open addressing needs load factor headroom).
    """
    assert capacity & (capacity - 1) == 0, "capacity must be a power of 2"
    m = hi.shape[0]
    if m == 0:
        z = jnp.zeros((capacity,), dtype=U32)
        return dict(table_hi=z, table_lo=z, counts=z,
                    n_unique=jnp.int32(0), overflow=jnp.bool_(False))

    idx = jnp.arange(m, dtype=I32)
    h0 = _fmix32_jnp(lo ^ (hi * U32(0xC2B2AE35)))
    done0 = hi == SENTINEL  # invalid windows never insert

    t_hi0 = jnp.full((capacity,), SENTINEL, dtype=U32)
    t_lo0 = jnp.full((capacity,), SENTINEL, dtype=U32)
    t_cnt0 = jnp.zeros((capacity,), dtype=U32)
    p0 = jnp.zeros((m,), dtype=U32)

    def cond(carry):
        _, _, _, _, done, r = carry
        return (~done.all()) & (r < max_rounds)

    def body(carry):
        t_hi, t_lo, t_cnt, p, done, r = carry
        slot = ((h0 + p) & U32(capacity - 1)).astype(I32)
        cur_hi, cur_lo = t_hi[slot], t_lo[slot]
        match = (~done) & (cur_hi == hi) & (cur_lo == lo)
        t_cnt = t_cnt.at[slot].add(jnp.where(match, U32(1), U32(0)))
        done = done | match
        empty = (~done) & (cur_hi == SENTINEL) & (cur_lo == SENTINEL)
        claim = jnp.full((capacity,), m, dtype=I32).at[
            jnp.where(empty, slot, capacity)].min(idx, mode="drop")
        winner = empty & (claim[slot] == idx)
        wslot = jnp.where(winner, slot, capacity)
        t_hi = t_hi.at[wslot].set(hi, mode="drop")
        t_lo = t_lo.at[wslot].set(lo, mode="drop")
        # advance only if the slot (after this round's claims) does NOT
        # hold our key — winners and same-key claim losers both stay and
        # match next round; advancing them would insert duplicate keys
        stays = (t_hi[slot] == hi) & (t_lo[slot] == lo)
        p = jnp.where((~done) & (~stays), p + 1, p)
        return t_hi, t_lo, t_cnt, p, done, r + 1

    t_hi, t_lo, t_cnt, _, done, _ = jax.lax.while_loop(
        cond, body, (t_hi0, t_lo0, t_cnt0, p0, done0, jnp.int32(0)))
    overflow = ~done.all()

    # compact + sort the (unordered) table into the standard contract
    res = count_weighted(t_hi, t_lo, t_cnt, min_coverage, capacity)
    return dict(table_hi=res["table_hi"], table_lo=res["table_lo"],
                counts=res["counts"], n_unique=res["n_unique"],
                overflow=overflow | res["overflow"])
