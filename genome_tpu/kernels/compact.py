"""Stream compaction: keep the flagged elements of a stream, densely and in
order (SURVEY.md §2.4 T1).

One exclusive prefix sum of the flags gives every flagged element its
output slot; one scatter with unique indices writes it there. XLA lowers
both as bandwidth-bound passes, so this is plain `jnp`. Used by k-mer RLE
counting (run heads, coverage filter), graph build, the walk-based
simplify passes, contig emission and the sharded programs (it is plain
`jnp`, so it runs unchanged inside `shard_map`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

I32 = jnp.int32


def compact(flags, arrays, capacity: int):
    """Dense, in-order extraction of flagged stream elements.

    Args:
      flags: bool/int (n,) marks; nonzero = keep.
      arrays: tuple of (n,) carried arrays (any dtype).
      capacity: static output size.

    Returns (outs, pos, total, overflow): outs[i][:total] = arrays[i] at
    the flagged positions (ascending), pos[:total] = those positions
    (int32), total = flagged count (int32, may exceed capacity),
    overflow = total > capacity. When overflowing, the first `capacity`
    flagged elements are kept. Slots past total hold 0.
    """
    # the scope name is how scripts/trace_count_build.py finds these ops
    with jax.named_scope("compact"):
        flags = flags.astype(jnp.bool_)
        dest = jnp.cumsum(flags.astype(I32)) - 1
        scat = jnp.where(flags & (dest < capacity), dest, capacity)
        n = flags.shape[0]
        pos = jnp.zeros((capacity,), I32).at[scat].set(
            jnp.arange(n, dtype=I32), mode="drop")
        outs = tuple(jnp.zeros((capacity,), a.dtype).at[scat].set(
            a, mode="drop") for a in arrays)
        total = dest[-1] + 1 if n else jnp.int32(0)
        return outs, pos, total, total > capacity
