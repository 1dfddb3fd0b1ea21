"""T1: k-mer counting on device = sort + segmented reduce (SURVEY.md §2.4).

This replaces the reference's `DNAMap` open-addressing insert loop:
instead of random-probe hash inserts (memory-latency-bound), the whole
k-mer stream is sorted and counted by run-length encoding — streaming,
bandwidth-bound work.

The default path uses XLA's lax.sort (two-key lexicographic on the uint32
pair); other sorters (kernels.sort_bucket) drop in via the `sorter`
hook. Sorter contract: equal keys adjacent, non-sentinel keys in
ascending order; SENTINEL slots may appear anywhere (bucket sorters leave
sentinel-padded holes between regions) — the RLE pass filters them by
value, which is safe because (0xFFFFFFFF, 0xFFFFFFFF) can never be a
*canonical* k-mer for any k <= 32 (the all-T k-mer canonicalizes to
all-A).

`count_weighted` additionally merges pre-counted tables (streaming /
bounded-memory counting: per-chunk tables merge with weights = counts).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from genome_tpu.kernels.compact import compact
from genome_tpu.kernels.extract import SENTINEL

U32 = jnp.uint32


def sort_pairs_xla(hi: jax.Array, lo: jax.Array, *extra):
    """Lexicographic sort of the (hi, lo) key pair, carrying extras along."""
    return jax.lax.sort((hi, lo) + extra, num_keys=2)


@functools.partial(jax.jit, static_argnames=("capacity", "sorter"))
def count_weighted(
    hi: jax.Array,
    lo: jax.Array,
    weights: jax.Array,
    min_coverage: jax.Array | int,
    capacity: int,
    sorter=None,
):
    """Weighted canonical k-mer stream -> sorted unique table (filtered).

    Args:
      hi, lo: flat uint32 pair stream (SENTINEL = invalid slots).
      weights: uint32 multiplicity per slot (1 for raw windows; existing
        counts when merging tables).
      min_coverage: final count threshold (SEMANTICS §2). Use 1 when the
        result will be merged further (thresholding is only correct on
        complete counts).
      capacity: static output size; `overflow` set if the run count
        (including sentinel runs) exceeds it — retry bigger (SURVEY §7).
      sorter: optional (hi, lo, w) -> sorted (hi, lo, w); default XLA sort.

    Returns dict: table_hi/table_lo/counts [capacity], n_unique (int32),
    overflow (bool).
    """
    m = hi.shape[0]
    if m == 0:
        z = jnp.zeros((capacity,), dtype=U32)
        return dict(table_hi=z, table_lo=z, counts=z,
                    n_unique=jnp.int32(0), overflow=jnp.bool_(False))
    if sorter is None:
        shi, slo, sw = sort_pairs_xla(hi, lo, weights)
    else:
        shi, slo, sw = sorter(hi, lo, weights)

    first = jnp.concatenate([
        jnp.ones((1,), dtype=jnp.bool_),
        (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1]),
    ])
    run_id = jnp.cumsum(first.astype(jnp.int32)) - 1
    counts = jax.ops.segment_sum(sw.astype(U32), run_id,
                                 num_segments=capacity)
    (run_hi, run_lo), _, n_runs_total, overflow = compact(
        first, (shi, slo), capacity)

    ridx = jnp.arange(capacity, dtype=jnp.int32)
    valid = ((ridx < n_runs_total) & (run_hi != SENTINEL)
             & (counts >= jnp.asarray(min_coverage, U32)))
    # compact surviving runs to the front (stays sorted: stable positions)
    (table_hi, table_lo, out_counts), _, n_unique, _ = compact(
        valid, (run_hi, run_lo, counts), capacity)
    return dict(table_hi=table_hi, table_lo=table_lo, counts=out_counts,
                n_unique=n_unique, overflow=overflow)


@functools.partial(jax.jit, static_argnames=("capacity", "sorter"))
def count_kmers_device(
    hi: jax.Array,
    lo: jax.Array,
    min_coverage: jax.Array | int,
    capacity: int,
    sorter=None,
):
    """Unweighted counting (every slot multiplicity 1).

    Fast path for the raw window stream: sorts only the (hi, lo) key pair
    (no all-ones weight array rides through the sort — a third sort operand
    is one more word through every sort pass) and derives run counts
    from head-position differences instead of a segment_sum scatter-add.
    Position-diff counting is hole-safe under the sorter contract: a
    SENTINEL padding region always starts its own run, so the last real run
    in a bucket ends at the padding head, and sentinel runs are dropped by
    the validity mask exactly as in count_weighted.

    sorter: optional (hi, lo) -> sorted (hi, lo); default two-key XLA sort.
    Same return contract as count_weighted.
    """
    m = hi.shape[0]
    if m == 0:
        z = jnp.zeros((capacity,), dtype=U32)
        return dict(table_hi=z, table_lo=z, counts=z,
                    n_unique=jnp.int32(0), overflow=jnp.bool_(False))
    if sorter is None:
        shi, slo = jax.lax.sort((hi, lo), num_keys=2)
    else:
        shi, slo = sorter(hi, lo)

    first = jnp.concatenate([
        jnp.ones((1,), dtype=jnp.bool_),
        (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1]),
    ])
    ridx = jnp.arange(capacity, dtype=jnp.int32)
    # run heads by position; a run's count is the distance to the next head
    _, starts, n_runs_total, overflow = compact(first, (), capacity)
    in_range = ridx < n_runs_total
    ends_next = jnp.concatenate([starts[1:], jnp.full((1,), m, jnp.int32)])
    ends = jnp.where(ridx + 1 < n_runs_total, ends_next, m)
    counts = jnp.where(in_range, ends - starts, 0).astype(U32)
    # keys by a capacity-sized gather from the head positions (no
    # stream-sized key scatter)
    pos_c = jnp.minimum(starts, m - 1)
    run_hi = jnp.where(in_range, shi[pos_c], 0)
    run_lo = jnp.where(in_range, slo[pos_c], 0)

    valid = (in_range & (run_hi != SENTINEL)
             & (counts >= jnp.asarray(min_coverage, U32)))
    (table_hi, table_lo, out_counts), _, n_unique, _ = compact(
        valid, (run_hi, run_lo, counts), capacity)
    return dict(table_hi=table_hi, table_lo=table_lo, counts=out_counts,
                n_unique=n_unique, overflow=overflow)


@jax.jit
def filter_table(t: dict, min_coverage):
    """Apply the final coverage threshold to a complete counted table."""
    cap = t["table_hi"].shape[0]
    ridx = jnp.arange(cap, dtype=jnp.int32)
    valid = ((ridx < t["n_unique"])
             & (t["counts"] >= jnp.asarray(min_coverage, U32)))
    (th, tl, tc), _, n_unique, _ = compact(
        valid, (t["table_hi"], t["table_lo"], t["counts"]), cap)
    return dict(table_hi=th, table_lo=tl, counts=tc, n_unique=n_unique,
                overflow=t["overflow"])


@functools.partial(jax.jit, static_argnames=("capacity",))
def merge_tables(a: dict, b: dict, min_coverage, capacity: int):
    """Merge two counted tables (complete or partial counts are summed).

    Inputs are count_weighted-style dicts; invalid slots (index >=
    n_unique) carry count 0 and key (0,0) — they are masked to SENTINEL
    before merging.
    """
    def masked(t):
        cap = t["table_hi"].shape[0]
        v = jnp.arange(cap, dtype=jnp.int32) < t["n_unique"]
        return (jnp.where(v, t["table_hi"], SENTINEL),
                jnp.where(v, t["table_lo"], SENTINEL),
                jnp.where(v, t["counts"], 0))

    ah, al, aw = masked(a)
    bh, bl, bw = masked(b)
    return count_weighted(jnp.concatenate([ah, bh]),
                          jnp.concatenate([al, bl]),
                          jnp.concatenate([aw, bw]),
                          min_coverage, capacity)
