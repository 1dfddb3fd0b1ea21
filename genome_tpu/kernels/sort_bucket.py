"""T1: bucket-partition sort for (hi, lo) k-mer keys (SURVEY.md §2.4).

Sorting k-mer keys doesn't need one global sort: partition the stream into
B value-ordered buckets (top bits of the key), then sort each bucket
independently. The partition needs only small per-row sorts, one
histogram, and one unique-index scatter; the per-bucket sorts are batched
small sorts. Whether this beats XLA's global sort on a device is a
measurement (the `--counter bucket` engine).

Output contract (kernels.count sorter contract): non-sentinel keys in
globally ascending order, equal keys adjacent; SENTINEL-padded holes may
appear at bucket tails (the RLE counter filters them by value).

Skew note: canonical k-mers are value-skewed (min(x, rc(x)) biases low),
so per-bucket capacity `seg` defaults to 4x the average and overflow
raises a retry flag rather than silently truncating.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from genome_tpu.kernels import u64
from genome_tpu.kernels.count import count_weighted
from genome_tpu.kernels.extract import SENTINEL

I32 = jnp.int32
U32 = jnp.uint32


def _identity_sorter(hi, lo, w):
    return hi, lo, w


def default_seg(n: int, bucket_bits: int = 10, row: int = 8192) -> int:
    """Default per-bucket region size: canonical keys skew low (min(x, rc)
    density <= 2x average), 3x average covers skew + noise; multiple of
    256 keeps tiling clean. Heavy-hitter streams (massive duplicates of
    one k-mer) can exceed this — overflow flags a retry with larger seg."""
    B = 1 << bucket_bits
    return max(row, -(-3 * n // (B * 256)) * 256)


def _bucket_ids(hi, lo, k: int, bucket_bits: int):
    """Top `bucket_bits` of the 2k-bit key; sentinels clamp to the last
    bucket (they sort after every real key inside it)."""
    shift = 2 * k - bucket_bits
    _, tl = u64.shr(hi, lo, shift)
    return jnp.minimum(tl, U32((1 << bucket_bits) - 1)).astype(I32)


@functools.partial(jax.jit,
                   static_argnames=("k", "bucket_bits", "row", "seg"))
def bucket_partition_sort(hi, lo, w, k: int, bucket_bits: int = 10,
                          row: int = 8192, seg: int = 0):
    """Returns (hi', lo', w', overflow): sorted-with-holes (see module doc).

    seg: static per-bucket region size (elements); 0 -> 4x average.
    """
    n = hi.shape[0]
    bucket_bits = min(bucket_bits, 2 * k)
    B = 1 << bucket_bits
    if seg == 0:
        seg = default_seg(n, bucket_bits, row)

    nn = -(-n // row) * row
    if nn != n:
        pad = nn - n
        fill = jnp.full((pad,), SENTINEL, dtype=U32)
        hi = jnp.concatenate([hi, fill])
        lo = jnp.concatenate([lo, fill])
        w = jnp.concatenate([w, jnp.zeros((pad,), dtype=w.dtype)])
    T = nn // row

    b = _bucket_ids(hi, lo, k, bucket_bits)
    # sentinels get a virtual bucket B that is never materialized: they
    # sort after real keys per row and are simply dropped by the scatter
    is_sent = (hi == SENTINEL) & (lo == SENTINEL)
    b = jnp.where(is_sent, B, b)
    # per-row stable sort by bucket (small batched sorts)
    sb, sh, sl, sw = jax.lax.sort(
        (b.reshape(T, row), hi.reshape(T, row), lo.reshape(T, row),
         w.reshape(T, row)), dimension=1, num_keys=1)

    # histogram per (row, bucket) and exclusive prefix over rows
    flat_id = (jnp.arange(T, dtype=I32)[:, None] * (B + 1) + sb).reshape(-1)
    hist = jax.ops.segment_sum(jnp.ones((nn,), I32), flat_id,
                               num_segments=T * (B + 1)).reshape(T, B + 1)
    total_b = hist[:, :B].sum(axis=0)
    overflow = (total_b > seg).any()
    pre = jnp.cumsum(hist, axis=0) - hist  # rows before me, same bucket

    # rank within the (row, bucket) run = column - run start
    col = jax.lax.broadcasted_iota(I32, (T, row), 1)
    newrun = jnp.concatenate(
        [jnp.ones((T, 1), bool), sb[:, 1:] != sb[:, :-1]], axis=1)
    runstart = jax.lax.cummax(jnp.where(newrun, col, 0), axis=1)
    rank = col - runstart

    within = jnp.take_along_axis(pre, sb, axis=1) + rank
    ok = (within < seg) & (sb < B)  # drop overflow and sentinel bucket
    dest = jnp.where(ok, sb * seg + within, B * seg).reshape(-1)

    big = B * seg
    out_hi = jnp.full((big,), SENTINEL, dtype=U32).at[dest].set(
        sh.reshape(-1), mode="drop", unique_indices=True)
    out_lo = jnp.full((big,), SENTINEL, dtype=U32).at[dest].set(
        sl.reshape(-1), mode="drop", unique_indices=True)
    out_w = jnp.zeros((big,), dtype=w.dtype).at[dest].set(
        sw.reshape(-1), mode="drop", unique_indices=True)

    # independent per-bucket sorts (batched)
    oh, ol, ow = jax.lax.sort(
        (out_hi.reshape(B, seg), out_lo.reshape(B, seg),
         out_w.reshape(B, seg)), dimension=1, num_keys=2)
    return oh.reshape(-1), ol.reshape(-1), ow.reshape(-1), overflow


@functools.partial(jax.jit, static_argnames=("capacity", "k", "bucket_bits",
                                             "row", "seg"))
def count_kmers_bucket(hi, lo, min_coverage, capacity: int, k: int,
                       bucket_bits: int = 10, row: int = 8192, seg: int = 0):
    """Counting via bucket-partition sort; contract of count_kmers_device."""
    m = hi.shape[0]
    if m == 0:
        z = jnp.zeros((capacity,), dtype=U32)
        return dict(table_hi=z, table_lo=z, counts=z,
                    n_unique=jnp.int32(0), overflow=jnp.bool_(False))
    w = jnp.ones((m,), dtype=U32)
    sh, sl, sw, bovf = bucket_partition_sort(hi, lo, w, k, bucket_bits,
                                             row, seg)
    res = count_weighted(sh, sl, sw, min_coverage, capacity,
                         sorter=_identity_sorter)
    return dict(res, overflow=res["overflow"] | bovf)
