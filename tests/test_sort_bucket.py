"""Bucket-partition sort vs XLA sort — same counting results, valid
sorter contract output (SURVEY.md §4 kernel tier)."""

import numpy as np
import pytest

from genome_tpu.io import random_genome, simulate_reads
from genome_tpu.kernels import (count_kmers_device, extract_canonical_kmers,
                                pack_reads, u64)
from genome_tpu.kernels.extract import SENTINEL
from genome_tpu.kernels.sort_bucket import bucket_partition_sort, count_kmers_bucket


def _stream(k=21, seed=19, glen=1200):
    reads = simulate_reads(random_genome(glen, seed=seed), read_len=80,
                           coverage=8, error_rate=0.02, seed=seed + 1)
    reads[0] = reads[0][:10] + "N" + reads[0][11:]
    return extract_canonical_kmers(pack_reads(reads), k)


@pytest.mark.parametrize("k,row,bits", [(21, 512, 6), (21, 1024, 10),
                                        (15, 256, 4), (31, 512, 8)])
def test_bucket_sort_contract(k, row, bits):
    import jax.numpy as jnp
    hi, lo = _stream(k=k)
    w = jnp.ones(hi.shape, jnp.uint32)
    sh, sl, sw, ovf = bucket_partition_sort(hi, lo, w, k, bucket_bits=bits,
                                            row=row)
    assert not bool(ovf)
    sh, sl, sw = np.asarray(sh), np.asarray(sl), np.asarray(sw)
    keys = u64.to_u64_np(sh, sl)
    sent = (sh == SENTINEL) & (sl == SENTINEL)
    real = keys[~sent]
    # non-sentinel keys globally ascending (equal keys adjacent)
    assert (np.diff(real.astype(np.uint64)) >= 0).all()
    # weights preserved at real slots; input sentinels dropped, holes 0
    assert (sw[~sent] == 1).all()
    assert int(sw[sent].sum()) == 0
    # multiset of real keys matches the input stream (minus sentinels)
    inp = u64.to_u64_np(np.asarray(hi), np.asarray(lo))
    inp = np.sort(inp[np.asarray(hi) != SENTINEL])
    assert real.size == inp.size and (np.sort(real) == inp).all()


@pytest.mark.parametrize("mincov", [1, 2])
def test_count_bucket_matches_sort(mincov):
    k = 21
    hi, lo = _stream(k=k)
    a = count_kmers_device(hi, lo, mincov, capacity=8192)
    b = count_kmers_bucket(hi, lo, mincov, capacity=8192, k=k,
                           bucket_bits=8, row=512)
    assert not bool(b["overflow"])
    n = int(a["n_unique"])
    assert int(b["n_unique"]) == n
    for key in ("table_hi", "table_lo", "counts"):
        assert (np.asarray(a[key])[:n] == np.asarray(b[key])[:n]).all()


def test_bucket_sort_overflow_flag():
    import jax.numpy as jnp
    hi, lo = _stream(k=21)
    w = jnp.ones(hi.shape, jnp.uint32)
    # seg far smaller than the skewed low buckets -> must flag
    _, _, _, ovf = bucket_partition_sort(hi, lo, w, 21, bucket_bits=2,
                                         row=256, seg=256)
    assert bool(ovf)


def test_bucket_sort_all_sentinel_and_empty():
    import jax.numpy as jnp
    z = jnp.zeros((0,), jnp.uint32)
    res = count_kmers_bucket(z, z, 1, capacity=64, k=21)
    assert int(res["n_unique"]) == 0
    s = jnp.full((1024,), SENTINEL, jnp.uint32)
    res = count_kmers_bucket(s, s, 1, capacity=64, k=21, row=256)
    assert int(res["n_unique"]) == 0 and not bool(res["overflow"])


def _np_count(hi, lo):
    keys = u64.to_u64_np(hi, lo)
    return np.unique(keys[hi != SENTINEL], return_counts=True)


def _check_bucket(hi, lo, k, **kw):
    import jax.numpy as jnp
    res = count_kmers_bucket(jnp.asarray(hi), jnp.asarray(lo), 1,
                             capacity=hi.size, k=k, **kw)
    assert not bool(res["overflow"])
    n = int(res["n_unique"])
    uk, uc = _np_count(hi, lo)
    assert n == uk.size
    got = u64.to_u64_np(np.asarray(res["table_hi"])[:n],
                        np.asarray(res["table_lo"])[:n])
    assert np.array_equal(got, uk)
    assert np.array_equal(np.asarray(res["counts"])[:n], uc)


def test_count_bucket_skewed_keys():
    # 90% of the keys in the lowest 1/64 of the key space
    rng = np.random.default_rng(31)
    k, n = 21, 8192
    top = 1 << (2 * k - 32)
    hi = np.where(rng.random(n) < 0.9, 0,
                  rng.integers(0, top, size=n)).astype(np.uint32)
    lo = rng.integers(0, 1 << 16, size=n, dtype=np.uint32)
    _check_bucket(hi, lo, k, bucket_bits=6, row=256, seg=8192)


def test_count_bucket_all_keys_in_one_bucket():
    rng = np.random.default_rng(32)
    k, n = 21, 4096
    hi = np.zeros(n, np.uint32)
    lo = rng.integers(0, 1 << 10, size=n, dtype=np.uint32)
    _check_bucket(hi, lo, k, bucket_bits=4, row=256, seg=4096)


def test_count_bucket_overflow_flag():
    # every key lands in bucket 0; a per-bucket region far smaller than
    # the stream must raise the overflow flag, not truncate silently
    import jax.numpy as jnp
    n = 4096
    z = jnp.zeros((n,), jnp.uint32)
    lo = jnp.arange(n, dtype=jnp.uint32)
    res = count_kmers_bucket(z, lo, 1, capacity=n, k=21, bucket_bits=4,
                             row=256, seg=256)
    assert bool(res["overflow"])
