"""Device (jit) k-mer extraction + counting vs golden NumPy oracle
(SURVEY.md §4 tier 2). Runs on the CPU backend via conftest env."""

import numpy as np
import pytest

from genome_tpu.golden import count_canonical_kmers
from genome_tpu.io import random_genome, simulate_reads
from genome_tpu.kernels import count_kmers_device, extract_canonical_kmers, pack_reads
from genome_tpu.kernels import u64
from genome_tpu.kernels.extract import SENTINEL
from genome_tpu.utils import dna


@pytest.mark.parametrize("k", [5, 15, 17, 21, 31])
def test_pair_revcomp_matches_numpy(k):
    rng = np.random.default_rng(k)
    v = rng.integers(0, 1 << (2 * k), size=500, dtype=np.uint64)
    hi, lo = u64.from_u64_np(v)
    import jax.numpy as jnp
    rh, rl = u64.revcomp(jnp.asarray(hi), jnp.asarray(lo), k)
    got = u64.to_u64_np(np.asarray(rh), np.asarray(rl))
    assert (got == dna.revcomp_u64(v, k)).all()


@pytest.mark.parametrize("k", [11, 21, 31])
def test_extract_matches_host(k):
    reads = simulate_reads(random_genome(400, seed=k), read_len=60, coverage=5,
                           error_rate=0.01, seed=k + 1)
    reads[0] = reads[0][:20] + "N" + reads[0][21:]  # invalid window coverage
    reads.append("ACGT")  # shorter than k
    codes = pack_reads(reads)
    hi, lo = extract_canonical_kmers(codes, k)
    got = u64.to_u64_np(np.asarray(hi), np.asarray(lo))
    got = np.sort(got[got != ((0xFFFFFFFF << 32) | 0xFFFFFFFF)])
    expect = np.sort(np.concatenate(
        [dna.canonical_kmers_of_read(r, k) for r in reads]))
    assert got.size == expect.size and (got == expect).all()


@pytest.mark.parametrize("mincov", [1, 2, 3])
def test_count_matches_golden(mincov):
    k = 21
    reads = simulate_reads(random_genome(1000, seed=3), read_len=80, coverage=12,
                           error_rate=0.02, seed=4)
    codes = pack_reads(reads)
    hi, lo = extract_canonical_kmers(codes, k)
    res = count_kmers_device(hi, lo, mincov, capacity=hi.shape[0])
    n = int(res["n_unique"])
    assert not bool(res["overflow"])
    got_k = u64.to_u64_np(np.asarray(res["table_hi"][:n]), np.asarray(res["table_lo"][:n]))
    got_c = np.asarray(res["counts"][:n])
    exp_k, exp_c = count_canonical_kmers(reads, k, mincov)
    assert got_k.size == exp_k.size
    assert (got_k == exp_k).all()
    assert (got_c == exp_c).all()
    # sortedness of the output table
    assert (np.diff(got_k) > 0).all()


def test_count_overflow_flag():
    k = 21
    reads = simulate_reads(random_genome(500, seed=5), read_len=60, coverage=5, seed=6)
    codes = pack_reads(reads)
    hi, lo = extract_canonical_kmers(codes, k)
    res = count_kmers_device(hi, lo, 1, capacity=16)
    assert bool(res["overflow"])


def test_count_empty():
    import jax.numpy as jnp
    z = jnp.zeros((0,), dtype=jnp.uint32)
    res = count_kmers_device(z, z, 1, capacity=8)
    assert int(res["n_unique"]) == 0


def test_count_all_same_and_all_distinct():
    import jax.numpy as jnp
    k = 21
    # all-same: one read repeated
    reads = ["ACGTACGTACGTACGTACGTA"] * 7  # exactly one window each
    codes = pack_reads(reads)
    hi, lo = extract_canonical_kmers(codes, k)
    res = count_kmers_device(hi, lo, 1, capacity=4)
    assert int(res["n_unique"]) == 1 and int(res["counts"][0]) == 7
    # all-distinct
    g = random_genome(300, seed=9)
    codes = pack_reads([g])
    hi, lo = extract_canonical_kmers(codes, k)
    res = count_kmers_device(hi, lo, 1, capacity=512)
    exp_k, _ = count_canonical_kmers([g], k, 1)
    assert int(res["n_unique"]) == exp_k.size


def test_streaming_count_matches_oneshot():
    from genome_tpu.assemble.pipeline import count_reads
    from genome_tpu.params import AssemblyParams
    params = AssemblyParams(k=15, min_coverage=2)
    reads = simulate_reads(random_genome(1200, seed=77), read_len=80,
                           coverage=10, error_rate=0.02, seed=78)
    one = count_reads(reads, params)
    few = count_reads(reads, params, max_device_kmers=2000)
    n1, n2 = int(one["n_unique"]), int(few["n_unique"])
    assert n1 == n2
    for key in ("table_hi", "table_lo", "counts"):
        assert (np.asarray(one[key])[:n1] == np.asarray(few[key])[:n2]).all()


def test_merge_tables_weighted():
    import jax.numpy as jnp
    from genome_tpu.kernels.count import merge_tables
    k = 21
    g = random_genome(400, seed=13)
    codes_a = pack_reads([g[:250]])
    codes_b = pack_reads([g[200:]])
    full = pack_reads([g[:250], g[200:]])
    ha, la = extract_canonical_kmers(codes_a, k)
    hb, lb = extract_canonical_kmers(codes_b, k)
    hf, lf = extract_canonical_kmers(full, k)
    ta = count_kmers_device(ha, la, 1, capacity=512)
    tb = count_kmers_device(hb, lb, 1, capacity=512)
    tm = merge_tables(ta, tb, 1, 1024)
    tf = count_kmers_device(hf, lf, 1, capacity=1024)
    n = int(tf["n_unique"])
    assert int(tm["n_unique"]) == n
    for key in ("table_hi", "table_lo", "counts"):
        assert (np.asarray(tm[key])[:n] == np.asarray(tf[key])[:n]).all()


@pytest.mark.parametrize("mincov", [1, 2])
def test_hashtable_counter_matches_sort_counter(mincov):
    from genome_tpu.kernels.hash_table import count_kmers_hashtable
    k = 21
    reads = simulate_reads(random_genome(900, seed=15), read_len=80,
                           coverage=10, error_rate=0.02, seed=16)
    reads[0] = reads[0][:30] + "N" + reads[0][31:]
    codes = pack_reads(reads)
    hi, lo = extract_canonical_kmers(codes, k)
    a = count_kmers_device(hi, lo, mincov, capacity=8192)
    b = count_kmers_hashtable(hi, lo, mincov, capacity=8192)
    assert not bool(a["overflow"]) and not bool(b["overflow"])
    n = int(a["n_unique"])
    assert int(b["n_unique"]) == n
    for key in ("table_hi", "table_lo", "counts"):
        assert (np.asarray(a[key])[:n] == np.asarray(b[key])[:n]).all()


def test_hashtable_overflow_on_tiny_capacity():
    from genome_tpu.kernels.hash_table import count_kmers_hashtable
    k = 21
    g = random_genome(600, seed=17)
    codes = pack_reads([g])
    hi, lo = extract_canonical_kmers(codes, k)
    res = count_kmers_hashtable(hi, lo, 1, capacity=256, max_rounds=8)
    assert bool(res["overflow"])


def test_packed_extract_matches_unpacked():
    import numpy as np
    import jax.numpy as jnp
    from genome_tpu.kernels.extract import (extract_canonical_kmers,
                                            extract_canonical_kmers_packed,
                                            pack_codes_host)
    rng = np.random.default_rng(5)
    for B, L, k in [(8, 50, 11), (16, 104, 21), (3, 23, 7), (5, 64, 31)]:
        codes = rng.integers(0, 5, size=(B, L), dtype=np.uint8)  # incl N
        packed, invalid = pack_codes_host(codes)
        ph, pl = extract_canonical_kmers_packed(
            jnp.asarray(packed), jnp.asarray(invalid), k, L)
        eh, el = extract_canonical_kmers(jnp.asarray(codes), k)
        assert (np.asarray(ph) == np.asarray(eh)).all()
        assert (np.asarray(pl) == np.asarray(el)).all()


def _unique_oracle(hi, lo, mincov=1):
    """np.unique reference for count_kmers_device (sentinels dropped)."""
    keys = u64.to_u64_np(hi, lo)
    keys = keys[~((hi == SENTINEL) & (lo == SENTINEL))]
    uk, uc = np.unique(keys, return_counts=True)
    keep = uc >= mincov
    return uk[keep], uc[keep]


def _check_count(hi, lo, mincov=1, capacity=None):
    import jax.numpy as jnp
    res = count_kmers_device(jnp.asarray(hi), jnp.asarray(lo), mincov,
                             capacity=capacity or hi.size)
    assert not bool(res["overflow"])
    n = int(res["n_unique"])
    exp_k, exp_c = _unique_oracle(hi, lo, mincov)
    assert n == exp_k.size
    got = u64.to_u64_np(np.asarray(res["table_hi"])[:n],
                        np.asarray(res["table_lo"])[:n])
    assert np.array_equal(got, exp_k)
    assert np.array_equal(np.asarray(res["counts"])[:n], exp_c)
    # slots past n_unique are zero
    assert not np.asarray(res["counts"])[n:].any()


@pytest.mark.parametrize("nblocks", [1, 2, 3, 4, 5, 8, 11])
def test_count_device_matches_np_unique(nblocks):
    # streams of 512-element blocks: odd and non-power-of-two lengths
    rng = np.random.default_rng(nblocks)
    n = nblocks * 512
    hi = rng.integers(0, 1 << 10, size=n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 12, size=n, dtype=np.uint32)
    _check_count(hi, lo)


def test_count_device_with_sentinels():
    rng = np.random.default_rng(9)
    n = 3 * 512
    hi = rng.integers(0, 1 << 10, size=n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    hi[::7] = SENTINEL
    lo[::7] = SENTINEL
    _check_count(hi, lo)


def test_count_device_duplicates_and_ties():
    # heavy ties on hi, few distinct keys: long runs
    rng = np.random.default_rng(10)
    n = 6 * 512
    hi = rng.integers(0, 4, size=n, dtype=np.uint32)
    lo = rng.integers(0, 8, size=n, dtype=np.uint32)
    _check_count(hi, lo, mincov=50, capacity=64)


def test_count_device_all_sentinel():
    s = np.full(1024, SENTINEL, np.uint32)
    _check_count(s, s, capacity=16)
