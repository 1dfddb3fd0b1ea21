"""T3: hash partition of the canonical k-mer key space (SEMANTICS §6b).

Reference analog: `PartitionedDNAMap`'s `owner(kmer) = hash(kmer) mod P`
(SURVEY.md §2.1 R4). Pin: murmur3 fmix32 over the mixed
uint32 pair; P must be a power of two. The choice is output-invisible
(contigs are P-invariant) but must be identical across shards.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def _fmix32_jnp(x):
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(_C1)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(_C2)
    x = x ^ (x >> jnp.uint32(16))
    return x


def owner_of(hi, lo, num_shards: int):
    """jnp: shard owning each (hi, lo) canonical k-mer."""
    assert num_shards & (num_shards - 1) == 0, "num_shards must be a power of 2"
    mixed = lo ^ (hi * jnp.uint32(_C2))
    return (_fmix32_jnp(mixed) & jnp.uint32(num_shards - 1)).astype(jnp.int32)


def _fmix32_np(x):
    x = x ^ (x >> np.uint32(16))
    x = (x * np.uint32(_C1)).astype(np.uint32)
    x = x ^ (x >> np.uint32(13))
    x = (x * np.uint32(_C2)).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    return x


def owner_of_np(kmers_u64, num_shards: int):
    """NumPy twin of owner_of, for tests/host planning."""
    assert num_shards & (num_shards - 1) == 0
    k = np.asarray(kmers_u64, dtype=np.uint64)
    hi = (k >> np.uint64(32)).astype(np.uint32)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    mixed = lo ^ (hi * np.uint32(_C2)).astype(np.uint32)
    return (_fmix32_np(mixed) & np.uint32(num_shards - 1)).astype(np.int32)
