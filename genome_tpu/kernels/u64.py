"""64-bit k-mer arithmetic as uint32 pairs (SEMANTICS.md §1).

Device code runs without JAX's 64-bit mode, so everything here is (hi, lo)
uint32 pairs with the
packed k-mer value `hi * 2^32 + lo`. All shift amounts are Python ints
(static under jit). Mirrors genome_tpu.utils.dna uint64 host ops.
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32


def from_u64_np(x):
    """Host helper: numpy uint64 array -> (hi, lo) uint32 arrays."""
    import numpy as np
    x = np.asarray(x, dtype=np.uint64)
    return (x >> np.uint64(32)).astype(np.uint32), (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def to_u64_np(hi, lo):
    """Host helper: (hi, lo) uint32 arrays -> numpy uint64 array."""
    import numpy as np
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)


def shl(hi, lo, s: int):
    """(hi,lo) << s for static 0 <= s < 64."""
    if s == 0:
        return hi, lo
    if s >= 32:
        return (lo << U32(s - 32)) if s > 32 else lo, jnp.zeros_like(lo)
    return (hi << U32(s)) | (lo >> U32(32 - s)), lo << U32(s)


def shr(hi, lo, s: int):
    """(hi,lo) >> s for static 0 <= s < 64."""
    if s == 0:
        return hi, lo
    if s >= 32:
        return jnp.zeros_like(hi), (hi >> U32(s - 32)) if s > 32 else hi
    return hi >> U32(s), (lo >> U32(s)) | (hi << U32(32 - s))


def lt(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al < bl))


def le(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al <= bl))


def eq(ah, al, bh, bl):
    return (ah == bh) & (al == bl)


def select(cond, ah, al, bh, bl):
    return jnp.where(cond, ah, bh), jnp.where(cond, al, bl)


def minimum(ah, al, bh, bl):
    return select(lt(ah, al, bh, bl), ah, al, bh, bl)


def _rev2_32(x):
    """Reverse the sixteen 2-bit groups within each uint32 lane."""
    m2, m4, m8 = U32(0x33333333), U32(0x0F0F0F0F), U32(0x00FF00FF)
    x = ((x >> U32(2)) & m2) | ((x & m2) << U32(2))
    x = ((x >> U32(4)) & m4) | ((x & m4) << U32(4))
    x = ((x >> U32(8)) & m8) | ((x & m8) << U32(8))
    x = (x >> U32(16)) | (x << U32(16))
    return x


def revcomp(hi, lo, k: int):
    """Reverse complement of packed k-mers (pair form), matches
    genome_tpu.utils.dna.revcomp_u64."""
    ch, cl = ~hi, ~lo
    # reverse 2-bit groups of the 64-bit word: swap words, reverse within
    rh, rl = _rev2_32(cl), _rev2_32(ch)
    return shr(rh, rl, 64 - 2 * k)


def canonical(hi, lo, k: int):
    """min(kmer, revcomp(kmer)) elementwise (SEMANTICS §2)."""
    rh, rl = revcomp(hi, lo, k)
    return minimum(hi, lo, rh, rl)
