"""Stream compaction (kernels/compact.py) vs NumPy oracles."""

import numpy as np
import pytest

import jax.numpy as jnp

from genome_tpu.kernels.compact import compact

# stream and output sizes the cases are built from: multi-tile streams
# with per-tile counts that straddle output-chunk boundaries
TILE = 32768
CHUNK = 1024


@pytest.mark.parametrize("p", [0.0, 0.07, 0.9, 1.0])
def test_compact_flagged_matches_numpy(p):
    rng = np.random.default_rng(int(p * 100) + 2)
    n = TILE
    flags = rng.random(n) < p
    a = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    b = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    cap = ((int(flags.sum()) + CHUNK) // CHUNK + 1) * CHUNK
    (oa, ob), pos, tot, ovf = compact(
        jnp.asarray(flags), (jnp.asarray(a), jnp.asarray(b)), cap)
    idx = np.flatnonzero(flags)
    assert int(tot) == idx.size and not bool(ovf)
    assert np.array_equal(np.asarray(pos)[: idx.size], idx)
    assert np.array_equal(np.asarray(oa)[: idx.size], a[idx])
    assert np.array_equal(np.asarray(ob)[: idx.size], b[idx])
    # slots past the flagged count are zero-filled
    assert not np.asarray(oa)[idx.size:].any()
    assert not np.asarray(pos)[idx.size:].any()


def _compact_case(flag_counts, cap_slack_chunks=2, seed=3):
    """Build an nt-tile input whose per-tile flagged counts are given,
    run the compactor, and check in-order exact extraction against
    NumPy."""
    rng = np.random.default_rng(seed)
    nt = len(flag_counts)
    n = nt * TILE
    flags = np.zeros(n, bool)
    for t, c in enumerate(flag_counts):
        pos = rng.choice(TILE, size=c, replace=False) + t * TILE
        flags[pos] = True
    a = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    b = rng.integers(0, 1 << 31, size=n, dtype=np.int32)
    total = int(flags.sum())
    cap = (total // CHUNK + cap_slack_chunks) * CHUNK
    (oa, ob), pos, tot, ovf = compact(
        jnp.asarray(flags), (jnp.asarray(a), jnp.asarray(b)), cap)
    idx = np.flatnonzero(flags)
    assert int(tot) == idx.size and not bool(ovf)
    assert np.asarray(ob).dtype == np.int32
    assert np.array_equal(np.asarray(pos)[: idx.size], idx)
    assert np.array_equal(np.asarray(oa)[: idx.size], a[idx])
    assert np.array_equal(np.asarray(ob)[: idx.size], b[idx])


# per-tile counts that include a zero-flag tile, a full tile, and counts
# just below, at and above a chunk boundary
_MULTITILE_CASES = [
    (1009, 2027, 4093, 577),          # prime-ish
    (0, 1, TILE, 2048),               # empty tile, singleton, full, aligned
    (CHUNK - 1, 1, CHUNK + 1, 997),   # straddle chunk boundaries
    (3571, 0, 0, 3571, 31),           # gap tiles
]


@pytest.mark.parametrize("counts", _MULTITILE_CASES)
def test_compact_flagged_multitile_carry(counts):
    _compact_case(counts)


def test_compact_flagged_multitile_random():
    rng = np.random.default_rng(11)
    counts = [int(c) for c in rng.integers(0, TILE + 1, size=5)]
    _compact_case(counts, seed=12)


def test_compact_flagged_multitile_overflow():
    # total spills past capacity: overflow flag set, prefix intact
    n = 3 * TILE
    flags = np.ones(n, bool)
    a = np.arange(n, dtype=np.uint32)
    cap = 4 * CHUNK
    (oa,), pos, tot, ovf = compact(jnp.asarray(flags), (jnp.asarray(a),), cap)
    assert bool(ovf) and int(tot) == n
    assert np.array_equal(np.asarray(oa), a[:cap])
    assert np.array_equal(np.asarray(pos), np.arange(cap))


def test_compact_flagged_overflow():
    n = TILE
    flags = np.ones(n, bool)
    a = np.arange(n, dtype=np.uint32)
    (oa,), pos, tot, ovf = compact(
        jnp.asarray(flags), (jnp.asarray(a),), 2 * CHUNK)
    assert bool(ovf) and int(tot) == n
    assert np.array_equal(np.asarray(oa), a[: 2 * CHUNK])


def test_compact_exact_capacity_and_empty_stream():
    # exactly `capacity` flagged: no overflow; an empty stream: total 0
    flags = np.zeros(100, bool)
    flags[::4] = True
    (o,), _, tot, ovf = compact(jnp.asarray(flags),
                                (jnp.arange(100, dtype=jnp.int32),), 25)
    assert int(tot) == 25 and not bool(ovf)
    assert np.array_equal(np.asarray(o), np.arange(0, 100, 4))
    (), pos, tot, ovf = compact(jnp.zeros((0,), bool), (), 8)
    assert int(tot) == 0 and not bool(ovf) and not np.asarray(pos).any()


@pytest.mark.gpu
def test_compact_on_gpu_matches_numpy():
    """GPU lane: the compaction compiled for the card at a count-phase
    size (8 Mi elements, ~30% flagged)."""
    rng = np.random.default_rng(21)
    n = 1 << 23
    flags = rng.random(n) < 0.3
    a = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    cap = 1 << 22
    (oa,), pos, tot, ovf = compact(jnp.asarray(flags), (jnp.asarray(a),), cap)
    idx = np.flatnonzero(flags)
    assert int(tot) == idx.size and not bool(ovf)
    assert np.array_equal(np.asarray(pos)[: idx.size], idx)
    assert np.array_equal(np.asarray(oa)[: idx.size], a[idx])
