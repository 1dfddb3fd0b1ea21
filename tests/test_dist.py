"""Distributed (shard_map) tier tests on the virtual 8-device CPU mesh
(SURVEY.md §4.5; partitioned-assembly analog)."""

import numpy as np
import pytest

from genome_tpu.dist import assemble_sharded, owner_of_np
from genome_tpu.golden import assemble_golden
from genome_tpu.golden.assembler import count_canonical_kmers
from genome_tpu.io import random_genome, simulate_reads
from genome_tpu.kernels import u64
from genome_tpu.params import AssemblyParams

from tests.test_golden import _case


def test_owner_hash_jnp_matches_np():
    import jax.numpy as jnp
    from genome_tpu.dist.partition import owner_of
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1 << 42, size=1000, dtype=np.uint64)
    hi, lo = u64.from_u64_np(v)
    got = np.asarray(owner_of(jnp.asarray(hi), jnp.asarray(lo), 8))
    assert (got == owner_of_np(v, 8)).all()
    # rough balance check
    counts = np.bincount(got, minlength=8)
    assert counts.min() > 50


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_sharded_count_matches_golden(num_shards):
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from genome_tpu.dist.count import make_sharded_count
    from genome_tpu.assemble.pipeline import extract_stream
    from genome_tpu.dist.assemble import shard_reads
    from genome_tpu.kernels.extract import SENTINEL

    k, mincov = 21, 2
    reads = simulate_reads(random_genome(1500, seed=31), read_len=80,
                           coverage=10, error_rate=0.01, seed=32)
    mesh = Mesh(np.array(jax.devices()[:num_shards]), ("shard",))
    parts = []
    for chunk in shard_reads(reads, num_shards):
        hi, lo = extract_stream(chunk, k)
        parts.append((np.asarray(hi), np.asarray(lo)))
    m = max(p[0].size for p in parts)
    ghi = np.full((num_shards, m), SENTINEL, dtype=np.uint32)
    glo = np.full((num_shards, m), SENTINEL, dtype=np.uint32)
    for r, (h, l) in enumerate(parts):
        ghi[r, : h.size] = h
        glo[r, : l.size] = l
    counter = make_sharded_count(mesh, "shard", bucket_cap=m + 64,
                                 local_capacity=8192)
    th, tl, cnts, n_uni, ovf = counter(
        ghi.reshape(-1), glo.reshape(-1), jnp.asarray([mincov], jnp.uint32))
    assert not bool(np.asarray(ovf).any())
    # merge shard tables -> multiset equality with golden counting
    th, tl, cnts = np.asarray(th), np.asarray(tl), np.asarray(cnts)
    n_uni = np.asarray(n_uni)
    got = []
    for r in range(num_shards):
        a, b = r * 8192, r * 8192 + n_uni[r]
        km = u64.to_u64_np(th[a:b], tl[a:b])
        assert (np.diff(km.astype(np.uint64)) > 0).all()  # sorted per shard
        assert (owner_of_np(km, num_shards) == r).all()   # correctly owned
        got.append(np.stack([km, cnts[a:b].astype(np.uint64)], 1))
    got = np.concatenate(got)
    got = got[np.argsort(got[:, 0])]
    exp_k, exp_c = count_canonical_kmers(reads, k, mincov)
    assert got.shape[0] == exp_k.size
    assert (got[:, 0] == exp_k).all()
    assert (got[:, 1] == exp_c.astype(np.uint64)).all()


@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_sharded_assembly_matches_golden(num_shards):
    _, reads, params = _case(4, 800, 70, 18, 0.015, True, 15, 2)
    got = assemble_sharded(reads, params, num_shards=num_shards)
    assert got == assemble_golden(reads, params)


def test_sharded_assembly_read_order_invariance():
    _, reads, params = _case(1, 500, 60, 15, 0.01, False, 11, 2)
    rng = np.random.default_rng(5)
    shuffled = list(reads)
    rng.shuffle(shuffled)
    a = assemble_sharded(reads, params, num_shards=4)
    b = assemble_sharded(shuffled, params, num_shards=4)
    assert a == b == assemble_golden(reads, params)


def test_sharded_capacity_retry():
    _, reads, params = _case(0, 300, 50, 10, 0.00, False, 11, 1)
    got = assemble_sharded(reads, params, num_shards=2, local_capacity=64)
    assert got == assemble_golden(reads, params)

def test_sharded_simplify_matches_replicated():
    """The distributed pointer-doubling passes (dist/simplify.py) must
    produce the same alive set as the replicated passes — run both
    explicitly (no silent overflow fallback) on a case with tips+bubbles."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from genome_tpu.assemble.pipeline import extract_stream
    from genome_tpu.dist.build import make_sharded_build
    from genome_tpu.dist.count import make_sharded_count
    from genome_tpu.dist.simplify import simplify_sharded
    from genome_tpu.graph.simplify import simplify_device
    from genome_tpu.kernels.extract import SENTINEL

    S = 4
    _, reads, params = _case(7, 900, 70, 20, 0.02, False, 15, 2)
    mesh = Mesh(np.array(jax.devices()[:S]), ("shard",))
    from genome_tpu.dist.assemble import shard_reads
    parts = []
    for chunk in shard_reads(reads, S):
        hi, lo = extract_stream(chunk, params.k)
        parts.append((np.asarray(hi), np.asarray(lo)))
    m_local = max(max(p[0].size for p in parts), 8)
    ghi = np.full((S, m_local), SENTINEL, dtype=np.uint32)
    glo = np.full((S, m_local), SENTINEL, dtype=np.uint32)
    for r, (h, l) in enumerate(parts):
        ghi[r, : h.size] = h
        glo[r, : l.size] = l
    local_cap = 4096
    counter = make_sharded_count(mesh, "shard", m_local, local_cap)
    th, tl, cnts, n_uni, ovf = counter(
        ghi.reshape(-1), glo.reshape(-1),
        jnp.asarray([params.min_coverage], jnp.uint32))
    assert not bool(np.asarray(ovf).any())
    builder = make_sharded_build(mesh, "shard", params.k, local_cap,
                                 8 * local_cap)
    succ, okv_hi, okv_lo, bovf = builder(th, tl, n_uni)
    assert not bool(np.asarray(bovf).any())

    alive0 = jnp.ones((S * local_cap,), dtype=jnp.bool_)
    alive_sh, ovf_s = simplify_sharded(mesh, "shard", local_cap, succ,
                                       okv_hi, okv_lo, cnts, alive0,
                                       n_uni, params)
    assert not ovf_s, "sharded simplify overflowed at test scale"

    n_loc = np.asarray(n_uni)
    valid = (np.arange(S * local_cap).reshape(S, local_cap)
             % local_cap < n_loc[:, None]).reshape(-1)
    alive_rep = simplify_device(
        jnp.asarray(np.asarray(succ)), jnp.asarray(np.asarray(okv_hi)),
        jnp.asarray(np.asarray(okv_lo)), jnp.asarray(np.asarray(cnts)),
        jnp.ones((S * local_cap,), jnp.bool_), jnp.asarray(valid), params)
    got = np.asarray(alive_sh) & valid
    want = np.asarray(alive_rep) & valid
    assert (got == want).all()


def test_sharded_incremental_update_overflow_fallback(monkeypatch):
    """Force the carried-degree incremental update's kill buffer to
    overflow every pass (kovf) — the host loop must recompute degrees
    from scratch each round and still produce exact contigs."""
    import genome_tpu.dist.simplify as DS
    monkeypatch.setattr(DS, "_KILL_MD", 2)
    _, reads, params = _case(4, 800, 70, 18, 0.015, True, 15, 2)
    got = assemble_sharded(reads, params, num_shards=4)
    assert got == assemble_golden(reads, params)


def test_sharded_bubble_compaction_overflow_retry(monkeypatch):
    """Force the bubble-candidate compaction buffer to overflow on the
    first slack rung — the retry ladder must grow it and converge to
    exact contigs."""
    import genome_tpu.dist.simplify as DS
    orig = DS._bub_mc

    def tiny(cl2, slack):
        return 2 if slack < 1.4 else orig(cl2, slack)

    monkeypatch.setattr(DS, "_bub_mc", tiny)
    _, reads, params = _case(4, 800, 70, 18, 0.015, True, 15, 2)
    got = assemble_sharded(reads, params, num_shards=4)
    assert got == assemble_golden(reads, params)


def test_sharded_fast_final_cycle_fallback():
    """A perfect circular genome leaves a cycle at emission: the
    ruler-ranking fast final must flag ok=False and the ladder must
    produce exact contigs through the exact final."""
    from genome_tpu.io import random_genome, simulate_reads
    g = random_genome(1500, seed=77)
    reads = simulate_reads(g, read_len=100, coverage=30, error_rate=0.0,
                           circular=True, seed=78)
    params = AssemblyParams(k=21, min_coverage=1)
    got = assemble_sharded(reads, params, num_shards=4)
    assert got == assemble_golden(reads, params)
    assert len(got) == 1


@pytest.mark.slow
def test_sharded_repeat_genome_matches_golden():
    """Planted near-identical repeats through the SHARDED path (the
    workload class): exact parity."""
    from genome_tpu.io.simulate import plant_repeats

    g = plant_repeats(random_genome(15_000, seed=21),
                      families=((700, 3),), divergence=0.004, seed=22)
    reads = simulate_reads(g, read_len=100, coverage=25,
                           error_rate=0.002, seed=23)
    params = AssemblyParams(k=21, min_coverage=2)
    got = assemble_sharded(reads, params, num_shards=4)
    assert got == assemble_golden(reads, params)


def test_sharded_degenerate_inputs():
    """Empty input, reads shorter than k, and N-saturated reads must
    flow through the full sharded pipeline without overflow tricks or
    crashes, matching golden (SURVEY §4.6 fault/overflow tier)."""
    params = AssemblyParams(k=15, min_coverage=1)
    assert assemble_sharded([], params, num_shards=2) == []
    short = ["ACGTACGT", "TTTT"]  # all < k
    assert assemble_sharded(short, params, num_shards=2) == \
        assemble_golden(short, params)
    nheavy = ["N" * 60, "ACGTN" * 12, "N" * 30 + "A" * 30]
    assert assemble_sharded(nheavy, params, num_shards=2) == \
        assemble_golden(nheavy, params)


def test_sharded_self_loop_cycle_parity():
    """Homopolymer runs >= k+1 create SELF-LOOP nodes (succ[v] = v);
    the distributed cycle detector must catch 1-cycles (regression:
    the prev_p gather used to skip self-pointers on the assumption
    p == self => prev < 0, and emission diverged from golden)."""
    params = AssemblyParams(k=15, min_coverage=1)
    poly = ["N" * 30 + "A" * 30]
    assert assemble_sharded(poly, params, num_shards=2) == \
        assemble_golden(poly, params) == ["A" * 15]
    # embedded island: self-loop coexisting with real chains
    g = random_genome(3000, seed=13) + "A" * 40 + random_genome(3000,
                                                                seed=14)
    reads = simulate_reads(g, read_len=100, coverage=25, error_rate=0.0,
                           seed=15)
    p2 = AssemblyParams(k=21, min_coverage=2)
    want = assemble_golden(reads, p2)
    assert assemble_sharded(reads, p2, num_shards=2) == want
    from genome_tpu.assemble import assemble_device
    assert assemble_device(reads, p2) == want


@pytest.mark.slow
def test_adversarial_structures_parity():
    """Inverted repeats (self-RC chain structure), a perfect hairpin
    (x + revcomp(x)), and 70k-deep coverage (16-bit count limb stress)
    through device AND sharded paths — exact golden parity."""
    from genome_tpu.assemble import assemble_device
    from genome_tpu.utils.dna import revcomp_str

    p = AssemblyParams(k=21, min_coverage=2)
    x = random_genome(400, seed=31)
    g = (random_genome(1500, seed=32) + x + random_genome(800, seed=33)
         + revcomp_str(x) + random_genome(1500, seed=34))
    reads = simulate_reads(g, read_len=100, coverage=28, error_rate=0.0,
                           seed=35)
    want = assemble_golden(reads, p)
    assert assemble_device(reads, p) == want
    assert assemble_sharded(reads, p, num_shards=4) == want

    g2 = random_genome(1200, seed=36)
    g2 = g2 + revcomp_str(g2)
    reads2 = simulate_reads(g2, read_len=100, coverage=30,
                            error_rate=0.0, seed=37)
    want2 = assemble_golden(reads2, p)
    assert assemble_device(reads2, p) == want2
    assert assemble_sharded(reads2, p, num_shards=4) == want2

    reads3 = (["ACGTTGCAGGTCAATCGCATGGTACGATCAGT"] * 70000
              + simulate_reads(random_genome(2000, seed=38),
                               read_len=100, coverage=20,
                               error_rate=0.0, seed=39))
    want3 = assemble_golden(reads3, p)
    assert assemble_device(reads3, p) == want3
    assert assemble_sharded(reads3, p, num_shards=4) == want3


@pytest.mark.gpu
def test_sharded_assembly_on_gpu():
    """GPU-lane sharded smoke: assemble_sharded on a 1-card mesh, so the
    shard_map programs (route_buckets all_to_alls, sharded simplify and
    emission) go through XLA:GPU codegen; contigs must equal golden."""
    _, reads, params = _case(4, 800, 70, 18, 0.015, True, 15, 2)
    got = assemble_sharded(reads, params, num_shards=1)
    assert got == assemble_golden(reads, params)


def test_sharded_parity_seed_sweep():
    """Shape-stable content fuzz on the SHARDED path: 3 random
    genome/error draws, sharded == golden on each (the distributed
    analog of test_parity_seed_sweep — content-dependent divergence in
    routing/exchange tie-breaks would show here)."""
    params = AssemblyParams(k=15, min_coverage=2)
    for seed in (711, 812, 913):
        err = (seed % 3) * 0.008
        reads = simulate_reads(random_genome(1800, seed=seed),
                               read_len=80, coverage=18,
                               error_rate=err, seed=seed + 9)
        assert assemble_sharded(reads, params, num_shards=4) == \
            assemble_golden(reads, params), (seed, err)
