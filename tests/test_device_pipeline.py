"""Device pipeline (graph build + simplify + emission) vs golden oracle —
exact contig parity (SURVEY.md §4 tiers 3-4)."""

import numpy as np
import pytest

from genome_tpu.assemble import assemble_device
from genome_tpu.golden import assemble_golden
from genome_tpu.golden.assembler import Graph as GoldenGraph
from genome_tpu.golden.assembler import count_canonical_kmers
from genome_tpu.io import random_genome, simulate_reads
from genome_tpu.kernels import u64
from genome_tpu.params import AssemblyParams

from tests.test_golden import CASES, _case


def test_build_graph_matches_golden():
    import jax.numpy as jnp
    from genome_tpu.graph.build import build_graph_device

    k = 15
    reads = simulate_reads(random_genome(800, seed=21), read_len=80,
                           coverage=10, error_rate=0.01, seed=22)
    kmers, counts = count_canonical_kmers(reads, k, 2)
    gg = GoldenGraph(kmers, counts, k)

    cap = kmers.size + 5  # deliberately non-pow2 with slack
    th = np.zeros(cap, np.uint32)
    tl = np.zeros(cap, np.uint32)
    th[: kmers.size], tl[: kmers.size] = u64.from_u64_np(kmers)
    succ, okv_hi, okv_lo = build_graph_device(
        jnp.asarray(th), jnp.asarray(tl), jnp.int32(kmers.size), k)
    succ = np.asarray(succ)
    # valid rows match golden succ exactly
    assert (succ[: 2 * kmers.size] == gg.succ).all()
    # slack rows are all -1
    assert (succ[2 * kmers.size :] == -1).all()
    # oriented kmer values match
    got = u64.to_u64_np(np.asarray(okv_hi)[: 2 * kmers.size],
                        np.asarray(okv_lo)[: 2 * kmers.size])
    assert (got == gg.okv).all()


@pytest.mark.parametrize("case", CASES, ids=[f"case{c[0]}" for c in CASES])
def test_device_assembly_matches_golden(case):
    _, reads, params = _case(*case)
    assert assemble_device(reads, params) == assemble_golden(reads, params)


def test_device_perfect_circular():
    n, k = 1200, 21
    g = random_genome(n, seed=7)
    reads = simulate_reads(g, read_len=100, coverage=30, error_rate=0.0,
                           circular=True, seed=8)
    params = AssemblyParams(k=k, min_coverage=1)
    got = assemble_device(reads, params)
    assert got == assemble_golden(reads, params)
    assert len(got) == 1 and len(got[0]) == n + k - 1


def test_device_empty():
    params = AssemblyParams(k=11)
    assert assemble_device([], params) == []
    assert assemble_device(["ACGT"], params) == []


def test_device_capacity_overflow_retry():
    _, reads, params = _case(0, 300, 50, 10, 0.00, False, 11, 1)
    small = assemble_device(reads, params, capacity=16)  # forces retries
    assert small == assemble_golden(reads, params)


def test_join_build_matches_bsearch_build():
    import jax.numpy as jnp
    from genome_tpu.graph.build import (build_graph_bsearch, build_graph_join,
                                        build_graph_kjoin)

    for k, seed in [(15, 41), (16, 44), (17, 45), (21, 42), (31, 43)]:
        reads = simulate_reads(random_genome(700, seed=seed), read_len=80,
                               coverage=8, error_rate=0.02, seed=seed + 1)
        kmers, counts = count_canonical_kmers(reads, k, 2)
        cap = kmers.size + 7
        th = np.zeros(cap, np.uint32)
        tl = np.zeros(cap, np.uint32)
        th[: kmers.size], tl[: kmers.size] = u64.from_u64_np(kmers)
        args = (jnp.asarray(th), jnp.asarray(tl), jnp.int32(kmers.size), k)
        sb, bh, bl = build_graph_bsearch(*args)
        for fn in (build_graph_join, build_graph_kjoin):
            sj, jh, jl = fn(*args)
            assert (np.asarray(sj) == np.asarray(sb)).all(), fn.__name__
            assert (np.asarray(jh) == np.asarray(bh)).all(), fn.__name__
            assert (np.asarray(jl) == np.asarray(bl)).all(), fn.__name__


def test_device_repeat_genome_matches_golden():
    """Realistic-repeat workload parity: a genome
    with planted near-identical long repeats (collapsed chains + hard
    bubbles at k=21) assembles identically on device and golden."""
    from genome_tpu.io.simulate import plant_repeats

    g = plant_repeats(random_genome(30_000, seed=31),
                      families=((900, 3), (300, 4)), divergence=0.004,
                      seed=32)
    reads = simulate_reads(g, read_len=100, coverage=25, error_rate=0.002,
                           seed=33)
    params = AssemblyParams(k=21, min_coverage=2)
    got = assemble_device(reads, params)
    want = assemble_golden(reads, params)
    assert got == want
    # the repeat structure must actually fragment assembly: strictly more
    # contigs than the same genome without repeats
    reads0 = simulate_reads(random_genome(30_000, seed=31), read_len=100,
                            coverage=25, error_rate=0.002, seed=33)
    base = assemble_golden(reads0, params)
    assert len(want) > len(base)


def test_plant_repeats_deterministic_and_scoped():
    from genome_tpu.io.simulate import plant_repeats_codes

    g = np.random.default_rng(0).integers(0, 4, 10_000).astype(np.uint8)
    a = plant_repeats_codes(g, families=((500, 2),), seed=5)
    b = plant_repeats_codes(g, families=((500, 2),), seed=5)
    assert (a == b).all()
    assert a.shape == g.shape and a.dtype == g.dtype
    assert (a != g).sum() > 0  # something was planted
    assert (g == np.random.default_rng(0).integers(0, 4, 10_000)).all()


def test_device_diploid_het_bubbles_match_golden():
    """Diploid workload: true 50/50 het-SNP bubbles (coverage-tied, so
    popping exercises the VALUE tie-break pins, SEMANTICS §5) assemble
    identically on device and golden."""
    from genome_tpu.io.simulate import simulate_reads_diploid

    g = random_genome(20_000, seed=51)
    reads = simulate_reads_diploid(g, het_rate=0.002, read_len=100,
                                   coverage=30, error_rate=0.001, seed=52)
    params = AssemblyParams(k=21, min_coverage=2)
    got = assemble_device(reads, params)
    want = assemble_golden(reads, params)
    assert got == want
    assert len(got) >= 1


def test_parity_seed_sweep():
    """Shape-stable content fuzz: 6 random (genome, error) draws at one
    compiled shape, device == golden on every one. Rare-semantics bugs
    (tie-breaks, RC pins, boundary windows) show up as content-dependent
    divergence long before they show up in hand-picked fixtures."""
    from genome_tpu.assemble.pipeline import assemble_device
    from genome_tpu.golden import assemble_golden
    from genome_tpu.io import random_genome, simulate_reads
    from genome_tpu.params import AssemblyParams

    params = AssemblyParams(k=15, min_coverage=2)
    for seed in (101, 202, 303, 404, 505, 606):
        err = (seed % 3) * 0.008  # 0 / 0.8% / 1.6%
        reads = simulate_reads(random_genome(1800, seed=seed),
                               read_len=80, coverage=18,
                               error_rate=err, seed=seed + 7)
        assert assemble_device(reads, params) == \
            assemble_golden(reads, params), (seed, err)


@pytest.mark.gpu
@pytest.mark.parametrize("counter", ["sort", "bucket", "hashtable"])
def test_pipeline_on_gpu_matches_golden(counter):
    """GPU lane: run_pipeline compiled for the card, with each counting
    engine, equals the golden oracle."""
    from genome_tpu.assemble.pipeline import run_pipeline
    reads = simulate_reads(random_genome(3000, seed=61), read_len=100,
                           coverage=20, error_rate=0.005, seed=62)
    params = AssemblyParams(k=21, min_coverage=2)
    got = run_pipeline(reads, params, counter=counter)["contigs"]
    assert got == assemble_golden(reads, params)
