"""T3: sharded contig emission (SURVEY.md §3.4 final merge step).

Round-2 merged contigs by allgathering the full per-node chain state to
every process's host RAM — O(global graph) per process. Here emission
stays sharded end-to-end:

- every shard turns its selected (primary-orientation) nodes into
  (head, dist, base) records and routes them by hash(head, dist // B) —
  BLOCKS of B consecutive chain positions, so a single giant chain
  spreads over all shards instead of landing whole on its head's owner
  (the skew that breaks naive route-to-head emission);
- each owner sorts its received records (one small 2-key sort), packs
  each block's bases 16-per-u32 at in-block offsets, and emits fixed
  metadata per block (head, block index, fill count);
- chain-head k-mers (one per contig) ride a separate tiny routing;
- the host concatenates blocks ordered by (head, block) — total traffic
  is 2 bits per base plus O(#blocks + #contigs) records, and no device
  or host buffer ever exceeds O(global / S) + capacity slack.

Output is bit-identical to graph.contigs.emit_contigs (CI-enforced for
P in {2,4,8} against the single-device pipeline).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from genome_tpu.dist.count import route_buckets
from genome_tpu.dist.ledger import LEDGER
from genome_tpu.dist.partition import _fmix32_jnp
from genome_tpu.kernels.compact import compact
from genome_tpu.kernels.extract import SENTINEL
from genome_tpu.utils import dna

I32 = jnp.int32
U32 = jnp.uint32

BLOCK = 1024           # chain positions per emission block (% 16 == 0)
_LOG_B = BLOCK.bit_length() - 1


def make_sharded_emit(mesh: Mesh, axis: str, local_capacity: int,
                      ecap: int, block_cap: int, head_cap: int):
    """Jitted sharded emission program.

    In (global, sharded over `axis`): head/dist [S*cl2] i32,
    primary_node/alive_o [S*cl2] bool, okv_hi/lo [S*cl2] u32.
    Out (per shard, concatenated over the mesh):
      words   [S, block_cap * BLOCK/16] u32 packed bases
      bhead   [S, block_cap] u32 chain head id per block
      bblk    [S, block_cap] u32 block index within chain
      bcnt    [S, block_cap] i32 filled positions in block
      n_blocks[S], hh/hl/hid [S, head_cap] head k-mer records, n_heads[S],
      ovf[S].
    """
    S = mesh.shape[axis]
    cl2 = 2 * local_capacity

    def emit_fn(head, dist, primary, alive_o, okv_hi, okv_lo):
        LEDGER.program("dist_emit")
        head = head.reshape(-1)
        dist = dist.reshape(-1)
        primary = primary.reshape(-1)
        alive_o = alive_o.reshape(-1)
        okv_hi, okv_lo = okv_hi.reshape(-1), okv_lo.reshape(-1)

        sel = alive_o & (head >= 0) & primary
        blk = (dist >> _LOG_B).astype(U32)
        mix = _fmix32_jnp(head.astype(U32) * U32(0x9E3779B9) ^ blk)
        owner = jnp.where(sel, (mix % U32(S)).astype(I32), S)
        rec1 = head.astype(U32)
        rec2 = (dist.astype(U32) << U32(2)) | (okv_lo & U32(3))
        (r1, r2), _, ovf = route_buckets((rec1, rec2), owner, S, ecap, axis)

        # owner side: order received records by (head, dist)
        s1, s2 = jax.lax.sort((r1, r2), num_keys=2)
        m = s1.shape[0]
        valid = s1 != SENTINEL
        sdist = (s2 >> U32(2)).astype(I32)
        sblk = (sdist >> _LOG_B).astype(U32)
        first = valid & jnp.concatenate([
            jnp.ones((1,), jnp.bool_),
            (s1[1:] != s1[:-1]) | (sblk[1:] != sblk[:-1])])
        brank = jnp.cumsum(first.astype(I32)) - 1
        n_blocks = jnp.where(valid, brank + 1, 0).max(initial=0)
        ovf = ovf | (n_blocks > block_cap)

        # per-block metadata (compacted to block_cap slots)
        (bhead, bblk), _, _, _ = compact(first, (s1, sblk), block_cap)
        bcnt = jax.ops.segment_sum(
            valid.astype(I32), jnp.where(valid, brank, block_cap),
            num_segments=block_cap + 1)[:block_cap]

        # dense per-block base layout: block_rank * BLOCK + dist % BLOCK
        didx = jnp.where(valid & (brank < block_cap),
                         brank * BLOCK + (sdist & (BLOCK - 1)),
                         block_cap * BLOCK)
        codes = jnp.zeros((block_cap * BLOCK,), U32).at[didx].set(
            s2 & U32(3), mode="drop")
        shifts = U32(2) * jnp.arange(16, dtype=U32)
        words = (codes.reshape(-1, 16) << shifts[None, :]).sum(
            axis=1, dtype=U32)

        # chain-head k-mer records (dist == 0 -> block 0 owner by hash)
        is_h = sel & (dist == 0)
        mix0 = _fmix32_jnp(head.astype(U32) * U32(0x9E3779B9))
        owner0 = jnp.where(is_h, (mix0 % U32(S)).astype(I32), S)
        hcap_send = max(64, ecap // 4)
        (ghid, ghh, ghl), _, o2 = route_buckets(
            (head.astype(U32), okv_hi, okv_lo), owner0, S, hcap_send, axis)
        hvalid = ghid != SENTINEL
        (hid, hh, hl), _, n_heads, o3 = compact(
            hvalid, (ghid, ghh, ghl), head_cap)
        ovf = ovf | o2 | o3

        return (words, bhead, bblk, bcnt, n_blocks[None],
                hid, hh, hl, n_heads[None], ovf[None])

    fn = jax.shard_map(emit_fn, mesh=mesh, check_vma=False,
                       in_specs=(P(axis),) * 6,
                       out_specs=(P(axis),) * 10)
    return jax.jit(fn)


def _fetch(x):
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return multihost_utils.process_allgather(x, tiled=True)


def emit_contigs_sharded(mesh: Mesh, axis: str, local_capacity: int,
                         head, dist, primary, alive_o, okv_hi, okv_lo,
                         k: int, min_contig_len: int = 0,
                         max_retries: int = 3,
                         local_slice: tuple[int, int] | None = None):
    """Sharded emission driver with capacity-retry ladder.

    Returns (contigs, ok). ok=False after all retries overflowed — the
    caller falls back to the replicated emission path.

    local_slice=(pid, P): build only the pid-th of P contiguous slices
    of the head-grouped contig set (block decode AND string assembly run
    at 1/P cost) — the multi-host parallel-write path (SURVEY §3.4;
    write_fasta_parallel merges the per-process sorted slices). Every
    process still takes identical retry/fallback decisions.
    """
    S = mesh.shape[axis]
    cl2 = 2 * local_capacity
    if S * cl2 >= (1 << 29):  # dist << 2 must fit u32
        return [], False
    # per (sender, owner) routing bucket: each sender holds <= cl2/2
    # selected records spread over S owners; received per owner is then
    # S * ecap ~ 1.35 * global_sel / S — the O(global/S) guarantee
    ecap = max(64, int(1.35 * (cl2 // 2) / S) + 64)
    block_cap = max(64, S * ecap // BLOCK + 4096)
    head_cap = max(64, block_cap)
    for _ in range(max_retries):
        emit = make_sharded_emit(mesh, axis, local_capacity, ecap,
                                 block_cap, head_cap)
        (words, bhead, bblk, bcnt, n_blocks, hid, hh, hl, n_heads,
         ovf) = emit(head, dist, primary, alive_o, okv_hi, okv_lo)
        LEDGER.invoke("dist_emit")
        if not bool(_fetch(ovf).any()):
            break
        ecap *= 2
        block_cap *= 2
        head_cap *= 2
    else:
        return [], False

    # host: per-shard arrays (each O(global/S) + slack)
    words = _fetch(words).reshape(S, -1)
    bhead = _fetch(bhead).reshape(S, -1)
    bblk = _fetch(bblk).reshape(S, -1)
    bcnt = _fetch(bcnt).reshape(S, -1)
    n_blocks = _fetch(n_blocks).reshape(-1)
    hid = _fetch(hid).reshape(S, -1)
    hh = _fetch(hh).reshape(S, -1)
    hl = _fetch(hl).reshape(S, -1)
    n_heads = _fetch(n_heads).reshape(-1)

    heads_all, blks_all, cnts_all, codes_all = [], [], [], []
    for s in range(S):
        nb = int(n_blocks[s])
        if nb == 0:
            continue
        heads_all.append(bhead[s, :nb])
        blks_all.append(bblk[s, :nb])
        cnts_all.append(bcnt[s, :nb])
        w = words[s, : nb * (BLOCK // 16)]
        c = ((w[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3)
        codes_all.append(c.astype(np.uint8).reshape(nb, BLOCK))
    if not heads_all:
        return [], True
    bh = np.concatenate(heads_all)
    bb = np.concatenate(blks_all)
    bc = np.concatenate(cnts_all)
    bcodes = np.concatenate(codes_all, axis=0)
    order = np.lexsort((bb, bh))
    bh, bb, bc, bcodes = bh[order], bb[order], bc[order], bcodes[order]

    # head k-mer join table, vectorized (sorted ids + searchsorted — the
    # int-by-int dict build crawled on repeat-heavy/fragmented genomes)
    pid, pkm = [], []
    for s in range(S):
        nh = int(n_heads[s])
        if nh:
            pid.append(hid[s, :nh])
            pkm.append((hh[s, :nh].astype(np.uint64) << np.uint64(32))
                       | hl[s, :nh].astype(np.uint64))
    kid = np.concatenate(pid)
    kkm = np.concatenate(pkm)
    korder = np.argsort(kid, kind="stable")
    kid, kkm = kid[korder], kkm[korder]

    starts = np.flatnonzero(np.concatenate([[True], bh[1:] != bh[:-1]]))
    ends = np.concatenate([starts[1:], [bh.size]])
    # every block-chain head MUST have a head record; a miss here means a
    # broken invariant upstream — fail loudly instead of silently building
    # the contig from a neighboring head k-mer (searchsorted returns an
    # insertion point, not a membership test). The check runs on the
    # GLOBAL head set, BEFORE any local_slice restriction: all processes
    # hold identical (kid, bh) and must take the same raise/continue
    # decision, or the one process whose slice holds the bad head dies
    # while the rest hang in write_fasta_parallel's allgather.
    pos_all = np.searchsorted(kid, bh[starts])
    if pos_all.size and (int(pos_all.max()) >= kid.size
                         or not (kid[pos_all] == bh[starts]).all()):
        raise AssertionError(
            "dist emit: contig head id missing from head-kmer join table "
            "(invariant violation — head/block exchange out of sync)")
    if local_slice is not None:
        # restrict to this process's contiguous contig range; blocks of a
        # contig are contiguous after the (bh, bb) lexsort, so the block
        # arrays slice cleanly and the decode below runs at 1/P cost
        pid, nproc = local_slice
        n_c = starts.size
        per = -(-n_c // nproc)
        ci0, ci1 = min(pid * per, n_c), min((pid + 1) * per, n_c)
        if ci0 >= ci1:
            return [], True
        blk0 = int(starts[ci0])
        blk1 = int(starts[ci1]) if ci1 < n_c else bh.size
        starts = starts[ci0:ci1] - blk0
        ends = ends[ci0:ci1] - blk0
        bh = bh[blk0:blk1]
        bc = bc[blk0:blk1]
        bcodes = bcodes[blk0:blk1]
        pos_all = pos_all[ci0:ci1]
    # one flat base stream in (head, block) order: per-block valid
    # prefixes masked out in a single pass, decoded to text once; each
    # contig is then a pure string slice (no per-contig concatenate)
    valid = np.arange(BLOCK, dtype=np.int32)[None, :] < bc[:, None]
    flat = bcodes[valid]
    cum = np.concatenate([[0], np.cumsum(bc)])
    text = np.frombuffer(b"ACGT", dtype=np.uint8)[flat].tobytes().decode(
        "ascii")
    head_km = kkm[pos_all]
    out: list[str] = []
    for i in range(starts.size):
        a, b = starts[i], ends[i]
        seq = dna.kmer_to_str(int(head_km[i]), k) + text[cum[a] + 1 : cum[b]]
        c = min(seq, dna.revcomp_str(seq))
        if len(c) >= min_contig_len:
            out.append(c)
    return sorted(out), True


def write_fasta_parallel(path: str, local_contigs: list[str],
                         width: int = 80) -> int:
    """Multi-process FASTA writer (SURVEY §3.4 'host 0 writes output',
    parallelized): each process writes its SORTED contig slice to
    `path.shard<pid>`, then process 0 streams a k-way merge of the
    sorted shards into `path` — byte-identical to
    write_fasta(path, sorted(all contigs)) — and removes the shards.
    The expensive work (string building in emit_contigs_sharded's
    local_slice mode, formatting, disk IO) runs on every process; the
    merge is a sequential string-compare copy. Assumes the processes
    share a filesystem (localhost fake cluster / NFS pod); returns the
    total contig count on every process. Allgather barriers bracket the
    merge so no process returns before `path` exists.
    """
    import heapq
    import os

    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from genome_tpu.io import write_fasta

    pid, P = jax.process_index(), jax.process_count()
    shard = f"{path}.shard{pid}"
    with open(shard, "w") as f:
        for c in local_contigs:
            f.write(c + "\n")
    counts = multihost_utils.process_allgather(
        jnp.asarray([len(local_contigs)]))  # doubles as a write barrier
    total = int(np.asarray(counts).sum())
    if pid == 0:
        files = [open(f"{path}.shard{p}") for p in range(P)]
        try:
            its = [(ln.rstrip("\n") for ln in fh) for fh in files]
            # write_fasta only iterates its sequence argument, so the
            # lazy k-way merge streams straight through it — one format
            # implementation (headers, wrapping, gzip on .gz paths)
            write_fasta(path, heapq.merge(*its), width=width)
        finally:
            for p, fh in enumerate(files):
                fh.close()
                os.remove(f"{path}.shard{p}")
    multihost_utils.process_allgather(jnp.asarray([0]))  # merge barrier
    return total
