"""Contig emission: device chain state -> canonical contig strings (host).

Device arrays (head/dist/primary per oriented node) come from
graph.simplify.final_chain_state; the string assembly itself is host-side
NumPy (output writing is host work anyway, SURVEY.md §3.1 writeContigs).
Semantics: SEMANTICS.md §6.

Two paths with identical output (CI-enforced):
- emit_contigs: pulls the full per-node chain state to the host and
  assembles there. Simple; but at E. coli scale that is ~170 MB of
  device->host traffic.
- emit_contigs_device: orders the selected nodes by (head, dist) ON
  DEVICE (one 2-key sort), packs the per-node last bases 16-per-u32,
  and transfers only the packed base stream (2 bits/node) plus one
  (start, head k-mer) record per contig — ~2 MB at the same scale.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from genome_tpu.kernels.compact import compact
from genome_tpu.utils import dna

I32 = jnp.int32
U32 = jnp.uint32
_SENT = np.uint32(0xFFFFFFFF)


def emit_contigs(final_state, okv_hi, okv_lo, k: int,
                 min_contig_len: int = 0, node_primary: bool = False) -> list[str]:
    """Assemble canonical contig strings from chain state.

    Args:
      final_state: dict with head/dist/primary/alive_o (device or numpy).
      okv_hi, okv_lo: oriented k-mer values per oriented node.
      node_primary: primary is a per-NODE flag (the head's primary already
        gathered to every chain member — the sharded final state's form,
        where indexing primary[head] would need a cross-shard gather)
        instead of a per-head flag indexed via head.
    Returns sorted canonical contig list.
    """
    head = np.asarray(final_state["head"])
    dist = np.asarray(final_state["dist"])
    primary = np.asarray(final_state["primary"])
    alive_o = np.asarray(final_state["alive_o"])
    okv = (np.asarray(okv_hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        okv_lo, dtype=np.uint64)

    if node_primary:
        sel = alive_o & (head >= 0) & primary
    else:
        sel = alive_o & (head >= 0) & primary[np.clip(head, 0, None)]
    if not sel.any():
        return []
    vh, vd, vv = head[sel], dist[sel], okv[sel]
    order = np.lexsort((vd, vh))
    vh, vd, vv = vh[order], vd[order], vv[order]
    starts = np.flatnonzero(np.concatenate([[True], vh[1:] != vh[:-1]]))
    ends = np.concatenate([starts[1:], [vh.size]])
    last = (vv & np.uint64(3)).astype(np.uint8)
    out: list[str] = []
    for a, b in zip(starts, ends):
        seq = dna.kmer_to_str(int(vv[a]), k) + dna.decode(last[a + 1 : b])
        c = min(seq, dna.revcomp_str(seq))
        if len(c) >= min_contig_len:
            out.append(c)
    return sorted(out)


@functools.partial(jax.jit, static_argnames=("contig_cap", "node_primary"))
def _chain_emit_device(head, dist, primary, alive_o, okv_hi, okv_lo,
                       contig_cap: int, node_primary: bool):
    """Device side of emit_contigs_device.

    Sorts the selected (primary-orientation) nodes by (head, dist) so each
    contig's bases are contiguous and in walk order, then packs the
    per-node last base (okv & 3) 16-per-u32. Only O(n/16) words and
    O(contigs) records ever cross to the host.

    Returns (words [n2/16] u32 packed bases of the sorted stream,
    starts [contig_cap] i32 contig start offsets, head_hi/head_lo
    [contig_cap] u32 first k-mer per contig, n_sel, n_contigs, overflow).
    """
    n2 = head.shape[0]
    if node_primary:
        sel = alive_o & (head >= 0) & primary
    else:
        sel = alive_o & (head >= 0) & primary[jnp.clip(head, 0, None)]
    key1 = jnp.where(sel, head.astype(U32), _SENT)
    # dist < 2^30 guaranteed by the wrapper's n2 < 2^30 gate
    key2 = jnp.where(sel, (dist.astype(U32) << U32(2)) | (okv_lo & U32(3)),
                     _SENT)
    k1s, k2s = jax.lax.sort((key1, key2), num_keys=2)
    n_sel = sel.sum(dtype=I32)
    idx = jnp.arange(n2, dtype=I32)
    first = (idx < n_sel) & jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), k1s[1:] != k1s[:-1]])
    _, starts, n_contigs, ovf = compact(first, (), contig_cap)
    starts_c = jnp.clip(starts, 0, n2 - 1)
    head_at = k1s[starts_c].astype(I32)
    head_c = jnp.clip(head_at, 0, n2 - 1)
    head_hi = okv_hi[head_c]
    head_lo = okv_lo[head_c]
    codes = k2s & U32(3)
    shifts = U32(2) * jnp.arange(16, dtype=U32)
    words = (codes.reshape(-1, 16) << shifts[None, :]).sum(
        axis=1, dtype=U32)
    return words, starts, head_hi, head_lo, n_sel, n_contigs, ovf


def emit_contigs_device(final_state, okv_hi, okv_lo, k: int,
                        min_contig_len: int = 0, node_primary: bool = False,
                        contig_cap: int | None = None) -> list[str]:
    """emit_contigs with the ordering/packing done on device.

    Bit-identical output to emit_contigs (CI-enforced); falls back to it
    when the contig-count buffer overflows or shapes don't divide.
    """
    head = final_state["head"]
    n2 = head.shape[0]
    if n2 == 0:
        return []
    if n2 % 16 or n2 >= (1 << 30):
        return emit_contigs(final_state, okv_hi, okv_lo, k,
                            min_contig_len, node_primary)
    cap = contig_cap or max(4096, n2 >> 6)
    while True:
        words, starts, hh, hl, n_sel, n_contigs, ovf = _chain_emit_device(
            jnp.asarray(final_state["head"]),
            jnp.asarray(final_state["dist"]),
            jnp.asarray(final_state["primary"]),
            jnp.asarray(final_state["alive_o"]),
            jnp.asarray(okv_hi), jnp.asarray(okv_lo),
            contig_cap=cap, node_primary=node_primary)
        # one device->host fetch for all three scalars
        sc = np.asarray(jnp.stack([ovf.astype(jnp.int32), n_sel, n_contigs]))
        if not int(sc[0]):
            break
        cap *= 2
        if cap > 2 * n2:
            return emit_contigs(final_state, okv_hi, okv_lo, k,
                                min_contig_len, node_primary)
    n_sel, n_contigs = int(sc[1]), int(sc[2])
    if n_contigs == 0:
        return []
    # slice on device before the transfer: only real data crosses the
    # link; the three per-contig metadata arrays ride one fetch
    nw = -(-n_sel // 16)
    words = np.asarray(words[:nw])
    meta = np.asarray(jnp.stack([starts[:n_contigs].astype(jnp.uint32),
                                 hh[:n_contigs], hl[:n_contigs]]))
    starts = meta[0].astype(np.int64)
    hh = meta[1].astype(np.uint64)
    hl = meta[2].astype(np.uint64)
    codes = ((words[:, None] >> (2 * np.arange(16, dtype=np.uint32)))
             & 3).astype(np.uint8).reshape(-1)
    ends = np.concatenate([starts[1:], [n_sel]])
    vals = (hh << np.uint64(32)) | hl
    out: list[str] = []
    for i in range(n_contigs):
        a, b = int(starts[i]), int(ends[i])
        seq = dna.kmer_to_str(int(vals[i]), k) + dna.decode(codes[a + 1 : b])
        c = min(seq, dna.revcomp_str(seq))
        if len(c) >= min_contig_len:
            out.append(c)
    return sorted(out)
