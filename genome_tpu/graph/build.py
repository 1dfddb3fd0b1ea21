"""T2: de Bruijn graph construction on device (SURVEY.md §2.4, §3.1).

Reference analog: for each surviving k-mer, probe which of the <=4
single-base extensions also survive (`DNAMap.contains`).
Here: vectorized binary search of all 8N extension queries (2
orientations x 4 bases) over the sorted canonical table — no hash probes,
pure batched gathers that XLA pipelines over device memory.

Output: succ[2N, 4] int32 oriented successor ids (-1 = absent), where
oriented id v = 2*i + s (SEMANTICS §3). Table slots beyond n_unique yield
rows of -1 and are never referenced by later passes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from genome_tpu.kernels import u64

I32 = jnp.int32
U32 = jnp.uint32


def searchsorted_pair(table_hi, table_lo, n_valid, qh, ql):
    """Vectorized lower-bound binary search on a (hi, lo) sorted table.

    table entries at index >= n_valid are treated as +inf. Returns int32
    insertion positions (0..n_valid).
    """
    capacity = table_hi.shape[0]
    steps = max(1, (capacity - 1).bit_length())
    # derive carries from the (possibly shard-varying) inputs so the fori
    # carry types match under shard_map's varying-manual-axes tracking
    lo_b = (qh & jnp.uint32(0)).astype(I32)
    hi_b = lo_b + jnp.asarray(n_valid, I32)

    def body(_, carry):
        lo_b, hi_b = carry
        mid = (lo_b + hi_b) >> 1
        mh = table_hi[mid]
        ml = table_lo[mid]
        less = u64.lt(mh, ml, qh, ql)  # table[mid] < query
        lo_b = jnp.where(less, mid + 1, lo_b)
        hi_b = jnp.where(less, hi_b, mid)
        return lo_b, hi_b

    lo_b, hi_b = jax.lax.fori_loop(0, steps + 1, body, (lo_b, hi_b))
    return lo_b


def _extension_queries(table_hi, table_lo, n_unique, k: int):
    """Shared prep: oriented values + canonicalized extension queries.

    Returns (okv_hi, okv_lo, valid_o, ch[4][2C], cl[4][2C], orient[4][2C]).
    """
    capacity = table_hi.shape[0]
    ids = jnp.arange(capacity, dtype=I32)
    valid_node = ids < n_unique

    # oriented k-mer values okv[2C]: even rows = table, odd rows = revcomp
    rh, rl = u64.revcomp(table_hi, table_lo, k)
    okv_hi = jnp.stack([table_hi, rh], axis=1).reshape(-1)
    okv_lo = jnp.stack([table_lo, rl], axis=1).reshape(-1)
    valid_o = jnp.repeat(valid_node, 2)

    # extension ext = (okv << 2 | b) masked to 2k bits
    sh, sl = u64.shl(okv_hi, okv_lo, 2)
    if k > 16:
        sh = sh & U32((1 << (2 * k - 32)) - 1)
    else:
        sh = jnp.zeros_like(sh)
        sl = sl & U32((1 << (2 * k)) - 1) if k < 16 else sl

    chs, cls, orients = [], [], []
    for b in range(4):
        eh, el = sh, sl | U32(b)
        ch, cl = u64.canonical(eh, el, k)
        chs.append(ch)
        cls.append(cl)
        orients.append((~u64.eq(eh, el, ch, cl)).astype(I32))
    return okv_hi, okv_lo, valid_o, chs, cls, orients


@functools.partial(jax.jit, static_argnames=("k",))
def build_graph_bsearch(table_hi, table_lo, n_unique, k: int):
    """Graph build by per-query binary search (8C x log C random gathers).

    Simple and the basis of the sharded boundary-probe path; for large
    single-device tables the join builds avoid its chains of dependent
    random gathers."""
    capacity = table_hi.shape[0]
    okv_hi, okv_lo, valid_o, chs, cls, orients = _extension_queries(
        table_hi, table_lo, n_unique, k)
    succ_cols = []
    for b in range(4):
        ch, cl, orient = chs[b], cls[b], orients[b]
        pos = searchsorted_pair(table_hi, table_lo, n_unique, ch, cl)
        pos_c = jnp.minimum(pos, capacity - 1)
        found = (pos < n_unique) & u64.eq(table_hi[pos_c], table_lo[pos_c], ch, cl)
        col = jnp.where(found & valid_o, 2 * pos_c + orient, -1)
        succ_cols.append(col)
    succ = jnp.stack(succ_cols, axis=1)
    return succ, okv_hi, okv_lo


@functools.partial(jax.jit, static_argnames=("k",))
def build_graph_join(table_hi, table_lo, n_unique, k: int):
    """Graph build as a sort-merge membership join.

    Instead of 8C independent binary searches (each a chain of random
    gathers), concatenate the table entries with
    all extension queries, sort once, and resolve each query against the
    table record at its equal-key run head: one sort in place of chains
    of dependent random gathers.
    """
    capacity = table_hi.shape[0]
    n2 = 2 * capacity
    okv_hi, okv_lo, valid_o, chs, cls, orients = _extension_queries(
        table_hi, table_lo, n_unique, k)

    ids = jnp.arange(capacity, dtype=I32)
    valid_node = ids < n_unique
    sent = U32(0xFFFFFFFF)

    # records: table entries first-in-run (payload < capacity), then
    # queries (payload = capacity + query slot). Invalid -> sentinel key.
    tab_h = jnp.where(valid_node, table_hi, sent)
    tab_l = jnp.where(valid_node, table_lo, sent)
    q_h = jnp.concatenate([jnp.where(valid_o, chs[b], sent) for b in range(4)])
    q_l = jnp.concatenate([jnp.where(valid_o, cls[b], sent) for b in range(4)])
    rec_h = jnp.concatenate([tab_h, q_h])
    rec_l = jnp.concatenate([tab_l, q_l])
    payload = jnp.concatenate([
        ids, capacity + jnp.arange(4 * n2, dtype=I32)])

    sh_, sl_, sp = jax.lax.sort((rec_h, rec_l, payload), num_keys=3)

    m = sh_.shape[0]
    first = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (sh_[1:] != sh_[:-1]) | (sl_[1:] != sl_[:-1]),
    ])
    pos_idx = jnp.arange(m, dtype=I32)
    runstart = jax.lax.cummax(jnp.where(first, pos_idx, 0))
    head_payload = sp[runstart]  # segmented broadcast of run-head payload
    # a query matches iff its run head is a table record
    is_query = sp >= capacity
    hit = is_query & (head_payload < capacity) & (sh_ != sent)
    qslot = jnp.where(is_query, sp - capacity, 4 * n2)
    answers = jnp.full((4 * n2,), -1, dtype=I32).at[
        jnp.where(hit, qslot, 4 * n2)].set(head_payload, mode="drop")

    orient = jnp.concatenate(orients)
    succ_flat = jnp.where(answers >= 0, 2 * answers + orient, -1)
    succ = succ_flat.reshape(4, n2).T
    return succ, okv_hi, okv_lo


@functools.partial(jax.jit, static_argnames=("k",))
def build_graph_kjoin(table_hi, table_lo, n_unique, k: int):
    """Graph build as a (k-1)-mer suffix/prefix join (fastest path).

    An edge u->v exists iff suffix_{k-1}(okv(u)) == prefix_{k-1}(okv(v)):
    v is then exactly u shifted left with v's last base appended. So
    instead of generating all 8C canonicalized extension queries and
    joining them against the table (9C records, build_graph_join), emit
    one suffix record and one prefix record per oriented node (4C
    records), sort once by the (k-1)-mer key, and broadcast each run's
    <=4 prefix-side nodes (distinct last bases) to its suffix-side nodes
    with a segmented scan. No canonicalization and no binary search:
    groups are intrinsic to the oriented values.
    """
    capacity = table_hi.shape[0]
    n2 = 2 * capacity
    ids = jnp.arange(capacity, dtype=I32)
    valid_node = ids < n_unique

    rh, rl = u64.revcomp(table_hi, table_lo, k)
    okv_hi = jnp.stack([table_hi, rh], axis=1).reshape(-1)
    okv_lo = jnp.stack([table_lo, rl], axis=1).reshape(-1)
    valid_o = jnp.repeat(valid_node, 2)

    # suffix key = okv & (2^(2k-2)-1); prefix key = okv >> 2  (both 2k-2 bits)
    if k > 16:
        s_hi = okv_hi & U32((1 << (2 * k - 34)) - 1)
        s_lo = okv_lo
    else:
        s_hi = jnp.zeros_like(okv_hi)
        s_lo = okv_lo & U32((1 << (2 * k - 2)) - 1)
    p_hi, p_lo = u64.shr(okv_hi, okv_lo, 2)
    last2 = (okv_lo & U32(3)).astype(I32)

    sent = U32(0xFFFFFFFF)
    oid = jnp.arange(n2, dtype=I32)
    # The record SIDE rides in bit 0 of the key (key41 = kmer40 << 1 | side,
    # side 0 = prefix/B so it sorts first in its run, 1 = suffix/A): a
    # 2-key sort then fully orders records, where the old layout needed the
    # payload as a third sort key (num_keys=3) just to order B before A —
    # one fewer word through the comparator on the hottest build sort.
    # Invalid records get (sent, sent-1+side) so the B/A side bit survives
    # sentinelization (an invalid B must still be droppable by bit 0).
    pay_b = ((oid << 2) | last2).astype(U32)
    pay_a = (oid << 2).astype(U32)
    bh, bl = u64.shl(p_hi, p_lo, 1)
    ah, al = u64.shl(s_hi, s_lo, 1)
    al = al | U32(1)
    rec_h = jnp.concatenate([jnp.where(valid_o, bh, sent),
                             jnp.where(valid_o, ah, sent)])
    rec_l = jnp.concatenate([jnp.where(valid_o, bl, sent - U32(1)),
                             jnp.where(valid_o, al, sent)])
    payload = jnp.concatenate([pay_b, pay_a])

    sh_, sl_, sp = jax.lax.sort((rec_h, rec_l, payload), num_keys=2)

    m = sh_.shape[0]
    is_b = (sl_ & U32(1)) == 0
    vid = ((sp >> U32(2)) & U32((1 << 29) - 1)).astype(I32)
    vb = (sp & U32(3)).astype(I32)
    # per-base slot value carried by B records; -1 elsewhere
    slots = jnp.stack([jnp.where(is_b & (vb == b), vid, -1)
                       for b in range(4)], axis=1)

    # Runs are provably short: a (k-1)-mer key groups <=4 prefix records
    # (distinct last bases) and <=4 suffix records (distinct first bases),
    # and prefix records sort first (key bit 0). So every suffix record
    # sees all its run's slots within the previous 7 positions — a bounded
    # lookback replaces a segmented scan entirely. Run identity masks the
    # side bit out of the key (>> 1).
    bcast = slots
    for s in range(1, 8):
        same = (sh_[s:] == sh_[:-s]) & ((sl_[s:] >> U32(1)) == (sl_[:-s] >> U32(1)))
        shifted = jnp.where(same[:, None], slots[:-s], -1)
        pad = jnp.full((s, 4), -1, dtype=I32)
        bcast = jnp.maximum(bcast, jnp.concatenate([pad, shifted]))
    # suffix-side rows read their run's slots; sentinel runs yield -1
    # (a sentinel B record can't exist: valid_o masked both sides)
    succ_rows = jnp.where((~is_b)[:, None] & (sh_ != sent)[:, None],
                          bcast, -1)
    # Route rows to succ[u] by SORTING on the oriented id: every id
    # 0..n2-1 occurs exactly once as a suffix record (B records key to n2
    # and fall off the end), so sorted position == row index.
    a_oid = jnp.where(~is_b, vid, n2)
    o = jax.lax.sort((a_oid,) + tuple(succ_rows[:, b] for b in range(4)),
                     num_keys=1)
    succ = jnp.stack([o[1][:n2], o[2][:n2], o[3][:n2], o[4][:n2]], axis=1)
    return succ, okv_hi, okv_lo


# default: the (k-1)-join build (fast path); the extension join and
# bsearch are kept for the sharded boundary-probe path and as oracles
build_graph_device = build_graph_kjoin
