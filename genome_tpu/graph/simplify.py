"""T2: graph simplification under jit (SURVEY.md §3.3).

Reference analog: worklist/DFS tip clipping, bubble popping and unitig
compaction mutating a JVM object graph. Here: data-parallel masked
passes over static-capacity arrays — chain decomposition is pointer
*doubling* (O(log n) gather rounds instead of sequential walks), tips and
bubbles are per-chain predicates + scatter kills, and the fixpoint loop
runs in host Python with device changed-flags (SEMANTICS §5 pins).

All shapes are static in the table capacity C; n_unique is dynamic.
Oriented node ids v = 2*i + s as in SEMANTICS §3; `rc(v) = v ^ 1`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from genome_tpu.kernels import u64
from genome_tpu.kernels.compact import compact

I32 = jnp.int32
U32 = jnp.uint32


def _degrees(succ, alive_o):
    """outdeg + unique-successor per oriented node against alive mask."""
    tgt = succ  # [2C, 4]
    ok = (tgt >= 0) & alive_o[jnp.clip(tgt, 0, None)] & alive_o[:, None]
    outdeg = ok.sum(axis=1, dtype=I32)
    usucc = jnp.where(ok, tgt, -1).max(axis=1)
    return outdeg, usucc


def _pairswap(x):
    """x[i ^ 1] without a gather: the RC twin lives in the paired slot."""
    return x.reshape(-1, 2)[:, ::-1].reshape(-1)


def _links(outdeg, usucc):
    """next/prev unique-link arrays (SEMANTICS §4)."""
    has = outdeg == 1
    w = jnp.where(has, usucc, 0)
    next_u = jnp.where(has & (outdeg[w ^ 1] == 1), w, -1)
    nx = _pairswap(next_u)
    prev_u = jnp.where(nx >= 0, nx ^ 1, -1)
    return next_u, prev_u


def _chain_state(succ, okv_hi, okv_lo, counts, alive, valid_node,
                 max_len: int | None = None):
    """Chain decomposition by pointer doubling. Returns per-oriented-node
    and per-head arrays (all [2C]-shaped; OOB scatter ids are dropped).

    valid_node: bool [C] — which table slots hold real nodes (a prefix mask
    single-host; an arbitrary mask for hash-partitioned global tables).

    max_len (static): when the caller only acts on chains of length
    <= max_len (tips/bubbles), doubling may stop after
    ~log2(max_len) + 1 rounds instead of log2(n2): truncation can never
    mint a false head (head == ids requires prev == -1), and a longer
    chain's computed length is min(true_len, 2^rounds) > max_len, so it
    still fails the length predicate. Only full-rounds callers
    (final_chain_state) see exact lengths for arbitrarily long chains."""
    capacity = alive.shape[0]
    n2 = 2 * capacity
    ids = jnp.arange(n2, dtype=I32)
    alive_o = jnp.repeat(alive & valid_node, 2)

    outdeg, usucc = _degrees(succ, alive_o)
    next_u, prev_u = _links(outdeg, usucc)

    rounds = max(1, (n2 - 1).bit_length() + 1)
    if max_len is not None:
        rounds = min(rounds, max(2, int(max_len).bit_length() + 1))
    p0 = jnp.where(prev_u >= 0, prev_u, ids)

    # head + distance doubling with UNBROKEN prev first: its converged
    # pointer doubles as the cycle detector (a path node's 2^rounds
    # ancestor is its head, with prev == -1; a cycle member's is still
    # in-cycle), so the old separate phase-1 q-loop (one more gather per
    # round) is gone. When cycles exist, phase 2 reruns with prev broken
    # at the cycle reps — acyclic graphs (the common case) never pay.
    def hd(_, carry):
        pp, dd = carry
        return pp[pp], dd + dd[pp]

    def run_phase2(prev_arr):
        p_ = jnp.where(prev_arr >= 0, prev_arr, ids)
        d_ = jnp.where(prev_arr >= 0, 1, 0).astype(I32)
        return jax.lax.fori_loop(0, rounds, hd, (p_, d_))

    p, d = run_phase2(prev_u)
    in_cycle = alive_o & (prev_u[p] >= 0)

    if max_len is None:
        # cycle head = node with min oriented k-mer value (SEMANTICS §4;
        # value-based, layout-independent). Min-doubling carrying
        # (okv, id); then redo head/dist with cycles broken at reps.
        def mndbl(_, carry):
            mh, ml, mi, qq = carry
            ch, cl, ci = mh[qq], ml[qq], mi[qq]
            take = u64.lt(ch, cl, mh, ml)
            mh = jnp.where(take, ch, mh)
            ml = jnp.where(take, cl, ml)
            mi = jnp.where(take, ci, mi)
            return mh, ml, mi, qq[qq]

        def cycle_path(_):
            _, _, mn_i, q_f = jax.lax.fori_loop(
                0, rounds, mndbl, (okv_hi, okv_lo, ids, p0))
            # verify the window actually wrapped: in a true cycle every
            # member's window min is the same node; on a path, my window
            # and my 2^rounds-ancestor's window are disjoint node sets,
            # so their mins differ (okv values are unique).
            rep_break = in_cycle & (mn_i == ids) & (mn_i[q_f] == mn_i)
            prev2 = jnp.where(rep_break, -1, prev_u)
            return run_phase2(prev2)

        p, d = jax.lax.cond(in_cycle.any(), cycle_path,
                            lambda _: (p, d), None)
    # tip/bubble (max_len) passes never act on cycles: unbroken cycle
    # members never satisfy head == ids (no fixpoint), and the wraparound
    # case (cycle length divides 2^rounds, head == ids everywhere) is
    # excluded by the candidates' ~cyc_head condition — so cycle breaking
    # is skipped there entirely.
    head = jnp.where(alive_o, p, -1)
    dist = jnp.where(alive_o, d, 0)
    is_head = alive_o & (head == ids)

    # per-head aggregates (segment id = head; dead nodes -> OOB id n2)
    seg = jnp.where(alive_o, head, n2)
    length = jax.ops.segment_max(dist + 1, seg, num_segments=n2)
    length = jnp.where(is_head, length, 0)
    cyc_head = jnp.zeros(n2, dtype=jnp.bool_).at[
        jnp.where(in_cycle, head, n2)].set(True, mode="drop")
    is_tail = alive_o & (next_u == -1)
    tail_of = jnp.full(n2, -1, dtype=I32).at[
        jnp.where(is_tail, head, n2)].set(ids, mode="drop")
    node_counts = jnp.repeat(counts, 2).astype(U32)
    # coverage limbs (exact sums; bubble chains are short so limbs fit)
    cov_lo = jax.ops.segment_sum(node_counts & U32(0xFFFF), seg, num_segments=n2)
    cov_hi = jax.ops.segment_sum(node_counts >> U32(16), seg, num_segments=n2)
    cov_hi = cov_hi + (cov_lo >> U32(16))
    cov_lo = cov_lo & U32(0xFFFF)
    # twin-head okv: okv(rc(tail)) for paths, min okv over RC set for cycles
    tail_c = jnp.clip(tail_of, 0, None)
    twin_hi = jnp.where(tail_of >= 0, okv_hi[tail_c ^ 1], U32(0xFFFFFFFF))
    twin_lo = jnp.where(tail_of >= 0, okv_lo[tail_c ^ 1], U32(0xFFFFFFFF))
    cyc_seg = jnp.where(in_cycle, head, n2)
    cyc_hi = jnp.full(n2, 0xFFFFFFFF, dtype=U32).at[cyc_seg].min(
        okv_hi[ids ^ 1], mode="drop")
    # two-word segment-min: min lo among nodes whose hi attains the min
    lo_cand = jnp.where(okv_hi[ids ^ 1] == cyc_hi[jnp.clip(head, 0, None)],
                        okv_lo[ids ^ 1], U32(0xFFFFFFFF))
    cyc_lo = jnp.full(n2, 0xFFFFFFFF, dtype=U32).at[cyc_seg].min(
        lo_cand, mode="drop")
    use_cyc = is_head & cyc_head
    twin_hi = jnp.where(use_cyc, cyc_hi, twin_hi)
    twin_lo = jnp.where(use_cyc, cyc_lo, twin_lo)

    return dict(outdeg=outdeg, usucc=usucc, next_u=next_u, head=head,
                dist=dist, is_head=is_head, length=length, cyc_head=cyc_head,
                tail_of=tail_of, cov_hi=cov_hi, cov_lo=cov_lo,
                twin_hi=twin_hi, twin_lo=twin_lo, alive_o=alive_o)


def _kill_heads(alive, st, doomed_heads: jax.Array):
    """Kill every canonical node whose chain head is doomed."""
    head = st["head"]
    node_doomed = st["alive_o"] & (head >= 0) & doomed_heads[jnp.clip(head, 0, None)]
    canon_doomed = node_doomed.reshape(-1, 2).any(axis=1)
    return alive & ~canon_doomed


@functools.partial(jax.jit, static_argnames=("max_len",))
def clip_tips_pass_dense(succ, okv_hi, okv_lo, counts, alive, valid_node,
                         tip_len, max_len: int | None = None):
    """One tip-clipping pass, dense form: per-node truncated pointer
    doubling over all 2C oriented nodes (SEMANTICS §5). Kept as the
    semantic oracle and as the fallback when the walk pass's candidate
    buffer overflows. Returns (alive, changed).

    max_len: static copy of tip_len enabling truncated doubling
    (_chain_state docstring); semantics are identical with or without."""
    st = _chain_state(succ, okv_hi, okv_lo, counts, alive, valid_node,
                      max_len)
    n2 = succ.shape[0]
    ids = jnp.arange(n2, dtype=I32)
    cand = st["is_head"] & ~st["cyc_head"] & (st["length"] <= tip_len)
    start_open = st["outdeg"][ids ^ 1] == 0  # indeg(head) == 0
    tails = st["tail_of"]
    end_open = (tails >= 0) & (st["outdeg"][jnp.clip(tails, 0, None)] == 0)
    doomed = cand & (start_open != end_open)
    alive2 = _kill_heads(alive, st, doomed)
    return alive2, doomed.any()


@functools.partial(jax.jit, static_argnames=("max_len",))
def pop_bubbles_pass_dense(succ, okv_hi, okv_lo, counts, alive, valid_node,
                           bubble_len, max_len: int | None = None):
    """One bubble-popping pass, dense form (oracle / overflow fallback;
    see clip_tips_pass_dense). Returns (alive, changed).

    max_len: static copy of bubble_len enabling truncated doubling."""
    st = _chain_state(succ, okv_hi, okv_lo, counts, alive, valid_node,
                      max_len)
    n2 = succ.shape[0]
    ids = jnp.arange(n2, dtype=I32)
    outdeg, usucc = st["outdeg"], st["usucc"]
    tails = st["tail_of"]
    indeg_head = outdeg[ids ^ 1]
    tail_c = jnp.clip(tails, 0, None)
    cand = (st["is_head"] & ~st["cyc_head"] & (st["length"] <= bubble_len)
            & (indeg_head == 1) & (tails >= 0) & (outdeg[tail_c] == 1))
    p = jnp.where(cand, usucc[ids ^ 1] ^ 1, 0)   # unique pred of head
    s = jnp.where(cand, usucc[tail_c], 0)        # unique succ of tail

    def okv(idx):
        return okv_hi[idx], okv_lo[idx]

    # direction pin: (okv[p], okv[s]) <= (okv[s^1], okv[p^1]) lex
    ph, pl = okv(p)
    sh_, sl_ = okv(s)
    rsh, rsl = okv(s ^ 1)
    rph, rpl = okv(p ^ 1)
    proc = u64.lt(ph, pl, rsh, rsl) | (u64.eq(ph, pl, rsh, rsl) & u64.le(sh_, sl_, rph, rpl))
    selfrc = p == (s ^ 1)
    primary = u64.le(okv_hi[ids], okv_lo[ids], st["twin_hi"], st["twin_lo"])
    keep = cand & proc & (~selfrc | primary)

    big = jnp.int32(n2)
    p_k = jnp.where(keep, p, big)
    s_k = jnp.where(keep, s, big)
    # sort by (p, s, cov desc, okv(head) asc); first of each group is kept
    keys = (p_k, s_k, ~st["cov_hi"], ~st["cov_lo"], okv_hi[ids], okv_lo[ids])
    sp, ss, _, _, _, _, sh = jax.lax.sort(keys + (ids,), num_keys=6)
    validm = sp < big
    same_prev = jnp.concatenate([
        jnp.zeros((1,), dtype=jnp.bool_),
        (sp[1:] == sp[:-1]) & (ss[1:] == ss[:-1]),
    ])
    doomed_sorted = validm & same_prev  # non-first member of a >=2 group
    doomed = jnp.zeros(n2, dtype=jnp.bool_).at[
        jnp.where(doomed_sorted, sh, big)].set(True, mode="drop")
    alive2 = _kill_heads(alive, st, doomed)
    return alive2, doomed.any()


# ---------------------------------------------------------------------------
# Walk-based tip/bubble passes (round-2 fast path).
#
# Tips and bubbles only ever act on chains of length <= tip_len/bubble_len
# (~2k+1 nodes), yet the dense passes pay O(rounds) full-array gathers over
# all 2C oriented nodes per pass. The number of CHAINS is tiny by comparison
# (#unitigs ~ 1e4 on a filtered E. coli graph), so instead: compute degrees
# and links once (vector ops + a few full gathers), compact the chain HEAD
# ids to an M-slot buffer (kernels/compact.py), walk forward
# <= L steps on M-sized arrays recording the path, evaluate the identical
# SEMANTICS §5 predicates on the compacted candidates, and kill doomed
# chains with one scatter over the recorded paths. Exactly the dense
# semantics (CI-enforced equivalence); ~20x less gather traffic. If heads
# exceed M, the wrapper escalates M and finally falls back to the dense
# pass, discarding the partial result (a truncated candidate set could
# mis-pick a bubble group winner, so partial results are never used).
# ---------------------------------------------------------------------------

_WALK_M = (65536, 262144)  # candidate-buffer escalation ladder


def _walk_stats(next_u, counts, heads, n_heads, L: int, want_cov: bool):
    """Walk <= L link steps forward from each head (vectorized over the M
    compacted heads). Returns per-head chain stats + the visited path.

    length saturates at L+1 (chains longer than L keep tail == -1 and a
    length that still fails any `<= L` predicate — same contract as the
    dense truncated doubling). Coverage uses the same 16-bit limb split as
    _chain_state so bubble tie-breaks compare identically."""
    M = heads.shape[0]
    n2 = next_u.shape[0]
    capacity = counts.shape[0]
    real = jnp.arange(M, dtype=I32) < n_heads
    cur = jnp.where(real, heads, 0)
    path = [jnp.where(real, cur, -1)]
    length = jnp.where(real, 1, 0).astype(I32)
    covlo = covhi = None
    if want_cov:
        c0 = jnp.where(real, counts[jnp.clip(cur >> 1, 0, capacity - 1)], 0)
        c0 = c0.astype(U32)
        covlo = c0 & U32(0xFFFF)
        covhi = c0 >> U32(16)
    tail = jnp.full((M,), -1, dtype=I32)
    done = ~real
    for _ in range(L):
        nxt = next_u[jnp.clip(cur, 0, n2 - 1)]
        nx = jnp.where(done, -1, nxt)
        hit = (~done) & (nx < 0)
        tail = jnp.where(hit, cur, tail)
        done = done | (nx < 0)
        ext = nx >= 0
        cur = jnp.where(ext, nx, cur)
        path.append(jnp.where(ext, cur, -1))
        if want_cov:
            c = counts[jnp.clip(cur >> 1, 0, capacity - 1)].astype(U32)
            covlo = covlo + jnp.where(ext, c & U32(0xFFFF), U32(0))
            covhi = covhi + jnp.where(ext, c >> U32(16), U32(0))
        length = length + ext.astype(I32)
    # tail for chains of length exactly L (probe already consumed) is set;
    # longer chains keep tail = -1 and length = L + 1 > any threshold
    nxt = next_u[jnp.clip(cur, 0, n2 - 1)]
    hit = (~done) & (jnp.where(done, -1, nxt) < 0)
    tail = jnp.where(hit, cur, tail)
    st = dict(real=real, length=length, tail=tail,
              path=jnp.stack(path, axis=0))
    if want_cov:
        st["cov_hi"] = covhi + (covlo >> U32(16))
        st["cov_lo"] = covlo & U32(0xFFFF)
    return st


def _kill_paths(alive, path, doomed_m):
    """Kill every canonical node on a doomed head's recorded path."""
    capacity = alive.shape[0]
    kill = doomed_m[None, :] & (path >= 0)
    canon = jnp.where(kill, path >> 1, capacity)
    return alive.at[canon.reshape(-1)].set(False, mode="drop")


def _tips_body(succ, okv_hi, okv_lo, counts, alive, valid_node, outdeg,
               usucc, next_u, prev_u, tip_len, L: int, M: int):
    capacity = alive.shape[0]
    n2 = 2 * capacity
    alive_o = jnp.repeat(alive & valid_node, 2)
    is_head = alive_o & (prev_u < 0)
    _, heads, n_heads, ovf = compact(is_head, (), M)
    st = _walk_stats(next_u, counts, heads, n_heads, L, want_cov=False)
    h = jnp.where(st["real"], heads, 0)
    tail = st["tail"]
    tailc = jnp.clip(tail, 0, n2 - 1)
    cand = st["real"] & (st["length"] <= tip_len)
    start_open = outdeg[h ^ 1] == 0
    end_open = (tail >= 0) & (outdeg[tailc] == 0)
    doomed = cand & (start_open != end_open)
    alive2 = _kill_paths(alive, st["path"], doomed)
    return alive2, doomed.any(), ovf, next_u, prev_u, st["path"], doomed


@functools.partial(jax.jit, static_argnames=("L", "M"))
def _clip_tips_walk(succ, okv_hi, okv_lo, counts, alive, valid_node,
                    tip_len, L: int, M: int):
    alive_o = jnp.repeat(alive & valid_node, 2)
    outdeg, usucc = _degrees(succ, alive_o)
    next_u, prev_u = _links(outdeg, usucc)
    r = _tips_body(succ, okv_hi, okv_lo, counts, alive, valid_node,
                   outdeg, usucc, next_u, prev_u, tip_len, L, M)
    return r[:5]


def _bubbles_body(succ, okv_hi, okv_lo, counts, alive, valid_node, outdeg,
                  usucc, next_u, prev_u, bubble_len, L: int, M: int):
    capacity = alive.shape[0]
    n2 = 2 * capacity
    alive_o = jnp.repeat(alive & valid_node, 2)
    is_head = alive_o & (prev_u < 0)
    _, heads, n_heads, ovf = compact(is_head, (), M)
    st = _walk_stats(next_u, counts, heads, n_heads, L, want_cov=True)
    h = jnp.where(st["real"], heads, 0)
    tail = st["tail"]
    tailc = jnp.clip(tail, 0, n2 - 1)
    indeg_head = outdeg[h ^ 1]
    cand = (st["real"] & (st["length"] <= bubble_len) & (indeg_head == 1)
            & (tail >= 0) & (outdeg[tailc] == 1))
    p = jnp.where(cand, usucc[h ^ 1] ^ 1, 0)
    s = jnp.where(cand, usucc[tailc], 0)

    def okv(idx):
        return okv_hi[idx], okv_lo[idx]

    ph, pl = okv(p)
    sh_, sl_ = okv(s)
    rsh, rsl = okv(s ^ 1)
    rph, rpl = okv(p ^ 1)
    proc = u64.lt(ph, pl, rsh, rsl) | (u64.eq(ph, pl, rsh, rsl)
                                       & u64.le(sh_, sl_, rph, rpl))
    selfrc = p == (s ^ 1)
    twin_hi = jnp.where(tail >= 0, okv_hi[tailc ^ 1], U32(0xFFFFFFFF))
    twin_lo = jnp.where(tail >= 0, okv_lo[tailc ^ 1], U32(0xFFFFFFFF))
    primary = u64.le(okv_hi[h], okv_lo[h], twin_hi, twin_lo)
    keep = cand & proc & (~selfrc | primary)

    big = jnp.int32(n2)
    p_k = jnp.where(keep, p, big)
    s_k = jnp.where(keep, s, big)
    mids = jnp.arange(heads.shape[0], dtype=I32)
    # identical key tuple + stable sort as the dense pass: candidates enter
    # in ascending head-id order (compaction preserves stream order)
    keys = (p_k, s_k, ~st["cov_hi"], ~st["cov_lo"], okv_hi[h], okv_lo[h])
    sp, ss, _, _, _, _, si = jax.lax.sort(keys + (mids,), num_keys=6)
    validm = sp < big
    same_prev = jnp.concatenate([
        jnp.zeros((1,), dtype=jnp.bool_),
        (sp[1:] == sp[:-1]) & (ss[1:] == ss[:-1]),
    ])
    doomed_sorted = validm & same_prev
    doomed = jnp.zeros(heads.shape[0], dtype=jnp.bool_).at[
        jnp.where(doomed_sorted, si, heads.shape[0])].set(True, mode="drop")
    alive2 = _kill_paths(alive, st["path"], doomed)
    return alive2, doomed.any(), ovf, next_u, prev_u, st["path"], doomed


@functools.partial(jax.jit, static_argnames=("L", "M"))
def _pop_bubbles_walk(succ, okv_hi, okv_lo, counts, alive, valid_node,
                      bubble_len, L: int, M: int):
    alive_o = jnp.repeat(alive & valid_node, 2)
    outdeg, usucc = _degrees(succ, alive_o)
    next_u, prev_u = _links(outdeg, usucc)
    r = _bubbles_body(succ, okv_hi, okv_lo, counts, alive, valid_node,
                      outdeg, usucc, next_u, prev_u, bubble_len, L, M)
    return r[:5]


def clip_tips_pass(succ, okv_hi, okv_lo, counts, alive, valid_node, tip_len,
                   max_len: int | None = None, walk_m=_WALK_M,
                   with_links: bool = False):
    """One tip-clipping pass (SEMANTICS §5). Returns (alive, changed)
    [+ links when with_links].

    Walk-based fast path when max_len is static; escalates the candidate
    buffer through the `walk_m` ladder and falls back to the dense pass
    on overflow (walk_m is overridable so CI can force every rung).

    with_links: additionally return (next_u, prev_u) as computed on the
    PRE-kill alive mask (valid for the post state only when changed is
    False), or None on the dense fallback — lets the fixpoint loop hand
    the final round's links to final_chain_state instead of recomputing
    the degree gathers."""
    if max_len is None:
        r = clip_tips_pass_dense(succ, okv_hi, okv_lo, counts, alive,
                                 valid_node, tip_len, None)
        return (*r, None) if with_links else r
    for M in walk_m:
        alive2, changed, ovf, nx, pv = _clip_tips_walk(
            succ, okv_hi, okv_lo, counts, alive, valid_node, tip_len,
            L=int(max_len), M=M)
        if not bool(ovf):
            return ((alive2, changed, (nx, pv)) if with_links
                    else (alive2, changed))
    r = clip_tips_pass_dense(succ, okv_hi, okv_lo, counts, alive,
                             valid_node, tip_len, max_len)
    return (*r, None) if with_links else r


def pop_bubbles_pass(succ, okv_hi, okv_lo, counts, alive, valid_node,
                     bubble_len, max_len: int | None = None, walk_m=_WALK_M,
                     with_links: bool = False):
    """One bubble-popping pass (SEMANTICS §5). Returns (alive, changed)
    [+ links when with_links, see clip_tips_pass].

    Walk-based fast path when max_len is static; dense fallback on
    candidate overflow (partial walk results are always discarded).
    walk_m: candidate-buffer ladder, overridable for CI."""
    if max_len is None:
        r = pop_bubbles_pass_dense(succ, okv_hi, okv_lo, counts, alive,
                                   valid_node, bubble_len, None)
        return (*r, None) if with_links else r
    for M in walk_m:
        alive2, changed, ovf, nx, pv = _pop_bubbles_walk(
            succ, okv_hi, okv_lo, counts, alive, valid_node, bubble_len,
            L=int(max_len), M=M)
        if not bool(ovf):
            return ((alive2, changed, (nx, pv)) if with_links
                    else (alive2, changed))
    r = pop_bubbles_pass_dense(succ, okv_hi, okv_lo, counts, alive,
                               valid_node, bubble_len, max_len)
    return (*r, None) if with_links else r


# ---------------------------------------------------------------------------
# Incremental degree maintenance (round-3). Each walk pass used to pay a
# full [2C, 4] alive-gather to recompute (outdeg, usucc) from scratch,
# even for the final verification round that kills nothing. Kills per pass are tiny by comparison, and a kill
# only changes the degrees of the dead nodes' in-neighbors (reachable by
# RC symmetry: in-neighbors of v = rc(successors of rc(v))), so the loop
# now carries (outdeg, usucc) across passes and updates just the
# affected rows: scatter-subtract per lost edge, re-derive usucc on the
# O(kills) affected set. Results are bit-identical to the dense
# recompute (dead rows included: outdeg 0, usucc -1) — CI-enforced.
# ---------------------------------------------------------------------------

_KILL_M = 65536  # compacted killed-node capacity; overflow -> dense recompute


def _update_degrees(succ, alive2, valid_node, path, doomed_m, outdeg, usucc,
                    next_u, Mk: int):
    """(outdeg, usucc, next_u, prev_u) for alive2, given their values for
    the pre-kill alive and the pass's kill set (doomed walk paths).
    Exactly equal to the dense recompute; kovf set when kills exceed Mk
    (results then unusable — caller recomputes densely), lovf when the
    link-affected set exceeds its buffer (links then unusable, degrees
    still good).

    Link rule: next[v] = usucc[v] iff outdeg[v]==1 and
    outdeg[usucc[v]^1]==1 (_links). Its inputs change only at A = tgt
    (in-neighbors of killed, both orientations) + dead rows, or for v
    with usucc[v]^1 in A — and such v satisfy v in rc(succ(A)) by RC
    edge symmetry (v -> b^1 exists iff b -> v^1 exists), so recomputing
    next over A + rc(succ(A)) and deriving prev by the pairswap identity
    reproduces _links exactly without its full-size gather."""
    n2 = succ.shape[0]
    kill = doomed_m[None, :] & (path >= 0)
    canon = jnp.where(kill, path >> 1, 0).reshape(-1).astype(I32)
    (kc,), _, nk, kovf = compact(kill.reshape(-1), (canon,), Mk)
    real = jnp.arange(Mk, dtype=I32) < jnp.minimum(nk, Mk)
    # DEDUP: a self-RC chain's walk path can visit both orientations of
    # one canonical node; without dedup its lost edges would be
    # subtracted twice (usucc, being a recompute, would survive — outdeg
    # would not)
    big = jnp.int32(n2)  # > any canonical id
    (kc_s,) = jax.lax.sort((jnp.where(real, kc, big),), num_keys=1)
    first = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                             kc_s[1:] != kc_s[:-1]])
    real = first & (kc_s != big)
    kc_ = jnp.where(real, kc_s, 0)
    alive_o2 = jnp.repeat(alive2 & valid_node, 2)
    # all out-edges of both orientations of each killed node; each edge
    # (rc(w) -> killed) loses rc(w) one outdegree
    rows0 = succ[jnp.clip(2 * kc_, 0, n2 - 1)]
    rows1 = succ[jnp.clip(2 * kc_ + 1, 0, n2 - 1)]
    w = jnp.concatenate([rows0, rows1], axis=1)  # [Mk, 8]
    wc = jnp.clip(w, 0, n2 - 1)
    wv = (w >= 0) & real[:, None] & alive_o2[wc]
    tgt = jnp.where(wv, wc ^ 1, n2)
    outdeg2 = outdeg.at[tgt.reshape(-1)].add(
        -wv.reshape(-1).astype(I32), mode="drop")
    # dead rows take the dense recompute's values (outdeg 0, usucc -1)
    dead = jnp.where(real[:, None],
                     2 * kc_[:, None] + jnp.arange(2, dtype=I32)[None, :], n2)
    outdeg2 = outdeg2.at[dead.reshape(-1)].set(0, mode="drop")
    # usucc changed exactly on the affected in-neighbors: recompute there
    su = succ[jnp.clip(tgt, 0, n2 - 1)]  # [Mk, 8, 4]
    at_ = (su >= 0) & alive_o2[jnp.clip(su, 0, n2 - 1)]
    new_us = jnp.where(at_, su, -1).max(axis=2)
    usucc2 = usucc.at[tgt.reshape(-1)].set(new_us.reshape(-1), mode="drop")
    usucc2 = usucc2.at[dead.reshape(-1)].set(-1, mode="drop")

    # ---- incremental next/prev links (docstring rule) ----
    M2 = 2 * Mk
    aff0 = jnp.concatenate([tgt.reshape(-1), dead.reshape(-1)])
    (ac,), _, n_aff, lovf = compact(aff0 < n2, (aff0,), M2)
    areal = jnp.arange(M2, dtype=I32) < jnp.minimum(n_aff, M2)
    acc = jnp.clip(jnp.where(areal, ac, 0), 0, n2 - 1)
    sa = succ[acc]                                   # [M2, 4]
    cand = jnp.where((sa >= 0) & areal[:, None], sa ^ 1, n2)
    aff = jnp.concatenate([jnp.where(areal, acc, n2), cand.reshape(-1)])
    affc = jnp.clip(aff, 0, n2 - 1)
    wl = usucc2[affc]
    wlc = jnp.clip(wl ^ 1, 0, n2 - 1)
    okl = (outdeg2[affc] == 1) & (wl >= 0) & (outdeg2[wlc] == 1)
    nval = jnp.where(okl, wl, -1)
    next2 = next_u.at[jnp.where(aff < n2, aff, n2)].set(nval, mode="drop")
    nx = _pairswap(next2)
    prev2 = jnp.where(nx >= 0, nx ^ 1, -1)
    return outdeg2, usucc2, next2, prev2, kovf, lovf


@jax.jit
def _degrees_jit(succ, alive, valid_node):
    alive_o = jnp.repeat(alive & valid_node, 2)
    return _degrees(succ, alive_o)


@functools.partial(jax.jit, static_argnames=("L", "M", "Mk"))
def _clip_tips_walk_inc(succ, okv_hi, okv_lo, counts, alive, valid_node,
                        outdeg, usucc, next_u, prev_u, tip_len, L: int,
                        M: int, Mk: int):
    alive2, changed, ovf, nx, pv, path, doomed = _tips_body(
        succ, okv_hi, okv_lo, counts, alive, valid_node, outdeg, usucc,
        next_u, prev_u, tip_len, L, M)
    od2, us2, nx2, pv2, kovf, lovf = _update_degrees(
        succ, alive2, valid_node, path, doomed, outdeg, usucc, next_u, Mk)
    return alive2, changed, ovf, od2, us2, nx2, pv2, kovf, lovf


@functools.partial(jax.jit, static_argnames=("L", "M", "Mk"))
def _pop_bubbles_walk_inc(succ, okv_hi, okv_lo, counts, alive, valid_node,
                          outdeg, usucc, next_u, prev_u, bubble_len,
                          L: int, M: int, Mk: int):
    alive2, changed, ovf, nx, pv, path, doomed = _bubbles_body(
        succ, okv_hi, okv_lo, counts, alive, valid_node, outdeg, usucc,
        next_u, prev_u, bubble_len, L, M)
    od2, us2, nx2, pv2, kovf, lovf = _update_degrees(
        succ, alive2, valid_node, path, doomed, outdeg, usucc, next_u, Mk)
    return alive2, changed, ovf, od2, us2, nx2, pv2, kovf, lovf


@jax.jit
def _links_jit(outdeg, usucc):
    return _links(outdeg, usucc)


def run_pass_inc(kind: str, succ, okv_hi, okv_lo, counts, alive, valid_node,
                 threshold, max_len: int, deg, links=None, walk_m=_WALK_M):
    """One tip/bubble pass with carried degrees AND links.

    deg: (outdeg, usucc) matching `alive`, or None (computed here).
    links: (next_u, prev_u) matching `alive`, or None (computed here) —
    carrying them across passes skips _links' full-size gather per pass.
    Returns (alive2, changed, links_prekill_or_None, deg2_or_None,
    links2_or_None): the pre-kill links are valid for the post state
    only when changed is False (final_chain_state handover); deg2/links2
    match alive2 unless their update buffers overflowed or the dense
    fallback ran (then None — next pass recomputes).
    """
    walk = _clip_tips_walk_inc if kind == "tips" else _pop_bubbles_walk_inc
    dense = (clip_tips_pass_dense if kind == "tips"
             else pop_bubbles_pass_dense)
    if deg is None:
        deg = _degrees_jit(succ, alive, valid_node)
    if links is None:
        links = _links_jit(deg[0], deg[1])
    for M in walk_m:
        alive2, changed, ovf, od2, us2, nx2, pv2, kovf, lovf = walk(
            succ, okv_hi, okv_lo, counts, alive, valid_node, deg[0], deg[1],
            links[0], links[1], threshold, L=int(max_len), M=M, Mk=_KILL_M)
        if bool(ovf):
            continue
        if bool(kovf):
            return alive2, changed, links, None, None
        links2 = None if bool(lovf) else (nx2, pv2)
        return alive2, changed, links, (od2, us2), links2
    a2, ch = dense(succ, okv_hi, okv_lo, counts, alive, valid_node,
                   threshold, max_len)
    return a2, ch, None, None, None



#
# Full pointer doubling costs log2(n2) rounds of two full-size dependent
# gathers over every oriented node.
# Chains only need exact (head, dist) at EMISSION, and ranking a linked
# list has a classical two-level decomposition: pick a ruler set (every
# RULER_STRIDE-th oriented id — ids are sorted-k-mer ranks, so ruler
# placement is hash-random along any chain), double each node's pointer
# only until it lands on a ruler or a head (~log2(max ruler gap) ~ 9
# rounds instead of 25, with a while_loop exiting as soon as every
# pointer is frozen), then rank the ruler graph itself (n2/STRIDE-sized
# arrays — cheap) and compose. Exact same (head, dist) as full doubling
# on acyclic graphs; if any cycle survives to emission (circular
# genomes), a lax.cond falls back to the dense cycle-breaking path.
# ---------------------------------------------------------------------------

RULER_STRIDE = 16  # power of two; gap tail ~ STRIDE * ln(n2)
_TAIL_M = 1 << 18  # compacted chain-tail buffer (chains << nodes after
                   # simplify; error-survivor islands add ~1e4 at E. coli)


_D_BITS = 8          # phase-1 packed distance field; saturates at 255
_P_MASK = (1 << 24) - 1

# Packed-scheme ladder for the phase-1 doubling: (max id bits, ruler
# stride, distance bits, saturation fix-up buffer). The pointer field
# gets 32 - d_bits bits, so bigger id spaces trade distance range (and a
# denser ruler set to keep the gap tail under the saturation cap) for
# pointer width. Fix-up buffer sizes come from the gap-tail arithmetic:
# expected saturated nodes ~ n2 * ((stride-1)/stride)^(2^d_bits - 1) —
# at the worst case of each scheme that is ~0 (24/16/8), ~9e3
# (25/16/7: 2^25 * (15/16)^127), and ~1.5e4 (26/8/6: 2^26 * (7/8)^63);
# each buffer carries >= 4x margin. Beyond 2^26 ids, phase 1 runs
# unpacked (two gathers per round) — that regime belongs to the sharded
# path, whose per-shard id spaces stay under the packed limits.
_PACK_SCHEMES = (
    (24, 16, 8, 4096),
    (25, 16, 7, 1 << 16),
    (26, 8, 6, 1 << 17),
)


def _phase1_unpacked(prev_u, rounds: int, mask):
    """Phase-1 doubling on separate (p, d) arrays (2 gathers/round)."""
    n2 = prev_u.shape[0]
    ids = jnp.arange(n2, dtype=I32)
    p0 = jnp.where(prev_u >= 0, prev_u, ids)
    d0 = jnp.where(prev_u >= 0, 1, 0).astype(I32)

    def p1_cond(c):
        _, _, i, changed = c
        return (i < rounds) & changed

    def p1_body(c):
        p, d, i, _ = c
        pg = p[p]
        dg = d[p]
        adv = (p & mask) != 0  # p not a ruler
        p2 = jnp.where(adv, pg, p)
        d2 = d + jnp.where(adv, dg, 0)
        changed = (adv & (pg != p)).any()
        return p2, d2, i + 1, changed

    p, d, _, _ = jax.lax.while_loop(
        p1_cond, p1_body, (p0, d0, jnp.int32(0), jnp.bool_(True)))
    return p, d


def _phase1_packed(prev_u, rounds: int, stride: int, d_bits: int):
    """Phase-1 doubling with (p, d) PACKED into one uint32 (p in bits
    [0, 32-d_bits), d saturating at 2^d_bits - 1 above): ONE gather per
    round instead of two — the doubling gathers dominate the final
    phase. Returns (p, d): d values below the saturation cap are
    exact (saturation is monotone — a clamped ancestor distance can only
    clamp the dependent sums); saturated slots are repaired by
    _phase1_sat_fixup or the unpacked redo. Caller guarantees
    n2 <= 2^(32 - d_bits)."""
    n2 = prev_u.shape[0]
    ids = jnp.arange(n2, dtype=I32)
    p_bits = 32 - d_bits
    sat = U32((1 << d_bits) - 1)
    pm = U32((1 << p_bits) - 1)
    sh = U32(p_bits)
    p0 = jnp.where(prev_u >= 0, prev_u, ids).astype(U32)
    d0 = jnp.where(prev_u >= 0, U32(1), U32(0))
    x0 = p0 | (d0 << sh)
    umask = U32(stride - 1)

    def p1_cond(c):
        _, i, changed = c
        return (i < rounds) & changed

    def p1_body(c):
        x, i, _ = c
        p = x & pm
        g = x[p]
        pg = g & pm
        dg = g >> sh
        d2 = jnp.minimum((x >> sh) + dg, sat)
        adv = (p & umask) != 0
        x2 = jnp.where(adv, pg | (d2 << sh), x)
        changed = (adv & (pg != p)).any()
        return x2, i + 1, changed

    x, _, _ = jax.lax.while_loop(
        p1_cond, p1_body, (x0, jnp.int32(0), jnp.bool_(True)))
    p = (x & pm).astype(I32)
    d = (x >> sh).astype(I32)
    return p, d


_SAT_K = 4096       # fix-up buffer for saturated-distance nodes
_SAT_STEPS = 1 << 14


def _phase1_sat_fixup(prev_u, p, d, stride: int = RULER_STRIDE,
                      d_bits: int = _D_BITS, sat_k: int = _SAT_K):
    """Exact (p, d) for the nodes whose packed phase-1 distance saturated
    (gap-tail arithmetic per scheme in _PACK_SCHEMES). Walks prev links
    sequentially on a sat_k-compacted buffer — small arrays, bounded
    steps. Returns (p2, d2, ok); ok=False when the buffer overflows or a
    walk failed to freeze (caller then redoes phase 1 unpacked)."""
    n2 = prev_u.shape[0]
    sat_v = d == (1 << d_bits) - 1
    n_sat = sat_v.sum(dtype=I32)
    idsn = jnp.arange(n2, dtype=I32)
    dest = jnp.cumsum(sat_v.astype(I32)) - 1
    scat = jnp.where(sat_v & (dest < sat_k), dest, sat_k)
    vids = jnp.full((sat_k,), -1, I32).at[scat].set(idsn, mode="drop")
    real = jnp.arange(sat_k, dtype=I32) < jnp.minimum(n_sat, sat_k)
    umask = I32(stride - 1)

    v0 = jnp.where(real, vids, 0)
    cur0 = prev_u[v0]          # saturated => prev >= 0
    dd0 = jnp.where(real, 1, 0).astype(I32)

    def w_cond(c):
        cur, dd, i, moving = c
        return (i < _SAT_STEPS) & moving

    def w_body(c):
        cur, dd, i, _ = c
        curc = jnp.clip(cur, 0, n2 - 1)
        frozen = ((cur & umask) == 0) | (prev_u[curc] < 0) | ~real
        nxt = jnp.where(frozen, cur, prev_u[curc])
        dd2 = dd + jnp.where(frozen, 0, 1)
        return nxt, dd2, i + 1, (~frozen).any()

    cur, dd, _, _ = jax.lax.while_loop(
        w_cond, w_body, (cur0, dd0, jnp.int32(0), jnp.bool_(True)))
    curc = jnp.clip(cur, 0, n2 - 1)
    frozen_all = (((cur & umask) == 0) | (prev_u[curc] < 0) | ~real).all()
    ok = (n_sat <= sat_k) & frozen_all
    tgt = jnp.where(real, v0, n2)
    p2 = p.at[tgt].set(cur, mode="drop")
    d2 = d.at[tgt].set(dd, mode="drop")
    return p2, d2, ok


def _rank_rulers_impl(next_u, prev_u, stride: int, d_bits: int,
                      sat_k: int, packed: bool):
    """(head, dist, ok) via ruler ranking at one _PACK_SCHEMES point;
    ok=False iff a cycle was seen (caller falls back to the dense path,
    which breaks cycles)."""
    n2 = next_u.shape[0]
    rounds = max(1, (n2 - 1).bit_length() + 1)
    mask = I32(stride - 1)

    # phase 1: double until every pointer rests on a ruler or a head.
    # Heads are natural fixpoints (p[h] = h), so only rulers need the
    # freeze test — one AND against the id bits, no extra gather.
    # Packed single-gather variant when ids fit the scheme's pointer
    # field; the rare saturated-distance case redoes it unpacked
    # (lax.cond: only the taken branch executes).
    if packed:
        pp, dp = _phase1_packed(prev_u, rounds, stride, d_bits)
        any_sat = (dp == (1 << d_bits) - 1).any()

        def with_fixup(_):
            pf, df, fok = _phase1_sat_fixup(prev_u, pp, dp, stride,
                                            d_bits, sat_k)
            return jax.lax.cond(
                fok, lambda __: (pf, df),
                lambda __: _phase1_unpacked(prev_u, rounds, mask), None)

        p, d = jax.lax.cond(any_sat, with_fixup,
                            lambda _: (pp, dp), None)
    else:
        p, d = _phase1_unpacked(prev_u, rounds, mask)
    # non-convergence at the round bound => a ruler-free cycle exists
    p1_ok = ~(((p & mask) != 0) & (p[p] != p)).any()

    # phase 2: rank the ruler graph (arrays of n2/stride)
    rp0 = p[::stride]
    rd0 = d[::stride]
    r_rounds = max(1, (rp0.shape[0] - 1).bit_length() + 1)

    def p2_cond(c):
        _, _, i, changed = c
        return (i < r_rounds) & changed

    def p2_body(c):
        rp, rd, i, _ = c
        j = jnp.clip(rp // stride, 0, rp.shape[0] - 1)
        pg = rp[j]
        dg = rd[j]
        adv = (rp & mask) == 0  # target is a ruler -> keep jumping
        rp2 = jnp.where(adv, pg, rp)
        rd2 = rd + jnp.where(adv, dg, 0)
        changed = (adv & (pg != rp)).any()
        return rp2, rd2, i + 1, changed

    rp, rd, _, _ = jax.lax.while_loop(
        p2_cond, p2_body, (rp0, rd0, jnp.int32(0), jnp.bool_(True)))
    # ruler-level cycle: some ruler still points at a ruler that moves
    j = jnp.clip(rp // stride, 0, rp.shape[0] - 1)
    p2_ok = ~(((rp & mask) == 0) & (rp[j] != rp)).any()

    # compose: a = nearest ruler-or-head ancestor of v
    a = p
    a_rul = (a & mask) == 0
    aj = jnp.clip(a // stride, 0, rp.shape[0] - 1)
    head = jnp.where(a_rul, rp[aj], a)
    dist = d + jnp.where(a_rul, rd[aj], 0)
    # a composed head must be a true head; a cycle would leave prev >= 0
    ok = p1_ok & p2_ok & ~(prev_u[jnp.clip(head, 0, n2 - 1)] >= 0).any()
    return head, dist, ok


def _rank_rulers(next_u, prev_u):
    """(head, dist, ok) via ruler ranking; scheme selected from
    _PACK_SCHEMES by id-space size so the single-gather packed phase 1
    survives past 2^24 oriented ids (the round-4 cliff: BENCH_SCALE=2
    has n2 = 2^25 exactly and fell to the 2-gather unpacked path)."""
    n2 = next_u.shape[0]
    for bits, stride, d_bits, sat_k in _PACK_SCHEMES:
        if n2 <= (1 << bits):
            return _rank_rulers_impl(next_u, prev_u, stride, d_bits,
                                     sat_k, packed=True)
    return _rank_rulers_impl(next_u, prev_u, RULER_STRIDE, _D_BITS,
                             _SAT_K, packed=False)


_P1_ROUNDS = 12  # covers ruler gaps <= 4096; P(gap > 4096) ~ n2*(15/16)^4096


def _rank_rulers_unrolled(next_u, prev_u):
    """_rank_rulers with both doubling phases UNROLLED to fixed round
    counts (no lax.while_loop): loop-carried q[q] gathers inside a
    while_loop cannot be software-pipelined, and each round's convergence reduction adds a
    dependency. Fixed rounds let XLA software-pipeline the gather chain.

    Phase 1 runs _P1_ROUNDS rounds; insufficiency (a ruler gap > 2^rounds,
    probability ~ n2 * (15/16)^4096 ~ 0, or a ruler-free cycle) is caught
    by the same ok checks and falls back to the dense path — semantics
    identical to _rank_rulers."""
    n2 = next_u.shape[0]
    ids = jnp.arange(n2, dtype=I32)
    mask = I32(RULER_STRIDE - 1)

    p = jnp.where(prev_u >= 0, prev_u, ids)
    d = jnp.where(prev_u >= 0, 1, 0).astype(I32)
    for _ in range(_P1_ROUNDS):
        pg = p[p]
        dg = d[p]
        adv = (p & mask) != 0
        d = d + jnp.where(adv, dg, 0)
        p = jnp.where(adv, pg, p)
    p1_ok = ~(((p & mask) != 0) & (p[p] != p)).any()

    rp = p[::RULER_STRIDE]
    rd = d[::RULER_STRIDE]
    r_rounds = max(1, (rp.shape[0] - 1).bit_length() + 1)
    for _ in range(r_rounds):
        j = jnp.clip(rp // RULER_STRIDE, 0, rp.shape[0] - 1)
        pg = rp[j]
        dg = rd[j]
        adv = (rp & mask) == 0
        rd = rd + jnp.where(adv, dg, 0)
        rp = jnp.where(adv, pg, rp)
    j = jnp.clip(rp // RULER_STRIDE, 0, rp.shape[0] - 1)
    p2_ok = ~(((rp & mask) == 0) & (rp[j] != rp)).any()

    a_rul = (p & mask) == 0
    aj = jnp.clip(p // RULER_STRIDE, 0, rp.shape[0] - 1)
    head = jnp.where(a_rul, rp[aj], p)
    dist = d + jnp.where(a_rul, rd[aj], 0)
    ok = p1_ok & p2_ok & ~(prev_u[jnp.clip(head, 0, n2 - 1)] >= 0).any()
    return head, dist, ok


@jax.jit
def _final_chain_state_links(succ, okv_hi, okv_lo, counts, alive,
                             valid_node, next_u, prev_u):
    """final_chain_state body with the link arrays precomputed (handed
    over from the fixpoint loop's last no-change pass — saves the
    degree gathers, the largest fixed cost of the final phase)."""
    n2 = succ.shape[0]
    ids = jnp.arange(n2, dtype=I32)
    alive_o = jnp.repeat(alive & valid_node, 2)
    head_r, dist_r, ok = _rank_rulers(next_u, prev_u)

    def fast(_):
        head = jnp.where(alive_o, head_r, -1)
        dist = jnp.where(alive_o, dist_r, 0)
        is_head = alive_o & (head == ids)
        is_tail = alive_o & (next_u == -1)
        # twin values are needed only AT the heads, and #chains << n2
        # after simplification: compact the tail ids (one chain each) and
        # scatter okv(rc(tail)) to each tail's head — tiny gathers and
        # one tiny scatter replace a full-size scatter + two full-size
        # okv gathers. Tail overflow (> _TAIL_M chains) falls back to the
        # full-size computation inside this same branch.
        _, tails, _n_t, tovf = compact(is_tail, (), _TAIL_M)
        treal = jnp.arange(_TAIL_M, dtype=I32) < jnp.minimum(_n_t, _TAIL_M)
        tc = jnp.clip(jnp.where(treal, tails, 0), 0, n2 - 1)
        t_head = jnp.where(treal, head[tc], n2)
        tw_hi = okv_hi[tc ^ 1]
        tw_lo = okv_lo[tc ^ 1]

        def sparse_twin(_):
            th = jnp.full(n2, 0xFFFFFFFF, dtype=U32).at[t_head].set(
                tw_hi, mode="drop")
            tl = jnp.full(n2, 0xFFFFFFFF, dtype=U32).at[t_head].set(
                tw_lo, mode="drop")
            return th, tl

        def full_twin(_):
            seg = jnp.where(alive_o, head, n2)
            tail_of = jnp.full(n2, -1, dtype=I32).at[
                jnp.where(is_tail, seg, n2)].set(ids, mode="drop")
            tail_c = jnp.clip(tail_of, 0, None)
            th = jnp.where(tail_of >= 0, okv_hi[tail_c ^ 1],
                           U32(0xFFFFFFFF))
            tl = jnp.where(tail_of >= 0, okv_lo[tail_c ^ 1],
                           U32(0xFFFFFFFF))
            return th, tl

        twin_hi, twin_lo = jax.lax.cond(tovf, full_twin, sparse_twin, None)
        primary = is_head & u64.le(okv_hi, okv_lo, twin_hi, twin_lo)
        return head, dist, primary

    def dense(_):
        st = _chain_state(succ, okv_hi, okv_lo, counts, alive, valid_node)
        primary = st["is_head"] & u64.le(
            okv_hi[ids], okv_lo[ids], st["twin_hi"], st["twin_lo"])
        return st["head"], st["dist"], primary

    head, dist, primary = jax.lax.cond(ok, fast, dense, None)
    return dict(head=head, dist=dist, primary=primary, alive_o=alive_o)


@jax.jit
def _links_of(succ, alive, valid_node):
    alive_o = jnp.repeat(alive & valid_node, 2)
    outdeg, usucc = _degrees(succ, alive_o)
    return _links(outdeg, usucc)


def final_chain_state(succ, okv_hi, okv_lo, counts, alive, valid_node,
                      links=None):
    """Chain state + primary mask for contig emission (SEMANTICS §6).

    Fast path: ruler ranking + only the aggregates emission needs
    (tail_of for the twin/primary pin — no length/coverage segment
    reductions). Dense fallback (exact cycle breaking) via lax.cond when
    any cycle survives simplification.

    links: optional (next_u, prev_u) computed on exactly this alive mask
    (the fixpoint loop's final no-change pass) — skips the degree
    gathers."""
    if links is None:
        links = _links_of(succ, alive, valid_node)
    return _final_chain_state_links(succ, okv_hi, okv_lo, counts, alive,
                                    valid_node, links[0], links[1])


def simplify_device(succ, okv_hi, okv_lo, counts, alive, valid_node, params,
                    with_links: bool = False):
    """Fixpoint loop (host-driven): tips then bubbles per round (SEMANTICS §5).

    Degrees are carried across passes and updated incrementally from
    each pass's kill set (run_pass_inc) instead of recomputed from
    scratch every pass.

    with_links: also return the final round's (next_u, prev_u) — valid
    for the returned alive mask, or None when the loop hit max_rounds
    still changing or ended on a dense fallback."""
    tip_len = jnp.int32(params.tip_len_eff)
    bubble_len = jnp.int32(params.bubble_len_eff)
    links = None
    deg = None
    lc = None
    for _ in range(params.max_rounds):
        alive, c1, _l1, deg, lc = run_pass_inc(
            "tips", succ, okv_hi, okv_lo, counts, alive, valid_node,
            tip_len, params.tip_len_eff, deg, lc)
        alive, c2, l2, deg, lc = run_pass_inc(
            "bubbles", succ, okv_hi, okv_lo, counts, alive, valid_node,
            bubble_len, params.bubble_len_eff, deg, lc)
        if not (bool(c1) or bool(c2)):
            links = l2  # computed on the final alive; no kills after
            break
    return (alive, links) if with_links else alive
