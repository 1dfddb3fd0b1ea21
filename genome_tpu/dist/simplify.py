"""T3: sharded graph simplification — distributed pointer doubling
(SURVEY.md §5.3/§5.7 follow-up; completes the PartitionedDNAMap analog so
no phase ever needs the whole graph on one chip).

The single-device passes (graph/simplify.py) index global arrays freely:
`q[q]` doubling, per-head segment reductions, value gathers at tails.
Here the oriented-id space is sharded over the mesh (global id
v = shard * 2*local_capacity + local, matching dist/build.py), and every
cross-shard access becomes an explicit exchange built on route_buckets:

- remote_gather: requests routed to the owner shard (all_to_all #1),
  answered locally, responses routed back (all_to_all #2) into the
  requesting slots — the PartitionedDNAMap probe pattern.
- per-head aggregates: one routing of (head, payload...) records to the
  head's owner, then plain local segment reductions.
- bubble (p, s) grouping: records routed by hash(p, s) so each group
  lands whole on one shard, sorted locally, losers routed to their
  owners as kill messages.

Semantics are identical to the local passes (every pin is k-mer-value
based); CI checks contig parity against the single-device pipeline on a
logical multi-shard CPU mesh. Capacity-planned buffers with overflow
flags, like the rest of T3: on overflow the host retries bigger.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from genome_tpu.dist.count import route_buckets
from genome_tpu.dist.ledger import LEDGER, record_a2a, record_psum
from genome_tpu.dist.partition import _fmix32_jnp
from genome_tpu.kernels import u64
from genome_tpu.kernels.compact import compact
from genome_tpu.kernels.extract import SENTINEL

I32 = jnp.int32
U32 = jnp.uint32

# per-shard compaction buffer for a pass's killed canonicals (the
# incremental degree/link update, update_deg): kills beyond this fall
# back to a fresh degree recompute — mirrors graph/simplify.py _KILL_M
_KILL_MD = 4096


def _bub_mc(cl2: int, slack: float) -> int:
    """Bubble-candidate compaction buffer per shard: candidates are
    chain heads passing the bubble filter (<< cl2); scales with the
    retry ladder's slack so an overflow retry doubles it along with the
    routing capacities. Tests monkeypatch this to force the ladder."""
    return min(cl2, max(4096, int(65536 * slack / 1.35)))


def _cap_for(m: int, num_shards: int, slack: float = 1.35) -> int:
    """Per-owner bucket capacity for m hash-balanced requests."""
    return max(64, int(slack * m / num_shards) + 64)


def _back_multi(resps: tuple, axis, num_shards, cap):
    """Return response buffers along the same bucket layout — ONE
    all_to_all for all payloads (stacked column-wise, same bytes, one
    collective launch instead of len(resps); see route_buckets)."""
    bufs = [r.reshape(num_shards, cap) for r in resps]
    stacked = bufs[0] if len(bufs) == 1 else jnp.concatenate(bufs, axis=1)
    out = jax.lax.all_to_all(stacked, axis, split_axis=0, concat_axis=0,
                             tiled=True)
    record_a2a(1, num_shards, num_shards * len(resps) * cap)
    return tuple(out[:, j * cap : (j + 1) * cap].reshape(-1)
                 for j in range(len(resps)))


def make_ops(axis: str, num_shards: int, cl2: int):
    """Sharded primitives for one shard_map body. cl2 = 2*local_capacity."""
    S = num_shards

    def remote_gather(vals, idx, valid, cap, defaults):
        """vals[j][idx[i]] over the sharded global id space.

        vals: tuple of local [cl2] arrays (shard's slice of a global
        array). idx: [M] global ids; valid: [M] mask. Returns (outs, ovf)
        with outs[j][i] = global_vals[j][idx[i]] where valid else
        defaults[j] (scalars or per-slot arrays). Owner-local requests
        are answered without touching the network — only genuinely
        remote indices ride the all_to_all, which keeps bucket loads at
        ~M/S even when most pointers are self/local (converged doubling
        chains)."""
        me = jax.lax.axis_index(axis).astype(I32)
        m = idx.shape[0]
        own = jnp.where(valid, idx // cl2, S)
        is_mine = valid & (own == me)
        loc_self = jnp.clip(idx - me * cl2, 0, cl2 - 1)
        remote = valid & (own != me)

        # Dedup remote requests: converged doubling pointers concentrate
        # on chain heads, so raw per-owner request counts are unbounded
        # (a genome is one giant chain). Sort (idx, slot), route only run
        # heads, broadcast responses down the runs, undo the permutation.
        big = U32(0xFFFFFFFF)
        key = jnp.where(remote, idx.astype(U32), big)
        slot = jnp.arange(m, dtype=I32)
        skey, sslot = jax.lax.sort((key, slot), num_keys=1)
        first = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                 skey[1:] != skey[:-1]])
        uniq = first & (skey != big)
        own_u = jnp.where(uniq, (skey // U32(cl2)).astype(I32), S)
        (ridx,), send_pos, ovf = route_buckets((skey,), own_u, S, cap, axis)
        present = ridx != SENTINEL
        loc = jnp.clip(ridx.astype(I32) - me * cl2, 0, cl2 - 1)
        pos = jnp.arange(m, dtype=I32)
        runstart = jax.lax.cummax(jnp.where(first, pos, 0))
        inv = jnp.zeros((m,), I32).at[sslot].set(pos, unique_indices=True)
        # all responses ride ONE return all_to_all (stacked columns)
        resps = tuple(jnp.where(present, v[loc].astype(U32), 0)
                      for v in vals)
        gots = _back_multi(resps, axis, S, cap)
        sp = jnp.clip(send_pos, 0, None)
        ok_head = uniq & (send_pos >= 0)
        ok = ok_head[runstart]
        okm = ok[inv]
        outs = []
        for v, d, got in zip(vals, defaults, gots):
            at_head = jnp.where(ok_head, got[sp], U32(0))
            # broadcast each run head's response to the whole run, then
            # map back through the sort permutation to original slots
            bcast = at_head[runstart]
            o = bcast[inv].astype(v.dtype)
            o = jnp.where(is_mine, v[loc_self], o)
            outs.append(jnp.where(valid & (is_mine | (remote & okm)),
                                  o, d))
        return tuple(outs), ovf

    def seg_route(vals, ops, seg, valid, cap):
        """Route (seg, vals...) records to seg's owner, pre-combined.

        All of a shard's records for one segment are reduced locally
        first (`ops[j]` in {"max", "sum", "min"} per payload) so at most
        one record per (sender, segment) rides the exchange — without
        this, every node of a chain routes to its head's owner and a
        single giant chain overflows any per-owner capacity.

        Returns (local_seg [S*cap] int32 with cl2 for empties, routed
        vals tuple, present mask, ovf).
        """
        me = jax.lax.axis_index(axis).astype(I32)
        m = seg.shape[0]
        big = U32(0xFFFFFFFF)
        key = jnp.where(valid, seg.astype(U32), big)
        sorted_all = jax.lax.sort(
            (key,) + tuple(v.astype(U32) for v in vals), num_keys=1)
        skey, svals = sorted_all[0], sorted_all[1:]
        first = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                 skey[1:] != skey[:-1]])
        rid = jnp.cumsum(first.astype(I32)) - 1
        combined = []
        j = 0
        while j < len(svals):
            v, op = svals[j], ops[j]
            if op == "sum":
                c = jax.ops.segment_sum(v, rid, num_segments=m)
            elif op == "min":
                c = jax.ops.segment_min(v, rid, num_segments=m)
            elif op == "min2":  # lexicographic (hi, lo) pair min
                chi = jax.ops.segment_min(v, rid, num_segments=m)
                lo_cand = jnp.where(v == chi[rid], svals[j + 1], big)
                clo = jax.ops.segment_min(lo_cand, rid, num_segments=m)
                combined.append(chi)
                combined.append(clo)
                j += 2
                continue
            else:
                c = jax.ops.segment_max(v, rid, num_segments=m)
            combined.append(c)
            j += 1
        uniq = first & (skey != big)
        own_u = jnp.where(uniq, (skey // U32(cl2)).astype(I32), S)
        routed, _, ovf = route_buckets(
            (skey,) + tuple(c[rid] for c in combined),
            own_u, S, cap, axis)
        rseg = routed[0]
        present = rseg != SENTINEL
        lseg = jnp.where(present, jnp.clip(rseg.astype(I32) - me * cl2,
                                           0, cl2 - 1), cl2)
        return lseg, routed[1:], present, ovf

    return remote_gather, seg_route


def _paired(v):
    """[cl2] array -> ([cl], [cl]) even/odd slots, for rc-pair gathers."""
    return v[0::2], v[1::2]


def _degrees_links(succ, alive_o, remote_gather, gcap4, gcap1):
    """Sharded (outdeg, usucc, next_u, prev_u) from scratch: the alive
    gather over 4*cl2 edge targets plus the deg-at-twin gather — the two
    exchanges the carried-degree passes avoid paying per pass."""
    cl2 = succ.shape[0]
    ids_l = jnp.arange(cl2, dtype=I32)
    tgt = succ.reshape(-1)
    (tgt_alive_u,), o1 = remote_gather(
        (alive_o.astype(U32),), jnp.clip(tgt, 0, None),
        tgt >= 0, gcap4, (U32(0),))
    ok = ((tgt >= 0) & (tgt_alive_u != 0)).reshape(-1, 4) & alive_o[:, None]
    outdeg = ok.sum(axis=1, dtype=I32)
    usucc = jnp.where(ok, succ, -1).max(axis=1)
    has = outdeg == 1
    w = jnp.where(has, usucc, 0)
    (deg_w1,), o2 = remote_gather((outdeg,), w ^ 1, has, gcap1, (I32(0),))
    next_u = jnp.where(has & (deg_w1 == 1), w, -1)
    nx = next_u[ids_l ^ 1]
    prev_u = jnp.where(nx >= 0, nx ^ 1, -1)
    return outdeg, usucc, next_u, prev_u, o1 | o2


def make_sharded_simplify(mesh: Mesh, axis: str, local_capacity: int,
                          slack: float = 1.35,
                          tip_max_len: int | None = None,
                          bubble_max_len: int | None = None):
    """Builds jitted sharded tip-clip and bubble-pop passes.

    All arrays are global-shaped, sharded over `axis`:
    succ [S*cl2, 4] (global oriented ids), okv_hi/lo [S*cl2],
    counts [S*local_capacity], alive [S*local_capacity] bool,
    n_loc [S] int32. Each pass returns (alive, changed [S], overflow [S]).

    slack: routing-capacity multiplier; the host retries with a bigger
    one on overflow instead of falling back to a replicated pass.
    tip_max_len / bubble_max_len: static copies of the pass thresholds —
    like the local passes, doubling truncates to ~log2(max_len) rounds
    and the cycle machinery (the q and min-doubling loops, one and four
    remote exchanges per round) is skipped entirely: unbroken cycle
    members never converge to a head fixpoint, and the wraparound case
    is excluded by the candidates' ~cyc_head guard, which only needs the
    single prev[p] exchange.
    """
    num_shards = S = mesh.shape[axis]
    cl = local_capacity
    cl2 = 2 * cl
    n2g = S * cl2
    rounds = max(1, (n2g - 1).bit_length() + 1)
    gcap1 = _cap_for(cl2, S, slack)
    gcap4 = _cap_for(4 * cl2, S, slack)

    def chain_state(succ, okv_hi, okv_lo, counts, alive, valid_node,
                    remote_gather, seg_route, me, max_len=None, deg=None):
        ids_g = me * cl2 + jnp.arange(cl2, dtype=I32)  # my global ids
        alive_o = jnp.repeat(alive & valid_node, 2)
        ovf = jnp.zeros((), jnp.bool_)
        rnds = rounds if max_len is None else min(
            rounds, max(2, int(max_len).bit_length() + 1))

        if deg is None:
            # degrees + links from scratch (two exchanges); carried-deg
            # passes hand them in instead (run_pass_inc analog)
            outdeg, usucc, next_u, prev_u, o12 = _degrees_links(
                succ, alive_o, remote_gather, gcap4, gcap1)
            ovf |= o12
        else:
            outdeg, usucc, next_u, prev_u = deg

        # head + distance doubling with UNBROKEN prev first (remote q[q];
        # self-pointers are fixpoints — skipping them keeps request loads
        # at ~M/S). The converged pointer doubles as the cycle detector,
        # so there is no separate q-loop.
        p0 = jnp.where(prev_u >= 0, prev_u, ids_g)

        def hd(_, carry):
            pp, dd, of = carry
            (p2, dp), o = remote_gather((pp, dd), pp, pp != ids_g, gcap1,
                                        (pp, I32(0)))
            return p2, dd + dp, of | o

        d0 = jnp.where(prev_u >= 0, 1, 0).astype(I32)
        with LEDGER.loop(rnds):
            p, d, ovf = jax.lax.fori_loop(0, rnds, hd, (p0, d0, ovf))
        # NOTE: p == self does NOT imply prev_u[self] < 0 — a self-loop
        # node (homopolymer run >= k+1) has prev_u[v] = v. The gather
        # must therefore include self-pointers (answered locally by the
        # is_mine path, no extra traffic) or 1-cycles escape the cycle
        # detector and emission diverges from the single-device path.
        (prev_p,), o4 = remote_gather((prev_u,), p, alive_o, gcap1,
                                      (I32(-1),))
        ovf |= o4
        in_cycle = alive_o & (prev_p >= 0)

        if max_len is None:
            # cycle head: min oriented value over the cycle
            # (min-doubling); gather at self returns own carry -> no-op,
            # so skip with defaults. Then redo head/dist with cycles
            # broken at their reps. Runs only in the full/final state.
            def mndbl(_, carry):
                mh, ml, mi, qq, of = carry
                (ch, cm, ci, q2), o = remote_gather(
                    (mh, ml, mi, qq), qq, qq != ids_g, gcap1,
                    (mh, ml, mi, qq))
                take = u64.lt(ch, cm, mh, ml)
                return (jnp.where(take, ch, mh), jnp.where(take, cm, ml),
                        jnp.where(take, ci, mi), q2, of | o)
            with LEDGER.loop(rounds):
                mh, ml, mn_i, _, ovf = jax.lax.fori_loop(
                    0, rounds, mndbl, (okv_hi, okv_lo, ids_g, p0, ovf))
            rep_break = in_cycle & (mn_i == ids_g)
            prev2 = jnp.where(rep_break, -1, prev_u)
            p2_ = jnp.where(prev2 >= 0, prev2, ids_g)
            d2_ = jnp.where(prev2 >= 0, 1, 0).astype(I32)
            with LEDGER.loop(rounds):
                p, d, ovf = jax.lax.fori_loop(0, rounds, hd,
                                              (p2_, d2_, ovf))
        head = jnp.where(alive_o, p, -1)
        dist = jnp.where(alive_o, d, 0)
        is_head = alive_o & (head == ids_g)

        # per-head aggregates: one routing of all payloads to head owners
        node_counts = jnp.repeat(counts, 2).astype(U32)
        okv_rc_hi = okv_hi[jnp.arange(cl2, dtype=I32) ^ 1]
        okv_rc_lo = okv_lo[jnp.arange(cl2, dtype=I32) ^ 1]
        is_tail = alive_o & (next_u == -1)
        payloads = (
            (dist + 1).astype(U32),
            node_counts & U32(0xFFFF),
            node_counts >> U32(16),
            in_cycle.astype(U32),
            # tail id encoded +1 so 0 = absent under unsigned max
            jnp.where(is_tail, ids_g + 1, 0).astype(U32),
            jnp.where(in_cycle, okv_rc_hi, U32(0xFFFFFFFF)),
            jnp.where(in_cycle, okv_rc_lo, U32(0xFFFFFFFF)),
        )
        ops5 = ("max", "sum", "sum", "max", "max", "min2", "min2lo")
        lseg, routed, present, o5 = seg_route(
            payloads, ops5, jnp.clip(head, 0, None),
            alive_o & (head >= 0), gcap1)
        ovf |= o5
        r_len, r_clo, r_chi, r_cyc, r_tail, r_oh, r_ol = routed
        length_l = jax.ops.segment_max(
            jnp.where(present, r_len.astype(I32), 0), lseg,
            num_segments=cl2)
        cov_lo = jax.ops.segment_sum(
            jnp.where(present, r_clo, U32(0)), lseg, num_segments=cl2)
        cov_hi = jax.ops.segment_sum(
            jnp.where(present, r_chi, U32(0)), lseg, num_segments=cl2)
        cov_hi = cov_hi + (cov_lo >> U32(16))
        cov_lo = cov_lo & U32(0xFFFF)
        cyc_head = jax.ops.segment_max(
            jnp.where(present, r_cyc.astype(I32), 0), lseg,
            num_segments=cl2) > 0
        tail_of = jax.ops.segment_max(
            jnp.where(present, r_tail, U32(0)), lseg,
            num_segments=cl2).astype(I32) - 1
        cyc_hi = jax.ops.segment_min(
            jnp.where(present & (r_oh != U32(0xFFFFFFFF)), r_oh,
                      U32(0xFFFFFFFF)),
            lseg, num_segments=cl2)
        lo_cand = jnp.where(
            present & (r_oh == cyc_hi[lseg]), r_ol, U32(0xFFFFFFFF))
        cyc_lo = jax.ops.segment_min(lo_cand, lseg, num_segments=cl2)

        # twin head okv: okv(rc(tail)) for paths, cycle min for cycles.
        # The paired arrays live in the CANONICAL id space (global id =
        # shard*cl + local, half the oriented space), so the gather must
        # come from a canonical-space ops instance — the oriented-space
        # remote_gather would compute owners as idx // cl2 and route every
        # shard-(>0) request to the wrong owner.
        rg_canon, _ = make_ops(axis, S, cl)
        ph0, ph1 = _paired(okv_hi)
        pl0, pl1 = _paired(okv_lo)
        (t_h0, t_h1, t_l0, t_l1), o6 = rg_canon(
            (ph0, ph1, pl0, pl1), jnp.clip(tail_of, 0, None) // 2,
            tail_of >= 0, gcap1,
            (U32(0xFFFFFFFF),) * 4)
        ovf |= o6
        todd = (tail_of & 1) == 1  # rc(tail) = tail ^ 1
        twin_hi = jnp.where(tail_of >= 0,
                            jnp.where(todd, t_h0, t_h1), U32(0xFFFFFFFF))
        twin_lo = jnp.where(tail_of >= 0,
                            jnp.where(todd, t_l0, t_l1), U32(0xFFFFFFFF))
        use_cyc = is_head & cyc_head
        twin_hi = jnp.where(use_cyc, cyc_hi, twin_hi)
        twin_lo = jnp.where(use_cyc, cyc_lo, twin_lo)

        return dict(outdeg=outdeg, usucc=usucc, next_u=next_u, head=head,
                    dist=dist, is_head=is_head, length=length_l,
                    cyc_head=cyc_head, tail_of=tail_of, cov_hi=cov_hi,
                    cov_lo=cov_lo, twin_hi=twin_hi, twin_lo=twin_lo,
                    alive_o=alive_o, ids_g=ids_g, ovf=ovf)

    def kill_heads(alive, st, doomed_heads_local, remote_gather):
        """doomed_heads_local: [cl2] bool at the head's owner shard."""
        head = st["head"]
        (dm,), o = remote_gather(
            (doomed_heads_local.astype(U32),), jnp.clip(head, 0, None),
            st["alive_o"] & (head >= 0), gcap1, (U32(0),))
        node_doomed = st["alive_o"] & (dm != 0)
        canon_doomed = node_doomed.reshape(-1, 2).any(axis=1)
        return alive & ~canon_doomed, o

    kill_md = _KILL_MD
    dk_cap = _cap_for(8 * kill_md, S, slack)
    da_cap = _cap_for(4 * S * dk_cap, S, slack)
    bub_mc = _bub_mc(cl2, slack)

    def update_deg(succ, alive2, valid_node, killed_c, outdeg, usucc,
                   next_u, me, remote_gather, seg_route):
        """Post-kill (outdeg, usucc, next_u, prev_u) update — the
        distributed analog of graph/simplify.py::_update_degrees. Killed
        canonicals are compacted to _KILL_MD slots per shard; their
        edges' twins get routed decrements (validity — target still
        alive — judged at the OWNER, so no extra alive exchange), and
        usucc/links are recomputed only over the affected union
        (received targets + dead rows + their rc-successors). kovf=True
        means a buffer overflowed and the caller must recompute degrees
        from scratch before the next pass (results then unusable)."""
        ids_l = jnp.arange(cl2, dtype=I32)
        ids_c = jnp.arange(cl, dtype=I32)
        alive2_o = jnp.repeat(alive2 & valid_node, 2)

        (kc,), _, nk, kovf = compact(killed_c, (ids_c,), kill_md)
        real = jnp.arange(kill_md, dtype=I32) < jnp.minimum(nk, kill_md)
        kcc = jnp.clip(jnp.where(real, kc, 0), 0, cl - 1)
        rows = jnp.concatenate([succ[2 * kcc], succ[2 * kcc + 1]],
                               axis=1)                       # [Mk, 8]
        wv = ((rows >= 0) & real[:, None]).reshape(-1)
        w = jnp.clip(rows, 0, None).reshape(-1)
        # decrements routed to owner of w^1 (same owner as w): one
        # pre-combined (sum) record per (sender, target)
        lseg, routed, present, o1 = seg_route(
            (jnp.ones((kill_md * 8,), U32),), ("sum",),
            w ^ 1, wv, dk_cap)
        (rcnt,) = routed
        lseg_c = jnp.clip(lseg, 0, cl2 - 1)
        apply = present & alive2_o[lseg_c]
        od2 = outdeg.at[jnp.where(apply, lseg, cl2)].add(
            -jnp.where(apply, rcnt.astype(I32), 0), mode="drop")
        dead = jnp.where(real[:, None],
                         2 * kcc[:, None] + jnp.arange(2, dtype=I32)[None],
                         cl2).reshape(-1)
        od2 = od2.at[dead].set(0, mode="drop")

        # usucc recompute at the received rows (their successor-alive
        # sets changed): gather post-kill alive of their <=4 successors
        su = succ[lseg_c]                                    # [S*kcap, 4]
        sv = (su >= 0) & apply[:, None]
        (sa,), o2 = remote_gather(
            (alive2_o.astype(U32),), jnp.clip(su, 0, None).reshape(-1),
            sv.reshape(-1), da_cap, (U32(0),))
        okm = sv & (sa.reshape(-1, 4) != 0)
        new_us = jnp.where(okm, su, -1).max(axis=1)
        us2 = usucc.at[jnp.where(apply, lseg, cl2)].set(
            jnp.where(apply, new_us, -1), mode="drop")
        us2 = us2.at[dead].set(-1, mode="drop")

        # links over U = affected ∪ dead ∪ rc-successors of both (the
        # exact _update_degrees affected-set rule): next[v] flips only
        # when v's own (outdeg, usucc) changed or outdeg[usucc[v]^1] did
        aff = jnp.concatenate([jnp.where(apply, lseg, cl2), dead])
        affc = jnp.clip(aff, 0, cl2 - 1)
        sa2 = succ[affc]                                     # [Na, 4]
        av = (sa2 >= 0) & (aff < cl2)[:, None]
        cand = jnp.where(av, sa2 ^ 1, 0).reshape(-1)
        ccap = _cap_for(cand.shape[0], S, slack)
        (rc_ids,), _, o3 = route_buckets(
            (cand.astype(U32),),
            jnp.where(av.reshape(-1), cand // cl2, S), S, ccap, axis)
        cpresent = rc_ids != SENTINEL
        cloc = jnp.clip(rc_ids.astype(I32) - me * cl2, 0, cl2 - 1)
        U = jnp.concatenate([aff, jnp.where(cpresent, cloc, cl2)])
        Uc = jnp.clip(U, 0, cl2 - 1)
        uvalid = U < cl2
        wl = us2[Uc]
        ucap = _cap_for(U.shape[0], S, slack)
        (degw,), o4 = remote_gather(
            (od2,), jnp.clip(wl, 0, None) ^ 1, uvalid & (wl >= 0), ucap,
            (I32(0),))
        okl = uvalid & (od2[Uc] == 1) & (wl >= 0) & (degw == 1)
        nval = jnp.where(okl, wl, -1)
        nx2 = next_u.at[jnp.where(uvalid, U, cl2)].set(
            jnp.where(uvalid, nval, -1), mode="drop")
        nxs = nx2[ids_l ^ 1]
        pv2 = jnp.where(nxs >= 0, nxs ^ 1, -1)
        kovf = kovf | o1 | o2 | o3 | o4
        return od2, us2, nx2, pv2, kovf

    def degrees_fn(succ, alive, n_loc):
        """Fresh (outdeg, usucc, next_u, prev_u) for the carried-degree
        pass chain (pass 1, and recovery after an update overflow)."""
        LEDGER.program("dist_degrees")
        succ = succ.reshape(cl2, 4)
        alive = alive.reshape(-1)
        valid_node = jnp.arange(cl, dtype=I32) < n_loc.reshape(())
        remote_gather, _ = make_ops(axis, S, cl2)
        alive_o = jnp.repeat(alive & valid_node, 2)
        od, us, nx, pv, o = _degrees_links(succ, alive_o, remote_gather,
                                           gcap4, gcap1)
        return od, us, nx, pv, o[None]

    def tips_fn(succ, okv_hi, okv_lo, counts, alive, n_loc, tip_len,
                outdeg, usucc, next_u, prev_u):
        LEDGER.program("dist_tips")
        succ = succ.reshape(cl2, 4)
        okv_hi, okv_lo = okv_hi.reshape(-1), okv_lo.reshape(-1)
        counts, alive = counts.reshape(-1), alive.reshape(-1)
        deg = (outdeg.reshape(-1), usucc.reshape(-1), next_u.reshape(-1),
               prev_u.reshape(-1))
        me = jax.lax.axis_index(axis).astype(I32)
        valid_node = jnp.arange(cl, dtype=I32) < n_loc.reshape(())
        remote_gather, seg_route = make_ops(axis, S, cl2)
        st = chain_state(succ, okv_hi, okv_lo, counts, alive, valid_node,
                         remote_gather, seg_route, me, max_len=tip_max_len,
                         deg=deg)
        ids = jnp.arange(cl2, dtype=I32)
        cand = st["is_head"] & ~st["cyc_head"] & (st["length"] <= tip_len[0])
        start_open = st["outdeg"][ids ^ 1] == 0
        tails = st["tail_of"]
        (deg_tail,), o7 = remote_gather((st["outdeg"],),
                                        jnp.clip(tails, 0, None),
                                        tails >= 0, gcap1, (I32(1),))
        end_open = (tails >= 0) & (deg_tail == 0)
        doomed = cand & (start_open != end_open)  # heads are local slots
        alive2, o8 = kill_heads(alive, st, doomed, remote_gather)
        changed = doomed.any()
        ovf = st["ovf"] | o7 | o8
        od2, us2, nx2, pv2, kovf = update_deg(
            succ, alive2, valid_node, alive & ~alive2, deg[0], deg[1],
            deg[2], me, remote_gather, seg_route)
        return (alive2, changed[None], ovf[None], od2, us2, nx2, pv2,
                kovf[None])

    def bubbles_fn(succ, okv_hi, okv_lo, counts, alive, n_loc, bubble_len,
                   outdeg, usucc, next_u, prev_u):
        LEDGER.program("dist_bubbles")
        succ = succ.reshape(cl2, 4)
        okv_hi, okv_lo = okv_hi.reshape(-1), okv_lo.reshape(-1)
        counts, alive = counts.reshape(-1), alive.reshape(-1)
        deg = (outdeg.reshape(-1), usucc.reshape(-1), next_u.reshape(-1),
               prev_u.reshape(-1))
        me = jax.lax.axis_index(axis).astype(I32)
        valid_node = jnp.arange(cl, dtype=I32) < n_loc.reshape(())
        remote_gather, seg_route = make_ops(axis, S, cl2)
        st = chain_state(succ, okv_hi, okv_lo, counts, alive, valid_node,
                         remote_gather, seg_route, me,
                         max_len=bubble_max_len, deg=deg)
        ids = jnp.arange(cl2, dtype=I32)
        ovf = st["ovf"]
        outdeg, usucc = st["outdeg"], st["usucc"]
        tails = st["tail_of"]
        indeg_head = outdeg[ids ^ 1]
        (deg_tail, succ_tail), o1 = remote_gather(
            (outdeg, usucc), jnp.clip(tails, 0, None), tails >= 0, gcap1,
            (I32(0), I32(-1)))
        ovf |= o1
        cand = (st["is_head"] & ~st["cyc_head"]
                & (st["length"] <= bubble_len[0])
                & (indeg_head == 1) & (tails >= 0) & (deg_tail == 1))
        p = jnp.where(cand, usucc[ids ^ 1] ^ 1, 0)
        s = jnp.where(cand, succ_tail, 0)
        s = jnp.where(cand & (s >= 0), s, 0)

        # okv at p, p^1, s, s^1 (paired gathers: one routing per endpoint;
        # canonical-space ops — see the twin gather note in chain_state)
        rg_canon, _ = make_ops(axis, S, cl)
        ph0, ph1 = _paired(okv_hi)
        pl0, pl1 = _paired(okv_lo)
        (p_h0, p_h1, p_l0, p_l1), o2 = rg_canon(
            (ph0, ph1, pl0, pl1), p // 2, cand, gcap1, (U32(0),) * 4)
        (s_h0, s_h1, s_l0, s_l1), o3 = rg_canon(
            (ph0, ph1, pl0, pl1), s // 2, cand, gcap1, (U32(0),) * 4)
        ovf |= o2 | o3
        podd = (p & 1) == 1
        sodd = (s & 1) == 1
        ph = jnp.where(podd, p_h1, p_h0)
        pl = jnp.where(podd, p_l1, p_l0)
        rph = jnp.where(podd, p_h0, p_h1)  # okv(p ^ 1)
        rpl = jnp.where(podd, p_l0, p_l1)
        sh_ = jnp.where(sodd, s_h1, s_h0)
        sl_ = jnp.where(sodd, s_l1, s_l0)
        rsh = jnp.where(sodd, s_h0, s_h1)  # okv(s ^ 1)
        rsl = jnp.where(sodd, s_l0, s_l1)
        proc = u64.lt(ph, pl, rsh, rsl) | (
            u64.eq(ph, pl, rsh, rsl) & u64.le(sh_, sl_, rph, rpl))
        selfrc = p == (s ^ 1)
        primary = u64.le(okv_hi, okv_lo, st["twin_hi"], st["twin_lo"])
        keep = cand & proc & (~selfrc | primary)

        # group (p, s) on the shard owning hash(p, s). Candidates are
        # HEADS of short chains (<= #bubble sites << cl2), so compact
        # them first: the 7-payload routing and the receiver's 7-array
        # sort run at candidate scale, not id-space scale. Overflow
        # (> bub_mc candidates) rides the normal slack-retry ladder,
        # which doubles bub_mc with the routing capacities.
        (kp, ks, kch, kcl, koh, kol, kid), _, nkeep, kovf_c = compact(
            keep, (p.astype(U32), s.astype(U32), ~st["cov_hi"],
                   ~st["cov_lo"], okv_hi, okv_lo,
                   st["ids_g"].astype(U32)), bub_mc)
        ovf |= kovf_c
        kreal = jnp.arange(bub_mc, dtype=I32) < jnp.minimum(nkeep, bub_mc)
        mixed = _fmix32_jnp(kp * U32(0x9E3779B9) ^ ks)
        grp_own = jnp.where(kreal, (mixed % U32(S)).astype(I32), S)
        bcap = _cap_for(bub_mc, S)
        routed, _, o4 = route_buckets(
            (kp, ks, kch, kcl, koh, kol, kid), grp_own, S, bcap, axis)
        ovf |= o4
        rp, rs, rch, rcl, roh, rol, rid = routed
        sp_, ss, _, _, _, _, srid = jax.lax.sort(
            (rp, rs, rch, rcl, roh, rol, rid), num_keys=6)
        validm = sp_ != SENTINEL
        same_prev = jnp.concatenate([
            jnp.zeros((1,), jnp.bool_),
            (sp_[1:] == sp_[:-1]) & (ss[1:] == ss[:-1]),
        ])
        doomed_rec = validm & same_prev
        # kill message: route doomed head ids to their owner shards
        did = srid.astype(I32)
        kill_own = jnp.where(doomed_rec, did // cl2, S)
        kcap = _cap_for(bub_mc, S)
        (kids,), _, o5 = route_buckets(
            (did.astype(U32),), kill_own, S, kcap, axis)
        ovf |= o5
        kpresent = kids != SENTINEL
        kloc = jnp.clip(kids.astype(I32) - me * cl2, 0, cl2 - 1)
        doomed = jnp.zeros((cl2,), jnp.bool_).at[
            jnp.where(kpresent, kloc, cl2)].set(True, mode="drop")
        alive2, o6 = kill_heads(alive, st, doomed, remote_gather)
        changed = doomed_rec.any()  # router-side view; psum'd by caller
        ovf |= o6
        od2, us2, nx2, pv2, kovf = update_deg(
            succ, alive2, valid_node, alive & ~alive2, deg[0], deg[1],
            deg[2], me, remote_gather, seg_route)
        return (alive2, changed[None], ovf[None], od2, us2, nx2, pv2,
                kovf[None])

    def final_fn(succ, okv_hi, okv_lo, counts, alive, n_loc):
        """Sharded final chain state for emission: head/dist with cycles
        broken, plus the node-level primary flag (head's primary gathered
        back to every member), all staying sharded — no shard ever holds
        a global-graph-sized array."""
        LEDGER.program("dist_final_exact")
        succ = succ.reshape(cl2, 4)
        okv_hi, okv_lo = okv_hi.reshape(-1), okv_lo.reshape(-1)
        counts, alive = counts.reshape(-1), alive.reshape(-1)
        me = jax.lax.axis_index(axis).astype(I32)
        valid_node = jnp.arange(cl, dtype=I32) < n_loc.reshape(())
        remote_gather, seg_route = make_ops(axis, S, cl2)
        st = chain_state(succ, okv_hi, okv_lo, counts, alive, valid_node,
                         remote_gather, seg_route, me, max_len=None)
        prim_head = st["is_head"] & u64.le(okv_hi, okv_lo,
                                           st["twin_hi"], st["twin_lo"])
        head = st["head"]
        (pm,), o = remote_gather(
            (prim_head.astype(U32),), jnp.clip(head, 0, None),
            st["alive_o"] & (head >= 0), gcap1, (U32(0),))
        primary_node = st["alive_o"] & (head >= 0) & (pm != 0)
        ovf = st["ovf"] | o
        return head, st["dist"], primary_node, st["alive_o"], ovf[None]

    specs_in = (P(axis), P(axis), P(axis), P(axis), P(axis), P(axis), P(),
                P(axis), P(axis), P(axis), P(axis))
    specs_out = (P(axis),) * 8
    tips = jax.jit(jax.shard_map(tips_fn, mesh=mesh, check_vma=False,
                                 in_specs=specs_in,
                                 out_specs=specs_out))
    bubbles = jax.jit(jax.shard_map(bubbles_fn, mesh=mesh,
                                    check_vma=False,
                                    in_specs=specs_in,
                                    out_specs=specs_out))
    final = jax.jit(jax.shard_map(final_fn, mesh=mesh, check_vma=False,
                                  in_specs=specs_in[:6],
                                  out_specs=(P(axis),) * 5))
    degrees = jax.jit(jax.shard_map(
        degrees_fn, mesh=mesh, check_vma=False,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis),) * 5))
    return tips, bubbles, final, degrees


def make_sharded_final(mesh: Mesh, axis: str, local_capacity: int,
                       slack: float = 1.35):
    """Jitted sharded final-chain-state fn (see final_fn above)."""
    return make_sharded_simplify(mesh, axis, local_capacity, slack)[2]


# phase-1 round cap: covers ruler gaps <= 2^(cap-1); a larger gap (or a
# ruler-free cycle) exits non-converged -> exact-path fallback. Matches
# the local _P1_ROUNDS reasoning: P(gap > 4096) ~ n2 * (15/16)^4096 ~ 0.
_P1_CAP = 13


def make_sharded_final_fast(mesh: Mesh, axis: str, local_capacity: int,
                            slack: float = 1.35):
    """Sharded final chain state via distributed RULER RANKING — the
    round-3 single-chip wins (graph/simplify.py::_rank_rulers) ported to
    the multi-host path, where each doubling round costs real exchanges.

    vs the exact final_fn (chain_state with max_len=None), which pays
    ~log2(S*cl2) full-size remote-gather rounds THREE times (head/dist
    doubling, cycle min-doubling with 4 payloads, then head/dist again
    after cycle breaking), this runs:
      - phase 1: early-exit (p, d) doubling frozen at rulers/heads —
        ~log2(max ruler gap) ≈ 8-12 full-size rounds, psum-agreed exit;
      - phase 2: doubling over the RULER arrays only (1/RULER_STRIDE of
        the id space — exchange volume and sort cost shrink by 16x);
      - compose + one tail->head twin routing + one primary gather-back.
    No cycle machinery at all: any surviving cycle (or an over-cap ruler
    gap) exits with ok=False and the caller falls back to the exact
    sharded final — semantics are unchanged, CI-enforced by contig
    parity for P∈{2,4,8} including circular genomes.

    Returns a jitted fn: (succ, okv_hi, okv_lo, counts, alive, n_loc) ->
    (head, dist, primary_node, alive_o, ok [S], ovf [S]).
    """
    from genome_tpu.graph.simplify import RULER_STRIDE

    num_shards = S = mesh.shape[axis]
    cl = local_capacity
    cl2 = 2 * cl
    n2g = S * cl2
    assert cl2 % RULER_STRIDE == 0
    rl = cl2 // RULER_STRIDE          # rulers per shard
    rounds_cap = max(1, (n2g - 1).bit_length() + 1)
    p1_cap = min(rounds_cap, _P1_CAP)
    gcap1 = _cap_for(cl2, S, slack)
    gcap4 = _cap_for(4 * cl2, S, slack)
    rcap = _cap_for(rl, S, slack)

    def fast_fn(succ, okv_hi, okv_lo, counts, alive, n_loc):
        LEDGER.program("dist_final_fast")
        succ = succ.reshape(cl2, 4)
        okv_hi, okv_lo = okv_hi.reshape(-1), okv_lo.reshape(-1)
        counts, alive = counts.reshape(-1), alive.reshape(-1)
        me = jax.lax.axis_index(axis).astype(I32)
        valid_node = jnp.arange(cl, dtype=I32) < n_loc.reshape(())
        remote_gather, seg_route = make_ops(axis, S, cl2)
        rg_rul, _ = make_ops(axis, S, rl)
        ids_g = me * cl2 + jnp.arange(cl2, dtype=I32)
        ids_l = jnp.arange(cl2, dtype=I32)
        alive_o = jnp.repeat(alive & valid_node, 2)
        ovf = jnp.zeros((), jnp.bool_)
        umask = I32(RULER_STRIDE - 1)

        # degrees + links (same exchanges as chain_state's opening)
        tgt = succ.reshape(-1)
        (tgt_alive_u,), o1 = remote_gather(
            (alive_o.astype(U32),), jnp.clip(tgt, 0, None),
            tgt >= 0, gcap4, (U32(0),))
        ovf |= o1
        ok4 = ((tgt >= 0) & (tgt_alive_u != 0)).reshape(-1, 4) \
            & alive_o[:, None]
        outdeg = ok4.sum(axis=1, dtype=I32)
        usucc = jnp.where(ok4, succ, -1).max(axis=1)
        has = outdeg == 1
        w = jnp.where(has, usucc, 0)
        (deg_w1,), o2 = remote_gather((outdeg,), w ^ 1, has, gcap1,
                                      (I32(0),))
        ovf |= o2
        next_u = jnp.where(has & (deg_w1 == 1), w, -1)
        nx = next_u[ids_l ^ 1]
        prev_u = jnp.where(nx >= 0, nx ^ 1, -1)

        # phase 1: (p, d) doubling, frozen at rulers and heads. Exit is
        # psum-agreed so every shard leaves the loop on the same round.
        p0 = jnp.where(prev_u >= 0, prev_u, ids_g)
        d0 = jnp.where(prev_u >= 0, 1, 0).astype(I32)

        def p1_cond(c):
            _, _, _, i, go = c
            return go & (i < p1_cap)

        def p1_body(c):
            p, d, of, i, _ = c
            adv = (p & umask) != 0        # heads self-freeze via p[p]==p
            (pg, dg), o = remote_gather((p, d), p, adv, gcap1,
                                        (p, I32(0)))
            record_psum()
            p2 = jnp.where(adv, pg, p)
            d2 = d + jnp.where(adv, dg, 0)
            ch = (adv & (pg != p)).any()
            go = jax.lax.psum(ch.astype(I32), axis) > 0
            return p2, d2, of | o, i + 1, go

        with LEDGER.loop(p1_cap, dynamic=True):
            p, d, ovf, i1, go1 = jax.lax.while_loop(
                p1_cond, p1_body,
                (p0, d0, ovf, jnp.int32(0), jnp.bool_(True)))
        p1_ok = ~go1

        # phase 2: rank the ruler graph (arrays 1/RULER_STRIDE the size;
        # local ruler j is global id me*cl2 + j*RULER_STRIDE, i.e. global
        # ruler index me*rl + j — contiguous per shard, so rg_rul's
        # owner = idx // rl routing is exact).
        rp0 = p[::RULER_STRIDE]
        rd0 = d[::RULER_STRIDE]

        def p2_cond(c):
            _, _, _, i, go = c
            return go & (i < rounds_cap)

        def p2_body(c):
            rp, rd, of, i, _ = c
            adv = (rp & umask) == 0       # target is itself a ruler
            j = rp // RULER_STRIDE        # global ruler index
            (pg, dg), o = rg_rul((rp, rd), jnp.clip(j, 0, None), adv,
                                 rcap, (rp, I32(0)))
            record_psum()
            rp2 = jnp.where(adv, pg, rp)
            rd2 = rd + jnp.where(adv, dg, 0)
            ch = (adv & (pg != rp)).any()
            go = jax.lax.psum(ch.astype(I32), axis) > 0
            return rp2, rd2, of | o, i + 1, go

        with LEDGER.loop(rounds_cap, dynamic=True):
            rp, rd, ovf, i2, go2 = jax.lax.while_loop(
                p2_cond, p2_body,
                (rp0, rd0, ovf, jnp.int32(0), jnp.bool_(True)))
        p2_ok = ~go2

        # compose: nearest ruler-or-head ancestor -> its ranked head.
        # Deduped requests to one owner <= rl (the rulers it owns), so
        # cap rl never overflows by construction.
        a_rul = (p & umask) == 0
        aj = p // RULER_STRIDE
        (hp, hd), o3 = rg_rul((rp, rd), jnp.clip(aj, 0, None), a_rul,
                              rl, (p, I32(0)))
        ovf |= o3
        head0 = jnp.where(a_rul, hp, p)
        dist0 = d + jnp.where(a_rul, hd, 0)
        head = jnp.where(alive_o, head0, -1)
        dist = jnp.where(alive_o, dist0, 0)
        is_head = alive_o & (head == ids_g)

        # twin okv per head = okv(rc(tail)): at most one tail per chain
        # (cycles are excluded by ok), routed to the head's owner.
        is_tail = alive_o & (next_u == -1)
        okv_rc_hi = okv_hi[ids_l ^ 1]
        okv_rc_lo = okv_lo[ids_l ^ 1]
        lseg, routed, present, o4 = seg_route(
            (okv_rc_hi, okv_rc_lo), ("min2", "min2lo"),
            jnp.clip(head, 0, None), is_tail & (head >= 0), gcap1)
        ovf |= o4
        r_h, r_l = routed
        twin_hi = jax.ops.segment_min(
            jnp.where(present, r_h, U32(0xFFFFFFFF)), lseg,
            num_segments=cl2)
        lo_cand = jnp.where(present & (r_h == twin_hi[lseg]), r_l,
                            U32(0xFFFFFFFF))
        twin_lo = jax.ops.segment_min(lo_cand, lseg, num_segments=cl2)

        # primary flag computed at the head owner, gathered back to every
        # member; prev_u rides the same routing — a composed head with a
        # surviving predecessor means an undetected cycle (ok=False).
        prim_head = is_head & u64.le(okv_hi, okv_lo, twin_hi, twin_lo)
        (pm, pv), o5 = remote_gather(
            (prim_head.astype(U32), prev_u), jnp.clip(head, 0, None),
            alive_o & (head >= 0), gcap1, (U32(0), I32(-1)))
        ovf |= o5
        primary_node = alive_o & (head >= 0) & (pm != 0)
        head_bad = (alive_o & (head >= 0) & (pv >= 0)).any()
        ok = p1_ok & p2_ok & ~head_bad
        # observed doubling round counts (psum-agreed, identical on every
        # shard): the DYNAMIC piece of the exchange ledger — multiply the
        # per-round collective cost by these, not the loop caps
        rnds = jnp.stack([i1, i2])
        return (head, dist, primary_node, alive_o, ok[None], ovf[None],
                rnds[None])

    specs_in = (P(axis),) * 6
    return jax.jit(jax.shard_map(fast_fn, mesh=mesh, check_vma=False,
                                 in_specs=specs_in,
                                 out_specs=(P(axis),) * 7))


def final_state_sharded(mesh: Mesh, axis: str, local_capacity: int,
                        succ, okv_hi, okv_lo, counts, alive, n_loc,
                        metrics=None, max_slack_retries: int = 3):
    """Sharded final chain state with the fast-path/fallback ladder.

    Tries the ruler-ranking fast final (slack-retried on routing
    overflow); falls back to the exact sharded final when a cycle
    survived simplification or the fast path's round caps were exceeded.
    Returns (head, dist, primary_node, alive_o, overflowed) — overflowed
    True only when the exact path also exhausted its retries. Multihost-
    safe: flags are fetched with process allgather so every process
    takes the same decisions.
    """
    import numpy as np

    slack = 1.35
    for _ in range(max_slack_retries):
        fast = make_sharded_final_fast(mesh, axis, local_capacity, slack)
        head, dist, primary, alive_o, fok, fovf, frnds = fast(
            succ, okv_hi, okv_lo, counts, alive, n_loc)
        LEDGER.invoke("dist_final_fast")
        if not bool(np.asarray(_fetch(fovf)).any()):
            if bool(np.asarray(_fetch(fok)).all()):
                if metrics:
                    r = np.asarray(_fetch(frnds))[0]
                    metrics.log("dist_final_fast_rounds",
                                p1=int(r[0]), p2=int(r[1]))
                return head, dist, primary, alive_o, False
            if metrics:
                metrics.log("dist_final_fast_fallback")
            break  # structural (cycle / gap over cap): slack won't help
        slack *= 2.0
        if metrics:
            metrics.log("dist_final_fast_overflow_retry", slack=slack)
    slack = 1.35
    for _ in range(max_slack_retries):
        final = make_sharded_final(mesh, axis, local_capacity, slack)
        head, dist, primary, alive_o, fovf = final(
            succ, okv_hi, okv_lo, counts, alive, n_loc)
        LEDGER.invoke("dist_final_exact")
        if not bool(np.asarray(_fetch(fovf)).any()):
            return head, dist, primary, alive_o, False
        slack *= 2.0
        if metrics:
            metrics.log("dist_final_overflow_retry", slack=slack)
    return head, dist, primary, alive_o, True


def _fetch(x):
    """Global array -> host numpy; multihost arrays need an allgather
    (np.asarray on a non-fully-addressable array raises)."""
    import numpy as np
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return multihost_utils.process_allgather(x, tiled=True)


def simplify_sharded(mesh: Mesh, axis: str, local_capacity: int,
                     succ, okv_hi, okv_lo, counts, alive, n_loc, params,
                     max_slack_retries: int = 3):
    """Host fixpoint loop over the sharded passes (SEMANTICS §5 order).

    On routing-capacity overflow the loop RETRIES from the initial alive
    mask with doubled bucket slack (rebuilt jitted passes) instead of
    falling back to a replicated pass — one skewed hash bucket no longer
    silently abandons the multi-shard memory guarantee. Partial results
    from an overflowed attempt are always discarded.

    Returns (alive, overflowed: bool); overflowed only after all retries.
    Works in multi-process (multihost) runs too: the changed/overflow
    flags are fetched via process allgather, so every process takes the
    same host control-flow decisions (deterministic SPMD).
    """
    alive0 = alive
    tip_len = jnp.asarray([params.tip_len_eff], I32)
    bubble_len = jnp.asarray([params.bubble_len_eff], I32)
    slack = 1.35
    for _attempt in range(max_slack_retries):
        tips, bubbles, _, degrees = make_sharded_simplify(
            mesh, axis, local_capacity, slack=slack,
            tip_max_len=params.tip_len_eff,
            bubble_max_len=params.bubble_len_eff)
        alive = alive0
        overflowed = False
        deg = None  # carried (outdeg, usucc, next_u, prev_u), run_pass_inc
                    # analog: recomputed from scratch only on pass 1 and
                    # after an incremental-update buffer overflow

        def _fresh(alive_now):
            od, us, nx, pv, dovf = degrees(succ, alive_now, n_loc)
            LEDGER.invoke("dist_degrees")
            return (od, us, nx, pv), bool(_fetch(dovf).any())

        for _ in range(params.max_rounds):
            if deg is None:
                deg, dovf = _fresh(alive)
                if dovf:
                    overflowed = True
                    break
            alive, c1, o1, od, us, nx, pv, k1 = tips(
                succ, okv_hi, okv_lo, counts, alive, n_loc, tip_len, *deg)
            LEDGER.invoke("dist_tips")
            if bool(_fetch(o1).any()):
                overflowed = True
                break
            deg = None if bool(_fetch(k1).any()) else (od, us, nx, pv)
            if deg is None:
                deg, dovf = _fresh(alive)
                if dovf:
                    overflowed = True
                    break
            alive, c2, o2, od, us, nx, pv, k2 = bubbles(
                succ, okv_hi, okv_lo, counts, alive, n_loc, bubble_len,
                *deg)
            LEDGER.invoke("dist_bubbles")
            if bool(_fetch(o2).any()):
                overflowed = True
                break
            deg = None if bool(_fetch(k2).any()) else (od, us, nx, pv)
            if not (bool(_fetch(c1).any()) or bool(_fetch(c2).any())):
                break
        if not overflowed:
            return alive, False
        slack *= 2.0
    return alive0, True
