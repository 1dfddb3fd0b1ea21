"""Exchange ledger: per-program collective/byte accounting (SURVEY §5.5).

A multi-host scaling claim needs EVIDENCE: how
many collectives each sharded program issues and how many bytes ride the
wire per invocation. Collectives live inside jitted shard_map bodies, so
runtime Python counters never see them — but every body executes exactly
once per compilation, at trace time. The ledger therefore records, at
trace time, each program's exchange structure:

- `record_a2a(n, num_shards, elems_per_shard)` fires from route_buckets /
  the fused response exchange; `record_psum()` from psum sites.
- loop bodies are traced once; call sites wrap the loop with
  `ledger.loop(rounds)` so the recorded cost carries the trip count
  (while_loops pass their round CAP and mark the entry dynamic — the
  observed round count is whatever the early-exit converges to).
- each shard_map body declares itself with `ledger.program("tips")` as
  its first statement (bodies only run while tracing).

The host orchestrators count program INVOCATIONS; per-phase totals =
program cost x invocations, logged to the metrics JSONL as
`exchange_ledger` events. Wire volume per all_to_all per shard =
4 bytes x elems_per_shard, of which (S-1)/S actually leaves the chip.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field


@dataclass
class _ProgramCost:
    a2a: int = 0              # all_to_all launches per invocation
    elems: int = 0            # u32 elems sent per shard, all a2as summed
    psum: int = 0
    dyn_a2a: int = 0          # portion of a2a under dynamic (capped) loops
    dyn_elems: int = 0
    sites: dict = field(default_factory=dict)

    def as_dict(self, cross: float) -> dict:
        return {
            "a2a": self.a2a,
            "psum": self.psum,
            "mb_per_shard": round(self.elems * 4 / 1e6, 3),
            "mb_crossing": round(self.elems * 4 * cross / 1e6, 3),
            "dyn_a2a_cap": self.dyn_a2a,
            "dyn_mb_cap": round(self.dyn_elems * 4 / 1e6, 3),
        }


class ExchangeLedger:
    def __init__(self):
        self.programs: dict[str, _ProgramCost] = {}
        self.invocations: dict[str, int] = {}
        # pre-retrace epochs: capacity-retry ladders retrace a program
        # with bigger caps; invocations already charged against the OLD
        # cost are archived so the totals never multiply old invocation
        # counts by the new (bigger) per-invocation cost
        self.archived: dict[str, list] = {}
        self._current: str | None = None
        self._mult = 1
        self._dynamic = 0
        self.num_shards = 0

    # ---- trace-time hooks ----
    def program(self, name: str) -> None:
        """Declare the program being traced (first line of a body fn).
        Re-tracing the same name archives the prior epoch's
        (cost, invocations) and starts a fresh cost."""
        if name in self.programs and self.invocations.get(name, 0) > 0:
            self.archived.setdefault(name, []).append(
                (self.programs[name], self.invocations[name]))
            self.invocations[name] = 0
        self._current = name
        self.programs[name] = _ProgramCost()
        self._mult = 1
        self._dynamic = 0

    @contextlib.contextmanager
    def loop(self, rounds: int, dynamic: bool = False):
        self._mult *= max(1, int(rounds))
        if dynamic:
            self._dynamic += 1
        try:
            yield
        finally:
            self._mult //= max(1, int(rounds))
            if dynamic:
                self._dynamic -= 1

    def record_a2a(self, n: int, num_shards: int, elems: int) -> None:
        if self._current is None:
            return
        self.num_shards = num_shards
        c = self.programs[self._current]
        c.a2a += n * self._mult
        c.elems += elems * self._mult
        if self._dynamic:
            c.dyn_a2a += n * self._mult
            c.dyn_elems += elems * self._mult

    def record_psum(self, n: int = 1) -> None:
        if self._current is None:
            return
        c = self.programs[self._current]
        c.psum += n * self._mult

    # ---- host-side hooks ----
    def invoke(self, name: str, n: int = 1) -> None:
        self.invocations[name] = self.invocations.get(name, 0) + n

    def reset_invocations(self) -> None:
        self.invocations = {}
        self.archived = {}

    def summary(self) -> dict:
        S = self.num_shards
        # crossing fraction of an all_to_all buffer: (S-1)/S leaves the
        # shard; a true 1-shard mesh crosses nothing
        cross = (S - 1) / S if S > 1 else 0.0
        out = {}
        tot_a2a = tot_mb = 0.0
        for name, cost in self.programs.items():
            inv = self.invocations.get(name, 0)
            d = cost.as_dict(cross)
            d["invocations"] = inv
            epochs = self.archived.get(name, [])
            if epochs:
                d["retry_epochs"] = len(epochs)
            out[name] = d
            tot_a2a += d["a2a"] * inv
            tot_mb += d["mb_crossing"] * inv
            for old_cost, old_inv in epochs:
                od = old_cost.as_dict(cross)
                tot_a2a += od["a2a"] * old_inv
                tot_mb += od["mb_crossing"] * old_inv
        out["_totals"] = {"a2a_invoked": int(tot_a2a),
                          "mb_crossing_invoked": round(tot_mb, 3),
                          "num_shards": S}
        return out


LEDGER = ExchangeLedger()


def record_a2a(n: int, num_shards: int, elems: int) -> None:
    LEDGER.record_a2a(n, num_shards, elems)


def record_psum(n: int = 1) -> None:
    LEDGER.record_psum(n)
