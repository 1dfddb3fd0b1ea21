"""Structured metrics/observability (SURVEY.md §5.5).

JSONL events (phase, wall seconds, throughput, sizes): k-mers/s per
device, reads/s, per-phase walls.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time


class Metrics:
    def __init__(self, path: str | None = None, stream=None, quiet: bool = False):
        self._f = open(path, "a") if path else None
        self._stream = stream if stream is not None else sys.stderr
        self._quiet = quiet
        self.events: list[dict] = []

    def log(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        self.events.append(rec)
        line = json.dumps(rec, sort_keys=True)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if not self._quiet:
            print(f"[genome_tpu] {event}: " + " ".join(
                f"{k}={v}" for k, v in fields.items()), file=self._stream)

    @contextlib.contextmanager
    def phase(self, name: str, **fields):
        t0 = time.perf_counter()
        self.log("phase_start", phase=name, **fields)
        info: dict = {}
        try:
            yield info
        finally:
            dt = time.perf_counter() - t0
            self.log("phase_end", phase=name, wall_s=round(dt, 4), **info)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
