"""Process-level JAX set-up shared by the entry points (the CLI, the
multi-process launcher, bench.py and chip_smoke.py).

Compile cache: where JAX_COMPILATION_CACHE_DIR is set, JAX reads it and
nothing here overrides it. Otherwise the cache lives at one fixed path
inside the checkout (`.jax_cache/`, git-ignored). The path is part of
what makes a cache entry reusable, so it is never built from a temporary
name, a pid or the time.

One card per process: a JAX process reserves most of a card's memory when
it first uses it, so a second process on the same card fails. Processes
that share a host each take their own card (`--local-device-ids` of
dist/launch.py, parsed by `parse_device_ids`).
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    Call before the first compilation of the process."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def parse_device_ids(text: str) -> list[int]:
    """'0' or '0,2' -> [0] / [0, 2]: the local cards a process opens."""
    try:
        ids = [int(t) for t in text.split(",")]
    except ValueError:
        raise ValueError(f"device ids must be comma-separated integers, "
                         f"got {text!r}") from None
    if any(i < 0 for i in ids) or len(set(ids)) != len(ids):
        raise ValueError(f"device ids must be distinct and >= 0, got {text!r}")
    return ids
