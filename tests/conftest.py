"""Test harness config.

CPU lane (the default): JAX is forced onto a virtual 8-device CPU
platform, so sharding/all_to_all paths are exercised without real
multi-card hardware (SURVEY.md §4.5). The override is config-level and
runs before any backend initialization — hence here, at conftest import.

GPU lane: `python -m pytest tests -m gpu` keeps JAX's default platform
and runs only the `gpu`-marked tests on the card (chip_smoke.py runs it
first). A `gpu`-marked test skips, with its reason, when the live
platform is not a GPU; the decision is taken in a fixture, never at
import or collection, so every xdist worker collects the same tests.
"""

import os

import pytest


def _gpu_lane(config) -> bool:
    return config.getoption("markexpr", default="").strip() == "gpu"


def pytest_configure(config):
    if _gpu_lane(config):
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    # the CLI and launcher turn on the persistent compile cache inside the
    # checkout; CPU test programs are not worth keeping there
    jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless the live platform is a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax
        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.skip(f"needs an NVIDIA GPU (platform is {platform}); "
                        f"run `python chip_smoke.py` on the card")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled-executable and tracing caches between test modules.

    The full suite compiles many hundreds of XLA:CPU programs in one
    process; past ~90% of the suite the CPU compiler intermittently
    segfaulted inside backend_compile_and_load (observed twice at
    test_walk_ladder after the tests grew the program count — the same
    test passes 3/3 standalone). Dropping dead executables at module
    boundaries keeps the per-process compiler state bounded; the cost is
    re-compiling the few fixtures shared across modules."""
    yield
    import jax
    jax.clear_caches()
