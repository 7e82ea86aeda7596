"""Test configuration: force an 8-device CPU mesh and float64.

Tests run on a virtual 8-device CPU topology
(xla_force_host_platform_device_count) so all sharding/mesh code paths are
exercised without several cards; numeric tests use x64 for tight
tolerances.

SLSLAM_GPU_TESTS=1 only stops the forcing of the CPU, so that the tests
marked ``gpu`` can run on a card (README, "Tests").  It changes nothing
that is collected: a ``gpu`` test asks for a card inside its fixture.
"""

import os

_FORCE_CPU = os.environ.get("SLSLAM_GPU_TESTS") != "1"

if _FORCE_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if _FORCE_CPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

# The suite wall is XLA:CPU compile-bound; the persistent compilation cache
# (JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache) lets re-runs on
# the same machine start warm.
from slslam.utils.compcache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when the process has none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs a GPU: run with SLSLAM_GPU_TESTS=1 on a card")
    return device


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """XLA:CPU segfaults inside backend_compile once a process has
    accumulated enough compiled executables (reproduced twice at the
    ~55% mark of the full suite, each time in whichever test compiled
    the next fresh kernel — LLVM JIT resource exhaustion, not a kernel
    bug).  Dropping the compiled-executable caches at module boundaries
    keeps the accumulation bounded; module-scoped fixtures still share
    compiles within their module."""
    yield
    jax.clear_caches()
    # engine-level compiled-scan cache holds executables too
    try:
        from slslam.engine.batch import BatchSlam
        BatchSlam._runner_cache.clear()
    except Exception:
        pass
