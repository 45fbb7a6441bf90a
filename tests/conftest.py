"""Test configuration: the suite runs on the CPU backend.

x64 is enabled because golden regression vectors are checked at 1e-6
after hundreds of eigh/QR ops, and the host platform is split into 8
virtual devices so the sharding tests see a mesh. Tests that need the
GPU carry the `gpu` marker and skip here; `python chip_smoke.py` runs
what they cover on the card.

BLAS threads: jaxlib's CPU LAPACK kernels and numpy run on OpenBLAS,
whose idle threads busy-wait. Under `pytest -n <k>` every worker starts
one OpenBLAS pool per library with a thread per core, the pools spin
against each other, and a 20 ms TEBD step takes seconds. Each test
process therefore keeps one BLAS thread; XLA's own CPU thread pool is
unaffected.
"""

import os

os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
# the CPU unless the caller names platforms (`JAX_PLATFORMS=cuda,cpu
# pytest -m gpu tests/` on a machine with the card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

try:
    import threadpoolctl
except ImportError:  # not installed everywhere (e.g. the GPU hosts)
    threadpoolctl = None
if threadpoolctl is not None:
    # numpy (and its OpenBLAS) is already loaded by pytest's plugins,
    # before the variable above could reach it
    threadpoolctl.threadpool_limits(1, user_api="blas")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from optimalcontrolmps.profiling import enable_compile_cache  # noqa

# persistent XLA compilation cache: the suite is compile-bound (scan-heavy
# rollout/Hessian programs); warm runs skip most of it
enable_compile_cache()

# ---------------------------------------------------------------------------
# test tiers: compile-heavy files are auto-marked `slow` so the smoke tier
#     pytest -m "not slow" tests/
# gives fast iteration; CI / pre-commit runs the full suite.
# ---------------------------------------------------------------------------
import pytest  # noqa: E402

_SLOW_FILES = {
    "test_hessian.py", "test_vidal.py", "test_dmrg.py", "test_tebd.py",
    "test_optimizers.py", "test_drivers.py", "test_parallel.py",
    "test_sector.py", "test_gradient.py", "test_streaming_hessian.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.get_closest_marker("smoke") is not None:
            # explicit smoke opt-out: fast representative tests from the
            # core-math files stay in the smoke tier (the fast signal must
            # exercise the physics too)
            continue
        if os.path.basename(str(item.fspath)) in _SLOW_FILES:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none (decided
    at run time, never at import or collection)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
