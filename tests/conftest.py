"""Test harness config: CPU backend with 8 virtual devices (multi-device
sharding tests without accelerators) and x64 for reference-parity numerics.

Tests marked ``gpu`` need an NVIDIA GPU backend: they skip elsewhere and
run on the card through ``python chip_smoke.py``, whose f64 phase runs
``pytest -m gpu`` inside its own JAX process."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU backend (run by chip_smoke.py)"
    )


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU
    (decided per test, never at import time)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU backend; run by chip_smoke.py")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop jit/compilation caches between test modules.

    A full-suite run (~195 tests, several hundred XLA:CPU compilations in
    one process) reproducibly segfaults inside backend_compile_and_load
    near the END of the suite (test_stepper::test_step_determinism) while
    every module passes in isolation — an XLA CPU JIT state/accumulation
    bug, not a framework one.  Clearing per module keeps each module's
    compile history short and the suite green; the cost is re-tracing a
    handful of shared helpers per module."""
    yield
    jax.clear_caches()
