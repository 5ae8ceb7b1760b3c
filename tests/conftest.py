"""Test env: force JAX onto a virtual 8-device CPU mesh so sharding and
collective logic is exercised without an accelerator (SURVEY.md §4.3).
The tests keep no persistent compile cache: their programs are small,
and several workers would share one cache directory."""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Every test not explicitly marked `slow` is `quick`, so
    `pytest -m quick` is the <2-minute commit gate and the full suite
    stays the per-round gate."""
    for item in items:
        if "slow" not in item.keywords and "quick" not in item.keywords:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA's CPU backend segfaults on the NEXT fresh compile after a
    long accumulation of compiled executables in one process (observed
    deterministically at ~50-70% of the full suite, always inside
    backend_compile_and_load; any smaller selection passes).  Freeing
    the executable caches between test modules keeps the per-process
    accumulation bounded; per-module recompiles cost a little time and
    buy a suite that finishes."""
    yield
    jax.clear_caches()
