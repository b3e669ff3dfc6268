"""Test configuration: force an 8-device virtual CPU mesh.

Multi-chip sharding paths (pjit/shard_map over a Mesh) are exercised on CPU
with 8 virtual devices, per the framework's test strategy (SURVEY.md §4): no
TPU pod is needed to validate collective layouts.

NOTE: the harness environment force-registers a TPU backend and sets
``jax_platforms`` programmatically at interpreter startup, so plain
JAX_PLATFORMS/XLA_FLAGS env vars are ignored here — we override via
``jax.config`` before any backend is initialized.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: full-size-model tests (minutes on CPU)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (patent_tpu_torch kernels); "
                   "skips without one")


@pytest.fixture()
def rng():
    """Function-scoped so every test sees the same draws it gets when run
    in isolation — a session-scoped stream made numeric-tolerance tests
    order-dependent (adding a test upstream shifted every later draw and
    could push a borderline int8 fast-path bound over its limit)."""
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices (run under tests/ conftest env)")
    return devs[:8]
