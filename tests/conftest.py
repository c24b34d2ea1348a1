"""Test configuration: force a CPU backend with 8 virtual devices.

The tests run on the CPU. Multi-device sharding is checked on a virtual CPU
mesh (``--xla_force_host_platform_device_count=8``); the GPU path is
exercised by ``chip_smoke.py``. jax may already be imported when this file
runs, so the platform is *overridden* (not setdefault) in the environment
and in the live jax config.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running end-to-end test")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
