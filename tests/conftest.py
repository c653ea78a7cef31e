"""Test configuration: run all tests on a virtual 8-device CPU mesh.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``); sharding correctness is
validated with XLA's forced host device count. What only the GPU can show
(compiled kernels, TF32 defaults, timing) is checked by ``chip_smoke.py``
on the card, not here. The platform is forced both through the environment
and through ``jax.config`` before the first backend initialization (which
has not happened yet at conftest import time), so a machine with a GPU
still runs the suite on the CPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration test"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)
