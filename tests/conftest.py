"""Test harness environment.

Tests run on CPU with 8 virtual devices (the standard JAX pattern for
exercising multi-device sharding on one box, SURVEY.md section 4) and
float64 enabled for parity-grade numerics. The overrides must land before
the first backend initialization: XLA_FLAGS via os.environ, platform/x64 via
jax.config. What only the GPU can check is a phase of chip_smoke.py, not a
test.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DIR = "/root/reference"
CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.fixture()
def rng(request):
    # deterministic per test (independent of execution order and process)
    import zlib

    return np.random.default_rng(zlib.crc32(request.node.name.encode()))
