import os

# The unit tests run on the CPU, with 8 virtual devices for the sharding
# tests and float64 for the parity tests.  Tests that need a GPU take the
# `gpu` fixture below and skip without one; chip_smoke.py covers that path.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax
import pytest

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when the process has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: run the GPU path through chip_smoke.py")
