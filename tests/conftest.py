"""Test environment: CPU backend with 8 virtual devices.

The reference has no tests (SURVEY §4); this suite is designed from scratch.
The virtual devices stand in for a multi-GPU host: sharding tests run the
same shard_map code on an 8-device CPU mesh.  The GPU paths are exercised
here through the Pallas interpreter and on the card by chip_smoke.py.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# force the platform through the config too, in case jax was configured
# before this file ran
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
