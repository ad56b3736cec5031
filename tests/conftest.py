"""Test env: JAX on the CPU with 8 virtual devices, so sharding tests
exercise a multi-device mesh without a cluster (SURVEY.md §5 "Distributed
without a cluster"). Pallas kernels run in interpret mode here.

Tests marked ``gpu`` need the card and skip elsewhere; run them on a GPU
machine with

    VXTPU_TEST_PLATFORM=cuda python -m pytest -m gpu tests/

XLA_FLAGS is read when the CPU client is created, which happens lazily at
the first device use, so the write below lands in time.
"""

import os

import jax
import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

jax.config.update("jax_platforms", os.environ.get("VXTPU_TEST_PLATFORM", "cpu"))


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at run time, not import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: VXTPU_TEST_PLATFORM=cuda python -m "
                    "pytest -m gpu tests/")
    return jax.devices()[0]
