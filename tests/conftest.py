"""Test harness configuration.

Tests run on the CPU with 8 virtual devices, so the multi-device sharding
paths (``zpc_tpu.parallel.mesh``) run without accelerators.  The CPU is
forced only when ``JAX_PLATFORMS`` is unset or ``cpu``; with
``JAX_PLATFORMS=cuda`` the same suite runs on the GPU, and the tests
marked ``chip`` (card-only; they skip elsewhere) run too:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m chip

Oracle fixtures mirror the reference's test strategy (SURVEY §4): every
primitive/kernel is checked against a serial NumPy recomputation across
adversarial sizes (reference ``test/utils/parallel_primitives.hpp:7-33``).
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Adversarial sizes from the reference oracle tests
# (test/parallel_primitives.cpp:6-29), scaled down at the top end for CI time.
ORACLE_SIZES = [1, 2, 7, 16, 128, 1024, 8192]


@pytest.fixture(params=ORACLE_SIZES)
def oracle_size(request):
    return request.param


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The GPU device for card-only tests (``@pytest.mark.chip``); skips
    when JAX's first device is not a GPU.  Decided here, at run time —
    never while a test module is imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
