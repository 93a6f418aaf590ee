"""Test configuration: an 8-device virtual CPU mesh by default.

Multi-device sharding is tested the standard JAX way — a fake 8-device host
platform — so the suite runs anywhere without an accelerator. Must run
before jax initializes, hence the env mutation at import time.

Tests that need an NVIDIA GPU are marked ``gpu`` and take the ``gpu``
fixture, which skips them unless the first JAX device is a GPU. On the
card (which has no torch, so only the torch-free files)::

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu \
        tests/test_pallas.py tests/test_metrics.py

The same checks run as phases of ``chip_smoke.py``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Keep fp32 matmuls truly fp32 for parity tests.
os.environ.setdefault("JAX_DEFAULT_MATMUL_PRECISION", "highest")

# jax may already be imported by a pytest plugin — set the platforms
# through the live config too (safe while the backend is uninitialized).
import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the expensive jits in this suite (the full
# CycleGAN train step over the virtual 8-device mesh, the Inception FID
# graph) dominate wall time; caching them makes repeat runs fast.
from multi_style_transfer_gan.utils import enable_compilation_cache

enable_compilation_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return dev
