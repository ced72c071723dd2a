"""Test configuration: the CPU backend with an 8-device virtual mesh.

The tests run on the CPU (`JAX_PLATFORMS=cpu`); multi-device sharding is
validated on virtual CPU devices, and the GPU run is chip_smoke.py.  This
mirrors the reference's always-testable CPU fallback policy (QAT compiled
out in CI, .github/workflows/github-ci.yml:57-60).
"""

import os

# Pin the CPU before any backend initializes: jax may already be imported,
# so the env var alone can be too late; jax.config below covers that case.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import random

import pytest


@pytest.fixture
def rng():
    return random.Random(0xC0FFEE)
