"""Test env: the CPU backend with 8 virtual devices, so sharding tests run
anywhere (SURVEY.md §5: multi-host simulated via
xla_force_host_platform_device_count).

The card-only tests (marker ``gpu``) run on a machine with an NVIDIA card
with ``python -m pytest -m gpu tests/``; for that selection the backend is
left to JAX's default, so they reach the card. Everywhere else the CPU is
forced through jax.config before any device is used (XLA_FLAGS must be
set before the CPU client comes up)."""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import numpy as np
import pytest


def pytest_configure(config):
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(20260817)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's backend is an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m gpu tests/ "
                    "on a machine with the card")
