"""Test harness config: the CPU with 8 virtual devices, unless asked.

Mirrors SURVEY.md §4's rebuild test strategy: multi-device sharding is
validated on a virtual CPU mesh, so no multi-card machine is needed.
The tier-1 run uses the CPU.  A run that names a platform in
JAX_PLATFORMS keeps it: the card-only tests (marker ``gpu``) run on the
GPU with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run with JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
