"""Test harness: everything runs on 8 virtual CPU devices (SURVEY §5.5)
unless JAX_PLATFORMS names another platform.

Tests marked `gpu` need an NVIDIA card and skip elsewhere; on the card run
them with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "oracle"))

import jax  # noqa: E402

_PLATFORMS = os.environ.get("JAX_PLATFORMS") or "cpu"
jax.config.update("jax_platforms", _PLATFORMS)
jax.config.update("jax_enable_x64", False)

if _PLATFORMS == "cpu":
    assert jax.devices()[0].platform == "cpu", "tests must run on CPU devices"
    assert jax.device_count() == 8, "expected 8 virtual CPU devices"


@pytest.fixture(autouse=True)
def _gpu_gate(request):
    """Skip `gpu`-marked tests unless JAX's default device is a GPU (decided
    per test, never at import, so every xdist worker collects the same
    tests)."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest tests/ -m gpu")
