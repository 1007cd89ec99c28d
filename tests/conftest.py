"""Test configuration.

The suite runs on whatever platform ``JAX_PLATFORMS`` selects; with
``JAX_PLATFORMS=cpu`` the CPU backend is split into 8 virtual devices, so
the data-parallel paths shard as they would over several cards.  Tests
marked ``gpu`` need an NVIDIA card and skip elsewhere; on the card run
``python -m pytest tests/ -m gpu``.
"""
import os
import sys

import pytest

os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX sees none.  Decided
    here, at run time, never while test modules are imported."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (JAX sees none)")
    return devs[0]
