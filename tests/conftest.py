"""Test configuration: CPU backend with 8 virtual devices (multi-device
sharding tests run on a virtual mesh, the capability the reference's MPI
test-suite lacks) and float64 for physics fidelity.

Tests that need the card carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when JAX finds no GPU.  Run them
on the card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU; the test skips when JAX has none (decided here, at
    run time, so every xdist worker collects the same tests)."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU (JAX found none)")
    return gpus[0]
