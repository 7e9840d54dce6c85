"""Test environment: 8 virtual CPU devices so mesh/sharding tests run
without accelerator hardware; Pallas kernels run in interpret mode.

Must run before the first ``import jax`` anywhere in the test session.

Tests that need the GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them here; ``python chip_smoke.py``
runs the same checks compiled on the card.
"""

import os

import pytest

# tests run hermetically on the virtual CPU mesh, whatever the caller set
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# the config wins over the environment: pin it AFTER jax import, before
# any backend init
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

assert len(jax.devices()) == 8, (
    f"tests expect the 8-device virtual CPU mesh, got {jax.devices()}")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long multi-process tests (spawn fresh JAX procs)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on the CPU; "
                   "chip_smoke.py runs the compiled path on the card)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none.  Decided
    here, at run time, never while a module is imported."""
    import jax
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py on one")
    return gpus[0]
