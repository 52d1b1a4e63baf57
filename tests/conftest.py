"""Test config: the CPU with an 8-device virtual mesh, unless
JAX_PLATFORMS says otherwise.

Tests run on the CPU (fast, deterministic); multi-device sharding tests
use the 8 virtual devices.  Tests marked `gpu` need an NVIDIA card and
skip elsewhere (see the `gpu_device` fixture); run them on the card with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist`.
"""

import os

import jax
import pytest

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

from pcrhpg24_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on hosts without one")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (none visible to JAX)")
    return gpus[0]
