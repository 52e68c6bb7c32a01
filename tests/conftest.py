"""Test configuration: run JAX on CPU with 8 virtual devices so multi-device
sharding logic is exercised without GPUs (the standard JAX fake-backend
trick). The config is set as well as the environment, so a platform chosen
elsewhere cannot win.

Tests that need the card carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips when JAX has no GPU. They run on a
machine with one, outside this CPU pinning:

    FWT_TEST_PLATFORM=gpu python -m pytest -m gpu tests/
"""

import os

import pytest

ON_GPU = os.environ.get("FWT_TEST_PLATFORM") == "gpu"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def gpu_device():
    """The first GPU, decided when the test runs; skips without one."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: JAX has no gpu backend here")
