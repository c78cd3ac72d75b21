"""Test configuration.

By default the tests run on a virtual 8-device CPU platform: the CPU
backend is pinned as the default device, and the Pallas kernels run in the
interpreter (zenith.ops.runtime routes on the default device's
platform).

``--gpu`` leaves the default device alone, so tests marked ``gpu`` run
their kernels compiled on the card (``python -m pytest tests/ -m gpu --gpu
-p no:xdist``; chip_smoke.py runs the same set in-process). Without a GPU
those tests skip, deciding inside a fixture, never at import time.
"""

import os

import numpy as np
import pytest

# Validation default-ON under pytest — the reference ships its Vulkan
# validation layers on by default (zenith-rhi/Cargo.toml:23); tests are
# where bugs are made. Individual tests may override via monkeypatch.
os.environ.setdefault("ZENITH_VALIDATE", "1")


def pytest_addoption(parser):
    parser.addoption(
        "--gpu", action="store_true", default=False,
        help="run on the default device (a GPU) instead of pinning the CPU",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; run with --gpu (skips without one)"
    )
    gpu_run = config.getoption("--gpu")
    if not gpu_run:
        # Before anything initializes a backend: 8 virtual CPU devices.
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from zenith.engine import ensure_persistent_compile_cache

    ensure_persistent_compile_cache()
    if not gpu_run:
        jax.config.update("jax_default_device", jax.devices("cpu")[0])


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU attached (run with --gpu on a machine with one)")
    return devs[0]


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(seed=1234)


@pytest.fixture
def cpu_devices():
    import jax

    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("virtual 8-device CPU platform unavailable")
    return devs
