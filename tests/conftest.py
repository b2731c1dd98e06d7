"""Test configuration: run everything on CPU with 8 virtual devices.

Mirrors the reference's strategy of running one generic suite against every
backend (SURVEY.md §5): here the suites run on CPU (XLA + interpreter-mode
Pallas) with an 8-device virtual mesh to exercise the sharded paths without
accelerator hardware.  Must set env vars before jax is imported anywhere.
Tests marked `gpu` need the card and skip elsewhere; JAX_PLATFORMS, when
set, wins over the CPU default, so they run with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, at test time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU (run: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)")
