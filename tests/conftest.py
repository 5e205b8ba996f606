"""Test environment: CPU backend, 8 virtual devices, float64.

Multi-device sharding logic runs without an accelerator via XLA's
host-platform device-count flag (the standard JAX fake-backend trick —
SURVEY.md section 4).  The CPU backend is forced only when
``JAX_PLATFORMS`` is unset, so a run that names a platform (the ``gpu``
tests that ``chip_smoke.py`` runs on the card) keeps it.  float64 is
enabled so parity tests against the reference's 1e-10 tolerances are
meaningful; production runs on the card use f32 (see README on precision).
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when the run has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; this run's first device is {dev.platform}")
    return dev
