"""Test harness config: run on the CPU with an 8-device virtual mesh so
multi-device sharding paths are exercised without GPUs (SURVEY §4 item 3).

The platform is set through ``jax.config`` before the first JAX op (an
environment variable read later would be too late once JAX is imported):
the CPU unless ``JAX_PLATFORMS`` names another platform. Tests marked
``gpu`` compare kernels compiled for the card with their references at
full width; they skip elsewhere, and run on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# no persistent compile cache under tests (must be set before the package
# import enables it): CPU AOT cache entries record host machine features
# and XLA warns of SIGILL on mismatch, and these tiny programs compile fast
os.environ["ASR_COMPILE_CACHE"] = "0"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless the backend is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"
        )
