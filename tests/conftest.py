"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Multi-device sharding logic is validated on a virtual CPU mesh (SURVEY.md §4
test plan (d)); numerical parity tests against the scipy oracle run in f64.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from manifold_flow_tpu.utils.compile_cache import (  # noqa: E402
    configure_compile_cache,
)

# The CG/Cholesky programs are expensive to compile on CPU; cache them
# across test runs.
configure_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from manifold_flow_tpu.geometry import synthetic  # noqa: E402


@pytest.fixture(scope="session")
def small_mesh():
    """Flat 12x12 patch (144 vertices) — fast unit-test mesh."""
    return synthetic.plane_patch(nx=12, ny=12, lx=6.0, ly=6.0)


@pytest.fixture(scope="session")
def curved_mesh():
    """Curved patch (gaussian bump) — exercises nontrivial tangent bases."""
    return synthetic.plane_patch(
        nx=12, ny=12, lx=6.0, ly=6.0,
        height=lambda x, y: 0.8 * np.exp(-((x - 3.0) ** 2 + (y - 3.0) ** 2) / 4.0),
    )


@pytest.fixture(scope="session")
def wave_movie(curved_mesh):
    pot, times = synthetic.plane_wave_movie(curved_mesh, n_frames=6)
    return pot, times
