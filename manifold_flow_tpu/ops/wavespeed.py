"""Wave-speed estimation from amplitude or phase movies.

Batched redesign of S5_compute_wave_v.py: the reference's quadruple Python
loops (time x vertex for projection, basis expression, modulus; S5:32-53,
97-118) collapse into batched einsums, and the per-vertex incident-cell loop
(compute_grad_M_I, S5:136-171) becomes a triangle scatter-add.

wave speed = temporal derivative / |tangential spatial gradient|
(S5:56, 121); the phase method uses wrap-aware time differences.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from manifold_flow_tpu.geometry.mesh import TriMesh
from manifold_flow_tpu.geometry.tangent import express_on_basis, project_to_plane
from manifold_flow_tpu.ops.phase import (
    temporal_gradient_amplitude,
    temporal_gradient_phase,
)

# f32 contractions run at full f32 precision (no TF32 on GPUs).
_HIGHEST = jax.lax.Precision.HIGHEST


@jax.jit
def vertex_gradients(mesh: TriMesh, movie: jnp.ndarray) -> jnp.ndarray:
    """Per-vertex spatial gradients (T, N, 3): area-weighted average of the
    P1 triangle gradients over each vertex's incident cells
    (compute_grad_M_I, S5:136-171)."""
    tri = mesh.triangles
    gw = mesh.grad_w.astype(movie.dtype)
    areas = mesh.areas.astype(movie.dtype)
    grad_m = jnp.einsum("tmc,mcd->tmd", movie[:, tri], gw,
                        precision=_HIGHEST)  # (T, M, 3)
    weighted = grad_m * areas[None, :, None]
    t = movie.shape[0]
    m = tri.shape[0]
    # Gather-mode reduction over each vertex's incident cells (a triangle
    # incident to v contributes its gradient exactly once, matching the
    # per-corner scatter in the reference).
    idx = jnp.where(mesh.vertex_cells < 0, m, mesh.vertex_cells)  # (N, C)
    wpad = jnp.concatenate(
        [weighted, jnp.zeros((t, 1, 3), weighted.dtype)], axis=1)
    num = jnp.take(wpad, idx, axis=1).sum(axis=2)            # (T, N, 3)
    apad = jnp.concatenate([areas, jnp.zeros((1,), areas.dtype)])
    den = jnp.take(apad, idx, axis=0).sum(axis=1)            # (N,)
    return num / jnp.where(den > 0, den, 1.0)[None, :, None]


@jax.jit
def tangential_gradient_magnitude(mesh: TriMesh, movie: jnp.ndarray
                                  ) -> jnp.ndarray:
    """|grad| after tangent-plane projection + basis expression (T, N)."""
    g = vertex_gradients(mesh, movie)
    e1 = mesh.basis[None, :, 0]
    e2 = mesh.basis[None, :, 1]
    gp = project_to_plane(g, e1, e2)
    coef = express_on_basis(gp, e1, e2)
    return jnp.sqrt(coef[..., 0] ** 2 + coef[..., 1] ** 2)


@partial(jax.jit, static_argnames=())
def wave_velocity_amplitude(mesh: TriMesh, potentials: jnp.ndarray,
                            dt: float) -> jnp.ndarray:
    """Amplitude-method wave speeds (T, N) (wave_velocity_amplitude, S5:14-58)."""
    dtime = temporal_gradient_amplitude(potentials, dt)
    return dtime / tangential_gradient_magnitude(mesh, potentials)


@partial(jax.jit, static_argnames=())
def wave_velocity_phase(mesh: TriMesh, phases: jnp.ndarray,
                        dt: float) -> jnp.ndarray:
    """Phase-method wave speeds (T, N) (wave_velocity_phase, S5:79-123)."""
    dtime = temporal_gradient_phase(phases, dt)
    return dtime / tangential_gradient_magnitude(mesh, phases)


def wave_velocity_phase_mm_per_ms(mesh: TriMesh, phases: jnp.ndarray,
                                  dt: float) -> jnp.ndarray:
    """|wave speed| / 1000 — the unit conversion + abs applied by the S5
    driver before saving (S5:311-313)."""
    return jnp.abs(wave_velocity_phase(mesh, phases, dt)) / 1000.0
