"""Tangent-space primitives, vectorized over vertices and frames.

The reference implements these as per-vertex Python functions, duplicated in
five modules (reference: utils/compute_optical_flow.py:210-235,
utils/find_singularity_point.py:193-314, S5_compute_wave_v.py:173-250,
S6_streamline.py:140-182, S7_winding_line.py:12-57). Here each is a single
batched jnp function applied over leading axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 contractions run at full f32 precision (no TF32 on GPUs).
_HIGHEST = jax.lax.Precision.HIGHEST


def tangent_basis(normals: jnp.ndarray) -> jnp.ndarray:
    """Orthonormal tangent basis e (..., 2, 3) for unit normals (..., 3).

    Matches the reference construction (utils/compute_optical_flow.py:210-235):
      e1 = normalize([-ny, nx, 0])     if nx != 0 or ny != 0
           normalize([0, -nz, ny])     otherwise
      e2 = normalize(cross(n, e1))
    """
    n = jnp.asarray(normals)
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    zeros = jnp.zeros_like(nx)
    cond = (nx != 0) | (ny != 0)
    e1_a = jnp.stack([-ny, nx, zeros], axis=-1)
    e1_b = jnp.stack([zeros, -nz, ny], axis=-1)
    e1 = jnp.where(cond[..., None], e1_a, e1_b)
    # Guard: a fully zero normal would produce 0/0; emit zeros instead of NaN.
    n1 = jnp.linalg.norm(e1, axis=-1, keepdims=True)
    e1 = jnp.where(n1 > 0, e1 / jnp.where(n1 > 0, n1, 1.0), 0.0)
    e2 = jnp.cross(n, e1)
    n2 = jnp.linalg.norm(e2, axis=-1, keepdims=True)
    e2 = jnp.where(n2 > 0, e2 / jnp.where(n2 > 0, n2, 1.0), 0.0)
    return jnp.stack([e1, e2], axis=-2)


def project_to_plane(v: jnp.ndarray, e1: jnp.ndarray, e2: jnp.ndarray) -> jnp.ndarray:
    """Project vectors v (..., 3) onto the plane spanned by (e1, e2).

    Matches reference `project_vector_to_plane`
    (utils/find_singularity_point.py:193-211): remove the component along
    n = cross(e1, e2), without assuming n is unit.
    """
    n = jnp.cross(e1, e2)
    nn = jnp.sum(n * n, axis=-1, keepdims=True)
    vn = jnp.sum(v * n, axis=-1, keepdims=True) / jnp.where(nn > 0, nn, 1.0)
    return v - jnp.where(nn > 0, vn, 0.0) * n


def express_on_basis(v: jnp.ndarray, e1: jnp.ndarray, e2: jnp.ndarray) -> jnp.ndarray:
    """Coefficients (..., 2) of v on the (possibly non-unit) basis (e1, e2).

    Matches reference `express_vector_on_basis`
    (utils/find_singularity_point.py:244-269): alpha = v.e1/e1.e1, beta
    likewise; components are computed independently (valid because the bases
    produced by `tangent_basis` are orthonormal).
    """
    a = jnp.sum(v * e1, axis=-1) / jnp.sum(e1 * e1, axis=-1)
    b = jnp.sum(v * e2, axis=-1) / jnp.sum(e2 * e2, axis=-1)
    return jnp.stack([a, b], axis=-1)


def position_diff_on_basis(a: jnp.ndarray, b: jnp.ndarray,
                           e1: jnp.ndarray, e2: jnp.ndarray) -> jnp.ndarray:
    """(u, v) coords of point b relative to point a in the (e1, e2) plane.

    Matches reference `position_diff_on_basis_with_origin`
    (utils/find_singularity_point.py:215-241): project (b - a) onto the
    tangent plane, then take dot products with the basis vectors.
    """
    rel = b - a
    proj = project_to_plane(rel, e1, e2)
    u = jnp.sum(proj * e1, axis=-1)
    v = jnp.sum(proj * e2, axis=-1)
    return jnp.stack([u, v], axis=-1)


def recombine_tangent(coeffs: jnp.ndarray, e: jnp.ndarray) -> jnp.ndarray:
    """Tangent coefficients (..., N, 2) + bases e (N, 2, 3) -> 3-D (..., N, 3).

    One einsum replacing the reference's per-point double loop `process_V_k`
    (utils/find_singularity_point.py:28-69, duplicated in
    utils/draw_optical_flow_field.py:33-71).
    """
    return jnp.einsum("...na,nad->...nd", coeffs, e, precision=_HIGHEST)
