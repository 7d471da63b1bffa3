"""Velocity DOF recombination: (T, 2N) -> world vectors / complex form.

Replaces the reference's Python double loops `process_V_k`
(utils/find_singularity_point.py:28-69, duplicated at
utils/draw_optical_flow_field.py:33-71) and `process_V_k_to_complex`
(S4_spatiotemporal_decomposition_ComplexMatrices .py:19-46) with einsums.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 contractions run at full f32 precision (no TF32 on GPUs).
_HIGHEST = jax.lax.Precision.HIGHEST


def split_components(v_k: jnp.ndarray) -> jnp.ndarray:
    """(..., 2N) DOFs -> (..., N, 2) per-vertex tangent coefficients."""
    n = v_k.shape[-1] // 2
    return jnp.stack([v_k[..., :n], v_k[..., n:]], axis=-1)


def velocity_to_world(v_k: jnp.ndarray, e: jnp.ndarray) -> jnp.ndarray:
    """(..., 2N) DOFs + bases e (N, 2, 3) -> world vectors (..., N, 3)."""
    c = split_components(v_k)
    return jnp.einsum("...na,nad->...nd", c, e, precision=_HIGHEST)


def velocity_to_complex(v_k: jnp.ndarray) -> jnp.ndarray:
    """(..., 2N) DOFs -> complex (..., N) = V1 + i V2 (S4 complex form)."""
    n = v_k.shape[-1] // 2
    return jax_lax_complex(v_k[..., :n], v_k[..., n:])


def jax_lax_complex(re, im):
    return re + 1j * im


def world_speed(v_world: jnp.ndarray) -> jnp.ndarray:
    """Per-vertex speed magnitude: the optical-flow wave-speed map (C12,
    S3_compute_v_and_detection_singularity.py:127-137)."""
    return jnp.linalg.norm(v_world, axis=-1)
