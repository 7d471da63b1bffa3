"""Spatiotemporal SVD mode decomposition of velocity movies.

Covers both reference variants:
  * complex form V1 + i V2 (S4_spatiotemporal_decomposition_ComplexMatrices
    .py:19-46, 187) — `decompose_complex`;
  * concatenated real form [Re | Im] (S4_..._ConcatMatrices .py:174-197) —
    `decompose_concat`.
Includes the mode-energy percentages (calculate_percentages) and the
sign-fixing convention (negate modes whose mean real temporal coefficient is
negative, ComplexMatrices:206-213).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from manifold_flow_tpu.ops.recombine import velocity_to_complex


class SVDModes(NamedTuple):
    u: jnp.ndarray            # (T, K) temporal modes
    sigma: jnp.ndarray        # (K,) singular values
    vt: jnp.ndarray           # (K, N) or (K, 2N) spatial modes
    pct: jnp.ndarray          # (K,) sigma / sum(sigma) * 100
    pct_squared: jnp.ndarray  # (K,) sigma^2 / sum(sigma^2) * 100


def mode_percentages(sigma: jnp.ndarray):
    """(pct, pct^2) rounded to 2 decimals (calculate_percentages,
    ComplexMatrices:126-142)."""
    s2 = jnp.square(sigma)
    pct = jnp.round(sigma / jnp.sum(sigma) * 100.0, 2)
    pct2 = jnp.round(s2 / jnp.sum(s2) * 100.0, 2)
    return pct, pct2


def fix_signs(u: jnp.ndarray, vt: jnp.ndarray, n_modes: int):
    """Negate leading modes whose mean Re(U) is negative
    (ComplexMatrices:206-213, ConcatMatrices:190-192)."""
    neg = jnp.mean(jnp.real(u[:, :n_modes]), axis=0) < 0
    u_fixed = u.at[:, :n_modes].multiply(jnp.where(neg, -1.0, 1.0))
    vt_fixed = vt.at[:n_modes].multiply(jnp.where(neg, -1.0, 1.0)[:, None])
    return u_fixed, vt_fixed


@partial(jax.jit, static_argnames=("n_modes",))
def _svd_complex(v_k: jnp.ndarray, n_modes: int | None):
    movie = velocity_to_complex(v_k)
    u, s, vt = jnp.linalg.svd(movie, full_matrices=False)
    k = s.shape[0] if n_modes is None else n_modes
    u, vt = fix_signs(u, vt, k)
    pct, pct2 = mode_percentages(s)
    return SVDModes(u[:, :k], s[:k], vt[:k], pct[:k], pct2[:k])


def decompose_complex(v_k: jnp.ndarray, n_modes: int | None = None) -> SVDModes:
    """SVD of the complex movie (T, N) = V1 + i V2 (exact LAPACK-class SVD,
    one jitted program)."""
    return _svd_complex(jnp.asarray(v_k), n_modes)


@partial(jax.jit, static_argnames=("n_modes",))
def _svd_concat(v_k: jnp.ndarray, n_modes: int | None):
    u, s, vt = jnp.linalg.svd(v_k, full_matrices=False)
    k = s.shape[0] if n_modes is None else n_modes
    u, vt = fix_signs(u, vt, k)
    pct, pct2 = mode_percentages(s)
    return SVDModes(u[:, :k], s[:k], vt[:k], pct[:k], pct2[:k])


def decompose_concat(v_k: jnp.ndarray, n_modes: int | None = None) -> SVDModes:
    """SVD of the real concatenated movie (T, 2N) = [Re | Im] (exact SVD,
    one jitted program)."""
    return _svd_concat(jnp.asarray(v_k), n_modes)


def concat_modes_to_complex(vt: jnp.ndarray) -> jnp.ndarray:
    """Concat spatial modes (K, 2N) -> complex (K, N)
    (ConcatMatrices:194-197)."""
    n = vt.shape[-1] // 2
    return vt[..., :n] + 1j * vt[..., n:]


def mode_to_world(sigma_vt: jnp.ndarray, e: jnp.ndarray) -> jnp.ndarray:
    """Complex spatial mode (..., N) -> world vectors (..., N, 3)
    (calculate_V_k_from_complex, ComplexMatrices:49-69)."""
    return (jnp.real(sigma_vt)[..., None] * e[:, 0]
            + jnp.imag(sigma_vt)[..., None] * e[:, 1])
