"""On-device RBF interpolation: electrode samples -> surface vertices.

Replaces the reference's per-frame `scipy.interpolate.Rbf` fit + eval loop
(S2_interpolate.py:22-53, S2_interpolate_phases.py:22-56). The kernel system
is one small dense ExE solve and an ExN evaluation, and all
frames share the same electrode geometry, so the kernel matrix is factorized
once and every frame is solved as one multi-RHS triangular solve (the
reference refits the RBF from scratch every frame).

Parity: scipy's Rbf defaults — multiquadric kernel sqrt((r/eps)^2 + 1),
epsilon = (prod(nonzero bbox edges)/n)^(1/dim), smooth = 0.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def scipy_default_epsilon(coords: jnp.ndarray) -> jnp.ndarray:
    """scipy.interpolate.Rbf's default epsilon ("average distance between
    nodes" from the bounding-box volume)."""
    hi = jnp.max(coords, axis=0)
    lo = jnp.min(coords, axis=0)
    edges = hi - lo
    nz = edges != 0
    prod = jnp.prod(jnp.where(nz, edges, 1.0))
    dim = jnp.sum(nz)
    return jnp.power(prod / coords.shape[0], 1.0 / jnp.maximum(dim, 1))


def _kernel(r: jnp.ndarray, epsilon: jnp.ndarray, kind: str) -> jnp.ndarray:
    if kind == "multiquadric":
        return jnp.sqrt((r / epsilon) ** 2 + 1.0)
    if kind == "inverse_multiquadric":
        return 1.0 / jnp.sqrt((r / epsilon) ** 2 + 1.0)
    if kind == "gaussian":
        return jnp.exp(-((r / epsilon) ** 2))
    if kind == "linear":
        return r
    if kind == "thin_plate":
        return jnp.where(r > 0, r ** 2 * jnp.log(jnp.where(r > 0, r, 1.0)), 0.0)
    raise ValueError(f"unknown RBF kind: {kind!r}")


def _pairwise_dist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    d2 = jnp.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
    return jnp.sqrt(jnp.maximum(d2, 0.0))


@partial(jax.jit, static_argnames=("kind",))
def rbf_interpolate_phases(coords: jnp.ndarray, phi: jnp.ndarray,
                           targets: jnp.ndarray,
                           epsilon: jnp.ndarray | None = None,
                           smooth: float = 0.0, kind: str = "multiquadric"
                           ) -> jnp.ndarray:
    """Phase interpolation: e^{i phi} -> complex RBF -> angle, in one
    compiled program (S2_interpolate_phases.py:52-56,177-182). phi (T, E)
    real -> (T, P) real angles.
    """
    values = jax.lax.complex(jnp.cos(phi), jnp.sin(phi))
    out = _rbf_solve(coords, values, targets, epsilon, smooth, kind)
    return jnp.arctan2(out.imag, out.real)


@partial(jax.jit, static_argnames=("kind",))
def rbf_interpolate(coords: jnp.ndarray, values: jnp.ndarray,
                    targets: jnp.ndarray, epsilon: jnp.ndarray | None = None,
                    smooth: float = 0.0, kind: str = "multiquadric"
                    ) -> jnp.ndarray:
    """Interpolate values (T, E) sampled at coords (E, 3) onto targets (P, 3).

    Returns (T, P). Complex `values` are supported (the phases pipeline
    interpolates e^{i phi}, S2_interpolate_phases.py:177-182): the real kernel
    system is solved once with complex right-hand sides.
    """
    return _rbf_solve(coords, values, targets, epsilon, smooth, kind)


def _rbf_solve(coords, values, targets, epsilon, smooth, kind):
    if epsilon is None:
        epsilon = scipy_default_epsilon(coords)
    a = _kernel(_pairwise_dist(coords, coords), epsilon, kind)
    a = a - smooth * jnp.eye(coords.shape[0], dtype=a.dtype)
    b = _kernel(_pairwise_dist(targets, coords), epsilon, kind)   # (P, E)
    # Exact LU in the kernel matrix's own dtype: ill-conditioned RBF kernels
    # (large dense grids) need the full f64 factorization for scipy parity.
    lu, piv = jax.scipy.linalg.lu_factor(a)
    hi = jax.lax.Precision.HIGHEST

    def solve(rhs):
        return jax.scipy.linalg.lu_solve((lu, piv), rhs.astype(a.dtype)
                                         ).astype(rhs.dtype)

    if jnp.iscomplexobj(values):
        # Real matmuls + one final lax.complex: the kernel system is real,
        # so the real and imaginary planes solve independently.
        rdt = values.real.dtype
        w_re = solve(values.real.T)                               # (E, T)
        w_im = solve(values.imag.T)
        b_r = b.astype(rdt)
        return jax.lax.complex(
            jnp.matmul(b_r, w_re.astype(rdt), precision=hi).T,
            jnp.matmul(b_r, w_im.astype(rdt), precision=hi).T)
    return jnp.matmul(b, solve(values.T), precision=hi).T
