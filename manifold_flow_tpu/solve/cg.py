"""Batched preconditioned conjugate gradients, matrix-free.

All frames solve simultaneously: the iterate is (T, 2N) and every CG
primitive (matvec, axpy, dot) is batched over the frame axis, so the device
sees a handful of large fused kernels per iteration instead of the reference's
one-process-per-frame SuperLU factorizations
(utils/compute_optical_flow.py:152-194). Iteration stops when every frame's
preconditioned residual passes the tolerance (converged frames keep iterating
harmlessly — uniform control flow is cheaper than masking).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from manifold_flow_tpu.fem.operator import FlowOperator, apply_block_diag


class CGResult(NamedTuple):
    x: jnp.ndarray          # (T, 2N) solution
    iterations: jnp.ndarray  # () int32 — iterations executed
    residual: jnp.ndarray   # (T,) final absolute residual norm |f - A x|
    converged: jnp.ndarray  # (T,) bool


def _dot(a: jnp.ndarray, b: jnp.ndarray, precise: bool,
         psum_axis: str | None = None) -> jnp.ndarray:
    """Per-frame dot products (T,), optionally accumulated in float64.

    `precise=True` upcasts the reduction to float64 (requires x64 mode; a
    tiny fraction of the iteration cost) and casts back to the compute
    dtype. With `psum_axis`
    (mesh-partitioned DOF vectors, parallel.halo) the local partial sums
    combine over the named axis.
    """
    if precise and a.dtype != jnp.float64:
        acc = jnp.sum(a.astype(jnp.float64) * b.astype(jnp.float64), axis=-1)
        out = acc.astype(a.dtype)
    else:
        out = jnp.sum(a * b, axis=-1)
    if psum_axis is not None:
        out = jax.lax.psum(out, psum_axis)
    return out


@partial(jax.jit, static_argnames=("max_iter", "precise_dots", "psum_axis"))
def solve_cg(operator: FlowOperator, f: jnp.ndarray,
             precond: jnp.ndarray | None = None, tol: float = 1e-10,
             max_iter: int = 2000, precise_dots: bool = False,
             psum_axis: str | None = None) -> CGResult:
    """Solve A_k x_k = f_k for all frames k with PCG.

    Args:
      operator: batched FlowOperator (T frames), or any object with a
        `.matvec(x)` method over the same layout (parallel.halo.HaloOperator).
      f: (T, 2N) right-hand sides.
      precond: optional (T, N, 2, 2) inverted block-Jacobi blocks, or any
        object with an `.apply(r)` method (e.g. solve.coarse.TwoLevelPrecond).
      tol: relative tolerance on |r| / |f| per frame.
      max_iter: iteration cap (static).
      psum_axis: named mesh axis when f/x hold only this shard's owned DOF
        block — dot products psum over it so every shard sees global norms.
    """
    fnorm = jnp.sqrt(_dot(f, f, precise_dots, psum_axis))
    target = tol * jnp.maximum(fnorm, jnp.finfo(f.dtype).tiny)

    def apply_m(r):
        if precond is None:
            return r
        if hasattr(precond, "apply"):
            return precond.apply(r)
        return apply_block_diag(precond, r)

    x0 = jnp.zeros_like(f)
    r0 = f
    z0 = apply_m(r0)
    p0 = z0
    rz0 = _dot(r0, z0, precise_dots, psum_axis)

    def cond(state):
        _, r, _, _, _, it = state
        rn = jnp.sqrt(_dot(r, r, precise_dots, psum_axis))
        return (it < max_iter) & jnp.any(rn > target)

    def body(state):
        x, r, z, p, rz, it = state
        ap = operator.matvec(p)
        pap = _dot(p, ap, precise_dots, psum_axis)
        alpha = rz / jnp.where(pap != 0, pap, 1.0)
        alpha = jnp.where(pap != 0, alpha, 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = apply_m(r)
        rz_new = _dot(r, z, precise_dots, psum_axis)
        beta = rz_new / jnp.where(rz != 0, rz, 1.0)
        beta = jnp.where(rz != 0, beta, 0.0)
        p = z + beta[:, None] * p
        return x, r, z, p, rz_new, it + 1

    x, r, _, _, _, it = jax.lax.while_loop(
        cond, body, (x0, r0, z0, p0, rz0, jnp.int32(0))
    )
    rn = jnp.sqrt(_dot(r, r, precise_dots, psum_axis))
    return CGResult(x=x, iterations=it, residual=rn, converged=rn <= target)
