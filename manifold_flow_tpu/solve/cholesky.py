"""Batched dense Cholesky with mixed-precision iterative refinement.

The exact-solve path for small meshes (the reference's ~3.1k-vertex cortical
patches give 2N ~= 6.2k DOFs; a dense (2N)^2 matrix is ~150 MB in f32, and
Cholesky factorization is dense matrix work). Frames are
processed in chunks via `lax.map` to bound peak memory; optional iterative
refinement recovers near-f64 forward error using the matrix-free operator for
high-precision residuals.

Replaces `spsolve` (SuperLU) at utils/compute_optical_flow.py:143-147.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from manifold_flow_tpu.fem import assembly
from manifold_flow_tpu.fem.operator import FlowOperator
from manifold_flow_tpu.geometry.mesh import TriMesh


def _chol_solve(a: jnp.ndarray, b: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Cholesky factor + solve for one (2N, 2N) system; b is (2N,)."""
    chol = jnp.linalg.cholesky(a)
    y = jax.scipy.linalg.solve_triangular(chol, b, lower=True)
    x = jax.scipy.linalg.solve_triangular(chol.T, y, lower=False)
    return chol, x


@partial(jax.jit, static_argnames=("refine_steps", "batch_size", "factor_dtype"))
def solve_cholesky(mesh: TriMesh, operator: FlowOperator, f: jnp.ndarray,
                   refine_steps: int = 2, batch_size: int = 4,
                   factor_dtype=jnp.float32) -> jnp.ndarray:
    """Solve all frames by dense Cholesky (+ refinement). Returns (T, 2N).

    The factorization runs in `factor_dtype` (f32 by default); residuals
    for refinement are computed matrix-free in the operator's dtype (f64 when
    x64 is enabled), the classic mixed-precision refinement scheme.
    """
    a2d = assembly.dense_a2(mesh).astype(factor_dtype)
    lam = operator.lambda_.astype(factor_dtype)
    t = f.shape[0]
    pad = (-t) % batch_size
    g_pad = jnp.pad(operator.g, ((0, pad), (0, 0), (0, 0), (0, 0)))
    f_pad = jnp.pad(f, ((0, pad), (0, 0)))

    def solve_one(args):
        g_k, f_k = args
        b1 = assembly.a1_blocks(mesh, g_k[None].astype(factor_dtype))[0]
        a = lam * a2d + assembly.scatter_dense(mesh, b1)
        chol, x = _chol_solve(a, f_k.astype(factor_dtype))
        x = x.astype(f.dtype)

        def refine(_, x):
            # High-precision residual via the (cheap) matrix-free operator.
            op_k = FlowOperator(
                dof=operator.dof, blocks2=operator.blocks2,
                g=g_k[None], w_scale=operator.w_scale,
                lambda_=operator.lambda_, n_dof=operator.n_dof,
            )
            r = f_k - op_k.matvec(x[None])[0]
            y = jax.scipy.linalg.solve_triangular(
                chol, r.astype(factor_dtype), lower=True)
            d = jax.scipy.linalg.solve_triangular(chol.T, y, lower=False)
            return x + d.astype(f.dtype)

        return jax.lax.fori_loop(0, refine_steps, refine, x)

    n_chunks = (t + pad) // batch_size
    g_c = g_pad.reshape(n_chunks, batch_size, *operator.g.shape[1:])
    f_c = f_pad.reshape(n_chunks, batch_size, -1)

    def chunk(args):
        return jax.vmap(lambda gk, fk: solve_one((gk, fk)))(*args)

    out = jax.lax.map(chunk, (g_c, f_c))
    return out.reshape(t + pad, -1)[:t]
