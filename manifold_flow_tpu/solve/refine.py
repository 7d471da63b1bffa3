"""Mixed-precision iterative refinement for the batched velocity solve.

The reference solves each frame exactly with SuperLU in float64
(utils/compute_optical_flow.py:143-147). The fast path here is float32;
plain f32 PCG stalls at a normalized error around
cond(A) * eps_f32 ~ 1e-3 on the ill-conditioned a1 + lambda a2 systems.
Classic fix: iterate

    r = f - A x          (float64, fem.operator)
    d = PCG_f32(A, r)    (float32 — hundreds of matvecs at full speed)
    x = x + d            (float64 accumulate)

which converges to direct-solver accuracy as long as cond(A) << 1/eps_f32.
The residual is one native-f64 matvec per outer step. (A two-float32
emulation of it, written for an accelerator without f64 units, did not
survive XLA's GPU compiler — it lost ~6 digits — and was removed.)
Requires x64 mode for the f64 inputs/outputs.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from manifold_flow_tpu.fem.operator import (
    FlowOperator,
    block_jacobi_inverse,
    make_operator,
)
from manifold_flow_tpu.solve.cg import solve_cg


# Tight-first inner tolerance schedule (see solve_refined). Chosen on an
# earlier accelerator and awaiting re-tuning on the GPU (ROADMAP C7). The
# single source of truth for every API layer (solve.api, parallel.*,
# pipeline.config) so production runs what the bench measures.
DEFAULT_INNER_TOL = (1e-3, 1e-2)


def as_inner_schedule(inner_tol) -> tuple:
    """Normalize an inner-tolerance spec to a non-empty tuple.

    Accepts a scalar (same tolerance every outer step), a tuple/list
    schedule (last entry repeats), or a 0-/1-d array — including traced
    values. Anything else (a matrix, an empty schedule) raises instead of
    silently broadcasting into per-frame-mismatched tolerances.
    """
    if isinstance(inner_tol, (tuple, list)):
        sched = tuple(inner_tol)
    elif hasattr(inner_tol, "ndim"):
        if inner_tol.ndim == 0:
            sched = (inner_tol,)
        elif inner_tol.ndim == 1:
            sched = tuple(inner_tol[i] for i in range(inner_tol.shape[0]))
        else:
            raise ValueError(
                f"inner_tol must be a scalar or 1-d schedule; got an array "
                f"of shape {inner_tol.shape}")
    else:
        sched = (inner_tol,)
    if not sched:
        raise ValueError("inner_tol schedule must be non-empty")
    return sched


class RefineResult(NamedTuple):
    x: jnp.ndarray           # (T, 2N) float64 solution
    iterations: jnp.ndarray  # () int32 — total inner CG iterations
    residual: jnp.ndarray    # (T,) final |f - A x|
    converged: jnp.ndarray   # (T,) bool
    # numpy (not jnp) default: a concrete device array evaluated at class
    # creation would initialize the XLA backend at import time, breaking
    # jax.distributed.initialize ordering for multi-host runs.
    outer_steps: jnp.ndarray = np.int32(0)  # () refinement steps executed


@partial(jax.jit, static_argnames=("lambda_", "max_iter", "refine_steps",
                                   "coarse_a1", "anchor_stride"))
def solve_refined(mesh, potentials: jnp.ndarray, times: jnp.ndarray,
                  lambda_: float = 0.01, tol: float = 1e-8,
                  inner_tol=DEFAULT_INNER_TOL, max_iter: int = 2000,
                  refine_steps: int = 8,
                  potentials_next: jnp.ndarray | None = None,
                  coarse_tables=None, coarse_a1: str = "full",
                  anchor_stride: int = 1) -> RefineResult:
    """Solve (a1_k + lambda a2) x_k = f_k for all frames to f64-grade accuracy.

    Args:
      mesh: TriMesh built in float64.
      potentials: (T, N) float64 movie.
      times: (T,) float64 frame times.
      tol: outer relative residual target |f - A x| / |f|.
      inner_tol: relative tolerance of each float32 PCG correction solve.
        The f32 recurrence residual drifts from the true residual at the
        ~cond(A) * eps_f32 ~ 1e-2 level, so the TRUE per-outer-step reduction
        saturates near that floor no matter how tightly the inner solve
        converges, so a loose inner tolerance reaches the same outer-step
        count with fewer inner iterations.
        May also be a sequence: per-outer-step tolerances (the last entry
        repeats for any further steps). The FIRST step's inner accuracy
        dominates the delivered solution error — the loosely
        solved low-mode error it leaves is nearly invisible to the residual,
        so later corrections never target it — while each later correction
        is ~1e-2 smaller than the one before, so ITS inner sloppiness
        contributes proportionally less error. Hence tight-first schedules
        such as the default (1e-3, 1e-2); loose-early schedules reproduce
        the loose-everywhere error.
      max_iter: per-inner-solve iteration cap (static).
      refine_steps: outer iteration cap (static); the loop exits as soon as
        every frame passes `tol`.
      anchor_stride: temporal warm start. With stride s > 1, first solve
        every s-th frame (plus the last) at a relaxed tolerance, linearly
        interpolate those anchor solutions over the frame index, and start
        the full-movie refinement from that iterate. Velocity fields vary
        slowly frame-to-frame (the movie oversamples the wave), so the
        interpolant starts orders of magnitude closer than zero and the
        outer loop sheds refinement steps; the anchor solve costs only
        ~1/s of a full pass per outer step. 1 disables.
    """
    if potentials.dtype != jnp.float64:
        raise ValueError(
            f"solve_refined needs float64 inputs (enable x64); got "
            f"{potentials.dtype}")
    from manifold_flow_tpu.solve.api import build_rhs

    op = make_operator(mesh, potentials, lambda_)
    f = build_rhs(mesh, op, potentials, times, potentials_next)
    x0 = None
    anchor_iters = jnp.int32(0)
    n_sys = potentials.shape[0] - 1
    if anchor_stride > 1 and n_sys > anchor_stride:
        x0, anchor_iters = _anchor_warm_start(
            mesh, op, f, n_sys, anchor_stride,
            # Anchors only need to be as accurate as the temporal
            # interpolation error they seed; tol beyond that is wasted.
            # (jnp.maximum: tol may be a traced value under jit.)
            tol=jnp.maximum(jnp.asarray(tol), 1e-4), inner_tol=inner_tol,
            max_iter=max_iter,
            refine_steps=refine_steps, coarse_tables=coarse_tables,
            coarse_a1=coarse_a1)
    res = refine_loop(mesh, op, f, tol=tol, inner_tol=inner_tol,
                      max_iter=max_iter, refine_steps=refine_steps,
                      coarse_tables=coarse_tables, coarse_a1=coarse_a1,
                      x0=x0)
    return res._replace(iterations=res.iterations + anchor_iters)


def _anchor_warm_start(mesh, op, f, n_sys: int, stride: int,
                       **refine_kwargs):
    """Solve anchor frames [0, s, 2s, ..., last], then linearly interpolate
    their solutions over the frame index into a (T, 2N) starting iterate.
    Returns (x0 f64, anchor inner-iteration count)."""
    anchors = jnp.minimum(jnp.arange(0, n_sys + stride - 1, stride),
                          n_sys - 1)                       # includes last
    op_a = dataclasses.replace(op, g=op.g[anchors])
    res_a = refine_loop(mesh, op_a, f[anchors], **refine_kwargs)
    xa = res_a.x                                           # (A, 2N) f64
    # Piecewise-linear in the frame index (frames are uniformly sampled;
    # index interpolation == time interpolation).
    k = jnp.arange(n_sys)
    pos = k / stride
    i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, xa.shape[0] - 1)
    i1 = jnp.minimum(i0 + 1, xa.shape[0] - 1)
    w = (pos - i0).astype(xa.dtype)[:, None]
    # The last anchor sits at frame n_sys-1, not i0*stride: rescale the
    # final segment's weight so interpolation stays exact at both ends.
    seg_len = jnp.where(i1 * stride > n_sys - 1,
                        jnp.maximum((n_sys - 1) - i0 * stride, 1), stride)
    w = jnp.where((i1 * stride > n_sys - 1)[:, None],
                  ((k - i0 * stride) / seg_len).astype(xa.dtype)[:, None], w)
    x0 = (1.0 - w) * xa[i0] + w * xa[i1]
    return x0, res_a.iterations


def refine_loop(mesh, op: FlowOperator, f, tol: float = 1e-8,
                inner_tol=DEFAULT_INNER_TOL, max_iter: int = 2000,
                refine_steps: int = 8, coarse_tables=None,
                coarse_a1: str = "full", x0=None) -> RefineResult:
    """The refinement iteration given a prebuilt f64 operator + RHS.

    Factored out so parallel.partition can run it inside a shard_map with
    the frame axis sharded (frames are independent systems — each shard
    iterates until its own frames converge). `x0` (an f64 iterate, e.g.
    the temporal warm start of solve_refined) replaces the zero start."""
    # Float32 operator + preconditioner for the inner solves: the f64
    # operator rounded to f32.
    f32 = jnp.float32
    op32 = dataclasses.replace(
        op, blocks2=op.blocks2.astype(f32), g=op.g.astype(f32),
        w_scale=op.w_scale.astype(f32), lambda_=op.lambda_.astype(f32))
    if coarse_tables is not None:
        from manifold_flow_tpu.solve.coarse import make_two_level

        pre32 = make_two_level(mesh, op32.g, op32.lambda_, coarse_tables,
                               a1_mode=coarse_a1)
    else:
        pre32 = block_jacobi_inverse(mesh, op32.g, op32.lambda_)

    fnorm = jnp.linalg.norm(f, axis=-1)
    target = tol * jnp.maximum(fnorm, jnp.finfo(f32).tiny)

    # Per-outer-step inner tolerances (scalar = same every step; the last
    # entry repeats past the end of a schedule).
    sched = jnp.stack([jnp.asarray(t, f32)
                       for t in as_inner_schedule(inner_tol)])

    def cond(state):
        _, r, _, step = state
        rn = jnp.linalg.norm(r, axis=-1)
        return (step < refine_steps) & jnp.any(rn > target)

    def body(state):
        x, r, total_iters, step = state
        step_tol = sched[jnp.minimum(step, sched.shape[0] - 1)]
        inner = solve_cg(op32, r.astype(f32), precond=pre32, tol=step_tol,
                         max_iter=max_iter)
        x = x + inner.x.astype(x.dtype)
        r = f - op.matvec(x)
        return x, r, total_iters + inner.iterations, step + 1

    if x0 is None:
        start, r_start = jnp.zeros_like(f), f
    else:
        start, r_start = x0, f - op.matvec(x0)
    x, r, total_iters, steps = jax.lax.while_loop(
        cond, body, (start, r_start, jnp.int32(0), jnp.int32(0)))

    rn = jnp.linalg.norm(r, axis=-1)
    return RefineResult(x=x, iterations=total_iters, residual=rn,
                        converged=rn <= target, outer_steps=steps)
