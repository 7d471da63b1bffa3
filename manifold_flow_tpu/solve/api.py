"""High-level velocity-field API.

`compute_velocity_fields` is the batched equivalent of the reference pipeline
compute_geometrical_quantities -> compute_velocity_field
(utils/compute_optical_flow.py:27-194): one call solves every frame of a
potentials movie and returns the velocity DOFs in the reference's layout
(T-1, 2N) (dof = vertex + N * alpha), so downstream artifacts interoperate.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from manifold_flow_tpu.fem import assembly
from manifold_flow_tpu.fem.operator import (
    FlowOperator,
    block_jacobi_inverse,
    make_operator,
)
from manifold_flow_tpu.geometry.mesh import TriMesh
from manifold_flow_tpu.solve.cg import solve_cg
from manifold_flow_tpu.solve.cholesky import solve_cholesky
from manifold_flow_tpu.solve.refine import DEFAULT_INNER_TOL


# precond='auto' crossover: the two-level coarse correction beats plain
# block-Jacobi once Jacobi iteration counts outgrow the coarse build cost.
# The value was chosen on an earlier accelerator and awaits re-tuning on
# the GPU (ROADMAP C7).
TWO_LEVEL_MIN_VERTICES = 6000


class VelocityResult(NamedTuple):
    v_k: jnp.ndarray         # (T-1, 2N) velocity DOFs
    e: jnp.ndarray           # (N, 2, 3) tangent bases
    iterations: jnp.ndarray  # () CG iterations (0 for direct solves)
    residual: jnp.ndarray    # (T-1,) final |f - A x| per frame
    converged: jnp.ndarray   # (T-1,) bool per frame
    # () outer refinement steps (method='refined'; 0 otherwise). A numpy
    # default: a device array built at import would initialize the backend.
    outer_steps: jnp.ndarray = np.int32(0)


def _chunked_velocity_fields(mesh: TriMesh, potentials, times,
                             chunk: int, kwargs: dict) -> VelocityResult:
    """Long-movie solve as contiguous (chunk+1)-frame windows sequenced by
    ONE lax.map program (see compute_velocity_fields(frame_chunk=...)).

    The last window shifts back to end exactly at the movie's end; its
    overlap re-solves a few frames whose duplicates are dropped at
    assembly. Each chunk runs the full solver (its own convergence loop),
    so per-chunk iteration counts differ — `iterations` and `outer_steps`
    report the max."""
    import jax

    t_v = potentials.shape[0] - 1
    c = int(chunk)
    n_chunks = -(-t_v // c)
    starts = np.minimum(np.arange(n_chunks) * c, t_v - c).astype(np.int32)

    def body(s):
        p_c = jax.lax.dynamic_slice_in_dim(potentials, s, c + 1, 0)
        t_c = jax.lax.dynamic_slice_in_dim(times, s, c + 1, 0)
        res = compute_velocity_fields(mesh, p_c, t_c, frame_chunk=None,
                                      **kwargs)
        return (res.v_k, res.iterations, res.residual, res.converged,
                jnp.asarray(res.outer_steps, jnp.int32))

    v, iters, resid, conv, outer = jax.lax.map(body, jnp.asarray(starts))
    # Frame k comes from chunk j = min(k // c, n_chunks - 1) at local
    # offset k - starts[j] — static indices, one constant-index gather.
    k = np.arange(t_v)
    cj = np.minimum(k // c, n_chunks - 1)
    lo = jnp.asarray((k - starts[cj]).astype(np.int32))
    cj = jnp.asarray(cj.astype(np.int32))
    return VelocityResult(v[cj, lo], mesh.basis, jnp.max(iters),
                          resid[cj, lo], conv[cj, lo], jnp.max(outer))


def build_rhs(mesh: TriMesh, operator: FlowOperator, potentials: jnp.ndarray,
              times: jnp.ndarray, potentials_next: jnp.ndarray | None = None
              ) -> jnp.ndarray:
    """RHS f (T-1, 2N). `potentials_next` supports the reference's optional
    second movie I_k_2 (worker args at utils/compute_optical_flow.py:174-176);
    it defaults to `potentials`."""
    nxt = potentials if potentials_next is None else potentials_next
    dt = (times[1:] - times[:-1])[:, None]
    di = (nxt[1:] - potentials[:-1]) / dt
    return assembly.rhs_vector(mesh, operator.g, di)


# Frame-chunked solving for long movies (see compute_velocity_fields):
# movies longer than FRAME_CHUNK_AUTO_MIN velocity frames solve in chunks of
# FRAME_CHUNK_SIZE (frame_chunk='auto'). Both values were chosen on an
# earlier accelerator and await re-tuning on the GPU (ROADMAP C7).
FRAME_CHUNK_SIZE = 104
FRAME_CHUNK_AUTO_MIN = 160


def compute_velocity_fields(
    mesh: TriMesh,
    potentials: jnp.ndarray,
    times: jnp.ndarray,
    lambda_: float = 0.01,
    method: str = "cg",
    tol: float = 1e-10,
    max_iter: int = 2000,
    precise_dots: bool = False,
    refine_steps: int = 2,
    batch_size: int = 4,
    potentials_next: jnp.ndarray | None = None,
    precond: str = "auto",
    coarse_passes: int | None = None,
    coarse_a1: str = "full",
    inner_tol=DEFAULT_INNER_TOL,
    anchor_stride: int = 1,
    frame_chunk="auto",
) -> VelocityResult:
    """Solve (a1_k + lambda a2) V_k = f_k for every frame k.

    Args:
      mesh: TriMesh (geometry precompute happens at mesh construction).
      potentials: (T, N) scalar field movie (interpolated potentials/phases).
      times: (T,) frame times in seconds (the reference's t_k, S3:86-89).
      lambda_: regularization weight (config.yaml:3, default 0.01).
      method: 'cg' (batched matrix-free PCG), 'cholesky' (batched dense
        direct solve with iterative refinement), 'refined' (f32 inner PCG +
        f64 residuals; needs float64 inputs), or 'auto' (refined on
        accelerators with f64 inputs, else cg).
      precond: 'two_level' (block-Jacobi + aggregation coarse correction,
        solve.coarse), 'jacobi', or 'auto'. 'auto' picks two_level for large
        meshes and jacobi for small ones (TWO_LEVEL_MIN_VERTICES):
        Jacobi-PCG iteration counts grow with mesh refinement while the
        coarse correction keeps them ~flat; below the crossover the coarse
        build outweighs the saved iterations. Falls back to jacobi if the
        mesh topology is traced (aggregation is a host-side precompute).
      coarse_passes: greedy-aggregation passes for the coarse space (~5-7x
        coarsening per pass); None (default) auto-deepens until the coarse
        space is at most solve.coarse.MAX_COARSE_SIZE aggregates, keeping the
        per-iteration dense coarse correction scale-free.
      coarse_a1: data term carried by the coarse matrices — 'full' (exact
        per-frame), 'mean' (time-averaged, one shared coarse matrix; cheaper
        build/apply, mildly more iterations), or 'none' (regularization only;
        weak — kept for experiments).
      inner_tol: (refined method) relative tolerance of each f32 inner PCG
        solve; the true per-outer-step reduction floors at ~cond * eps_f32,
        so 1e-3 matches 1e-5's outer-step count with ~45% fewer iterations
        (see solve.refine.solve_refined). A sequence gives per-outer-step
        tolerances (last entry repeats). The FIRST step's inner accuracy
        dominates the delivered solution error (its low-mode error is
        invisible to later residual corrections), while later corrections
        are ~1e-2 smaller each step, so their sloppiness contributes
        proportionally less — hence the tight-first default (1e-3, 1e-2).
      anchor_stride: (refined method) temporal warm start: solve every
        s-th frame first and start the full solve from the time-interpolated
        anchors. 1 (default) disables.
      frame_chunk: 'auto' (default) solves movies longer than
        FRAME_CHUNK_AUTO_MIN velocity frames in FRAME_CHUNK_SIZE-frame chunks
        sequenced by one lax.map program (the reference's real trials span up
        to ~391 frames); a positive int forces that chunk size; None disables.
        Frames are independent, so results match the unchunked solve to the
        requested tolerance.
    """
    potentials = jnp.asarray(potentials)
    times = jnp.asarray(times, dtype=potentials.dtype)
    if potentials.ndim != 2 or potentials.shape[1] != mesh.n_vertices:
        raise ValueError(
            f"potentials must be (T, N={mesh.n_vertices}); got {potentials.shape}"
            " — out-of-range vertex gathers would otherwise clamp silently")
    if times.shape != (potentials.shape[0],):
        raise ValueError(
            f"times must be ({potentials.shape[0]},) to match the movie; "
            f"got {times.shape}")
    if potentials.shape[0] < 2:
        raise ValueError("need at least 2 frames to form a velocity field")

    # Long movies solve in frame chunks sequenced by ONE lax.map program,
    # which bounds the per-program frame axis. Frames are independent
    # systems; each chunk converges to the same tolerance.
    t_v = potentials.shape[0] - 1
    if frame_chunk == "auto":
        chunk = (FRAME_CHUNK_SIZE
                 if t_v > FRAME_CHUNK_AUTO_MIN and potentials_next is None
                 else None)
    elif frame_chunk is None:
        chunk = None
    elif (isinstance(frame_chunk, (int, np.integer))
          and not isinstance(frame_chunk, bool) and frame_chunk > 0):
        chunk = int(frame_chunk)
    else:
        raise ValueError(f"frame_chunk must be a positive int, 'auto' or "
                         f"None; got {frame_chunk!r}")
    if chunk and t_v > chunk and potentials_next is None:
        return _chunked_velocity_fields(
            mesh, potentials, times, int(chunk), dict(
                lambda_=lambda_, method=method, tol=tol, max_iter=max_iter,
                precise_dots=precise_dots, refine_steps=refine_steps,
                batch_size=batch_size, precond=precond,
                coarse_passes=coarse_passes, coarse_a1=coarse_a1,
                inner_tol=inner_tol, anchor_stride=anchor_stride))
    if method == "auto":
        import jax

        on_accelerator = jax.devices()[0].platform != "cpu"
        method = ("refined" if on_accelerator
                  and potentials.dtype == jnp.float64 else "cg")

    tables = None
    if precond not in ("jacobi", "two_level", "auto"):
        raise ValueError(f"unknown precond: {precond!r}")
    if precond == "auto" and mesh.n_vertices < TWO_LEVEL_MIN_VERTICES:
        precond = "jacobi"
    if precond != "jacobi" and method in ("refined", "cg"):
        from manifold_flow_tpu.solve import coarse

        try:
            tables = coarse.build_tables(mesh, passes=coarse_passes)
        except Exception:
            if precond == "two_level":
                raise
            tables = None  # traced mesh: aggregation needs concrete topology

    if method == "refined":
        from manifold_flow_tpu.solve.refine import solve_refined

        if potentials.dtype != jnp.float64:
            raise ValueError(
                "method='refined' needs float64 potentials (enable x64 and "
                f"pass float64 inputs); got {potentials.dtype}")
        res = solve_refined(mesh, potentials, times, lambda_=lambda_,
                            tol=tol, max_iter=max_iter,
                            inner_tol=inner_tol, anchor_stride=anchor_stride,
                            potentials_next=potentials_next,
                            coarse_tables=tables, coarse_a1=coarse_a1)
        return VelocityResult(res.x, mesh.basis, res.iterations,
                              res.residual, res.converged, res.outer_steps)

    op = make_operator(mesh, potentials, lambda_)
    f = build_rhs(mesh, op, potentials, times, potentials_next)

    if method == "cg":
        if tables is not None:
            from manifold_flow_tpu.solve.coarse import make_two_level

            pre = make_two_level(mesh, op.g, op.lambda_, tables,
                                 a1_mode=coarse_a1)
        else:
            pre = block_jacobi_inverse(mesh, op.g, lambda_)
        res = solve_cg(op, f, precond=pre, tol=tol, max_iter=max_iter,
                       precise_dots=precise_dots)
        return VelocityResult(res.x, mesh.basis, res.iterations,
                              res.residual, res.converged)
    if method == "cholesky":
        x = solve_cholesky(mesh, op, f, refine_steps=refine_steps,
                           batch_size=batch_size)
        r = f - op.matvec(x)
        rn = jnp.linalg.norm(r, axis=-1)
        fn = jnp.maximum(jnp.linalg.norm(f, axis=-1),
                         jnp.finfo(f.dtype).tiny)
        return VelocityResult(x, mesh.basis, jnp.int32(0), rn, rn <= tol * fn)
    raise ValueError(f"unknown method: {method!r} (want 'cg' or 'cholesky')")
