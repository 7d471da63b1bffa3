"""shard_map-based distributed velocity solve over ('frames', 'mesh').

Sharding layout:
  * per-frame data (a1 factors g, RHS f, CG iterates) shard the frame axis
    over 'frames' — pure data parallelism, zero communication (the
    replacement for the reference's multiprocessing pool,
    utils/compute_optical_flow.py:152-194);
  * the DOF space shards over 'mesh' in owned vertex blocks with halo
    exchange (parallel.halo): per-device memory ~ 2N / n_mesh + halo, one
    boundary all_gather per matvec. Both the f32/f64 CG path and the
    refined path support the mesh axis (halo copies are exact).

CG control flow stays in lockstep across the 'mesh' axis because CG dot
products psum over it; different frame-shards may run different iteration
counts, which is fine — they never communicate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from manifold_flow_tpu.geometry.mesh import TriMesh
from manifold_flow_tpu.solve.api import VelocityResult
from manifold_flow_tpu.solve.refine import DEFAULT_INNER_TOL


def make_device_mesh(n_frame_shards: int | None = None,
                     n_mesh_shards: int = 1, devices=None) -> Mesh:
    """Device mesh with axes ('frames', 'mesh').

    Defaults to all available devices on the frame axis (the zero-comm
    direction) — the right default at the reference's workload sizes.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_frame_shards is None:
        n_frame_shards = devices.size // n_mesh_shards
    devices = devices[: n_frame_shards * n_mesh_shards]
    grid = devices.reshape(n_frame_shards, n_mesh_shards)
    return Mesh(grid, axis_names=("frames", "mesh"))


def _pad_axis(x: jnp.ndarray, axis: int, multiple: int) -> jnp.ndarray:
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def sharded_compute_velocity_fields(
    mesh: TriMesh,
    potentials: jnp.ndarray,
    times: jnp.ndarray,
    device_mesh: Mesh,
    lambda_: float = 0.01,
    tol: float = 1e-10,
    max_iter: int = 2000,
    method: str = "cg",
    precond: str = "auto",
    inner_tol=DEFAULT_INNER_TOL,
) -> VelocityResult:
    """Distributed equivalent of solve.api.compute_velocity_fields.

    With n_mesh_shards > 1 both methods dispatch to the halo-exchange
    vertex-block partition (parallel.halo) — the mesh axis shards memory,
    not just FLOPs. With n_mesh_shards == 1 frames are simply data-parallel:
    each shard runs the single-device solver on its frame slice with zero
    communication (the scaling structure of the reference's frame pool).
    """
    if precond not in ("jacobi", "two_level", "auto"):
        raise ValueError(f"unknown precond: {precond!r}")
    nm = device_mesh.shape["mesh"]
    if method == "cg" and nm > 1:
        from manifold_flow_tpu.parallel.halo import (
            halo_compute_velocity_fields)

        return halo_compute_velocity_fields(
            mesh, potentials, times, device_mesh, lambda_=lambda_, tol=tol,
            max_iter=max_iter, precond=precond)
    if method == "refined" and nm > 1:
        from manifold_flow_tpu.parallel.halo import (
            halo_refined_velocity_fields)

        return halo_refined_velocity_fields(
            mesh, potentials, times, device_mesh, lambda_=lambda_, tol=tol,
            max_iter=max_iter, precond=precond, inner_tol=inner_tol)
    if method == "refined":
        return _frames_sharded_refined(mesh, potentials, times, device_mesh,
                                       lambda_=lambda_, tol=tol,
                                       max_iter=max_iter, precond=precond,
                                       inner_tol=inner_tol)
    if method != "cg":
        raise ValueError(f"unknown sharded method {method!r} "
                         "(want 'cg' or 'refined')")
    return _frames_sharded_cg(mesh, potentials, times, device_mesh,
                              lambda_=lambda_, tol=tol, max_iter=max_iter,
                              precond=precond)


def _frames_sharded_cg(mesh, potentials, times, device_mesh, lambda_, tol,
                       max_iter, precond: str = "auto"):
    """Frame-sharded batched PCG: frames are independent systems, so each
    shard runs the full single-device operator on its slice, zero comm."""
    from manifold_flow_tpu.fem import assembly
    from manifold_flow_tpu.fem.operator import make_operator
    from manifold_flow_tpu.solve.api import TWO_LEVEL_MIN_VERTICES
    from manifold_flow_tpu.solve.cg import solve_cg

    potentials = jnp.asarray(potentials)
    times = jnp.asarray(times, dtype=potentials.dtype)
    nf = device_mesh.shape["frames"]
    op = make_operator(mesh, potentials, lambda_)
    dt = (times[1:] - times[:-1])[:, None]
    di = (potentials[1:] - potentials[:-1]) / dt
    f = assembly.rhs_vector(mesh, op.g, di)
    t = f.shape[0]

    tables = None
    if precond == "auto" and mesh.n_vertices < TWO_LEVEL_MIN_VERTICES:
        precond = "jacobi"
    if precond != "jacobi":
        from manifold_flow_tpu.solve import coarse

        try:
            tables = coarse.build_tables(mesh)
        except Exception:
            if precond == "two_level":
                raise
            tables = None

    g_pad = _pad_axis(op.g, 0, nf)
    f_pad = _pad_axis(f, 0, nf)

    def local_solve(g_l, f_l):
        import dataclasses as _dc

        op_l = _dc.replace(op, g=g_l)
        if tables is not None:
            from manifold_flow_tpu.solve.coarse import make_two_level

            pre = make_two_level(mesh, g_l, op.lambda_, tables)
        else:
            from manifold_flow_tpu.fem.operator import block_jacobi_inverse

            pre = block_jacobi_inverse(mesh, g_l, lambda_)
        res = solve_cg(op_l, f_l, precond=pre, tol=tol, max_iter=max_iter)
        return res.x, res.iterations[None], res.residual, res.converged

    spec = P("frames")
    shard = jax.shard_map(
        local_solve, mesh=device_mesh,
        in_specs=(spec, spec), out_specs=(spec, spec, spec, spec),
        check_vma=False)
    x, iters, resid, conv = jax.jit(shard)(g_pad, f_pad)
    return VelocityResult(
        v_k=x[:t], e=mesh.basis,
        iterations=jnp.max(iters), residual=resid[:t], converged=conv[:t])


def _frames_sharded_refined(mesh, potentials, times, device_mesh, lambda_,
                            tol, max_iter, precond: str = "auto",
                            inner_tol=DEFAULT_INNER_TOL):
    """Frame-sharded refined solve (f32 inner PCG + f64 residuals).

    Assembly is replicated (cheap relative to the solve); each frame shard
    runs its own refinement loop to convergence with zero communication —
    the scaling structure of the reference's frame pool, at direct-solver
    accuracy."""
    import dataclasses as _dc

    from manifold_flow_tpu.fem.operator import make_operator
    from manifold_flow_tpu.solve.api import build_rhs
    from manifold_flow_tpu.solve.refine import refine_loop

    potentials = jnp.asarray(potentials)
    times = jnp.asarray(times, dtype=potentials.dtype)
    nf = device_mesh.shape["frames"]
    op = make_operator(mesh, potentials, lambda_)
    f = build_rhs(mesh, op, potentials, times)
    t = f.shape[0]

    tables = None
    if precond == "auto":
        from manifold_flow_tpu.solve.api import TWO_LEVEL_MIN_VERTICES

        if mesh.n_vertices < TWO_LEVEL_MIN_VERTICES:
            precond = "jacobi"
    if precond != "jacobi":
        from manifold_flow_tpu.solve import coarse

        try:
            tables = coarse.build_tables(mesh)
        except Exception:
            if precond == "two_level":
                raise
            tables = None  # traced topology: fall back to block-Jacobi

    g_pad = _pad_axis(op.g, 0, nf)
    f_pad = _pad_axis(f, 0, nf)

    def local_solve(g_l, f_l):
        res = refine_loop(mesh, _dc.replace(op, g=g_l), f_l, tol=tol,
                          inner_tol=inner_tol, max_iter=max_iter,
                          coarse_tables=tables)
        return res.x, res.iterations[None], res.residual, res.converged

    spec = P("frames")
    shard = jax.shard_map(
        local_solve, mesh=device_mesh,
        in_specs=(spec, spec), out_specs=(spec, spec, spec, spec),
        check_vma=False)
    x, iters, resid, conv = jax.jit(shard)(g_pad, f_pad)
    return VelocityResult(
        v_k=x[:t], e=mesh.basis,
        iterations=jnp.max(iters), residual=resid[:t], converged=conv[:t])
