"""Triangle-batched FEM assembly for the manifold optical-flow system.

System per frame k (reference equations 15/16/17, docstrings at
utils/compute_optical_flow.py:260, 275, 290):

    (a1_k + lambda * a2) V_k = f_k,   V_k in R^{2N}

with DOF layout dof = vertex + N * alpha (alpha in {0, 1} the tangent
component — same layout as the reference so V_k CSV artifacts interoperate).

Local DOF order within a triangle is (corner, alpha) flattened as
l = corner * 2 + alpha, giving 6 local DOFs and 6x6 local blocks:

  a2 block:  B2[(i,a),(j,b)] = (e_i^a . e_j^b)(grad_i . grad_j) * A_T
             (compute_a2, utils/compute_optical_flow.py:258-270)
  a1 block:  B1[(i,a),(j,b)] = g_i^a g_j^b * Int(w_i w_j),
             g_i^a = grad_M_I . e_i^a, Int = A/6 if i==j else A/12
             (compute_a1, :273-285)
  rhs:       f[(i,a)] = g_i^a * (2 dI_i + dI_j + dI_k) * A_T / 12
             (compute_f, :288-311)

Both block forms are symmetric under (i,a)<->(j,b), so accumulating all 36
pairs reproduces the reference's upper-triangle + mirror construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from manifold_flow_tpu.geometry.mesh import TriMesh

# f32 contractions run at full f32 precision (no TF32 on GPUs).
_HIGHEST = jax.lax.Precision.HIGHEST

_W_MASS = None  # lazily built (3, 3) mass weight pattern (J + I)


def _mass_pattern(dtype):
    return jnp.ones((3, 3), dtype=dtype) + jnp.eye(3, dtype=dtype)


def local_dof_indices(mesh: TriMesh) -> jnp.ndarray:
    """Global DOF ids (M, 6) for local DOFs l = corner * 2 + alpha."""
    n = mesh.n_vertices
    dof = mesh.triangles[:, :, None] + n * jnp.arange(2, dtype=mesh.triangles.dtype)
    return dof.reshape(mesh.triangles.shape[0], 6)


def corner_bases(mesh: TriMesh) -> jnp.ndarray:
    """Tangent bases gathered at triangle corners: (M, 3, 2, 3)."""
    return mesh.basis[mesh.triangles]


def a2_blocks(mesh: TriMesh) -> jnp.ndarray:
    """Per-triangle regularization blocks (M, 6, 6). Precomputed once."""
    et = corner_bases(mesh)                                    # (M, 3, 2, 3)
    gg = jnp.einsum("mid,mjd->mij", mesh.grad_w, mesh.grad_w,
                    precision=_HIGHEST)  # (M, 3, 3)
    ee = jnp.einsum("miad,mjbd->miajb", et, et,
                    precision=_HIGHEST)  # (M, 3, 2, 3, 2)
    blocks = ee * gg[:, :, None, :, None] * mesh.areas[:, None, None, None, None]
    m = mesh.triangles.shape[0]
    return blocks.reshape(m, 6, 6)


def frame_factors(mesh: TriMesh, potentials: jnp.ndarray) -> jnp.ndarray:
    """Per-frame a1 factors g = (grad_M I . e) : (T, M, 3, 2).

    `potentials` is (T, N) — one frame's scalar field per row. grad_M I is
    the per-triangle field gradient sum_c I[T_c] grad_w_c
    (utils/compute_optical_flow.py:116-117).
    """
    i_tri = potentials[..., mesh.triangles]                   # (T, M, 3)
    grad_m = jnp.einsum("tmc,mcd->tmd", i_tri, mesh.grad_w,
                        precision=_HIGHEST)  # (T, M, 3)
    et = corner_bases(mesh)                                   # (M, 3, 2, 3)
    return jnp.einsum("tmd,mcad->tmca", grad_m, et,
                      precision=_HIGHEST)  # (T, M, 3, 2)


def gather_base_table(mesh: TriMesh) -> jnp.ndarray:
    """Vertex -> flat (cell*6 + slot*2) local-DOF table (N, C), padded to a
    zero slot at M*6 — the scatter-free reduction used by fem.operator."""
    m = mesh.triangles.shape[0]
    pad = mesh.vertex_cells < 0
    return jnp.where(
        pad, m * 6,
        mesh.vertex_cells * 6 + mesh.vertex_cell_slot * 2).astype(jnp.int32)


def reduce_local(mesh: TriMesh, y_loc: jnp.ndarray) -> jnp.ndarray:
    """Reduce per-triangle local DOF contributions (T, M, 6) -> (T, 2N).

    Fixed-width gather + sum over each vertex's incident (cell, corner)
    slots (scatter-free; see kernels/reduce.py notes).
    """
    t = y_loc.shape[0]
    base = gather_base_table(mesh)
    y_flat = jnp.concatenate(
        [y_loc.reshape(t, -1), jnp.zeros((t, 2), y_loc.dtype)], axis=1)
    c0 = jnp.take(y_flat, base, axis=1)                       # (T, N, C)
    c1 = jnp.take(y_flat, base + 1, axis=1)                   # (T, N, C)
    return jnp.concatenate([c0.sum(-1), c1.sum(-1)], axis=-1)


def rhs_vector(mesh: TriMesh, g: jnp.ndarray, dI: jnp.ndarray) -> jnp.ndarray:
    """RHS f (T, 2N) from factors g (T, M, 3, 2) and dI = (I_{k+1}-I_k)/dt (T, N)."""
    di_tri = dI[..., mesh.triangles]                          # (T, M, 3)
    s = jnp.sum(di_tri, axis=-1, keepdims=True)               # (T, M, 1)
    scale = (di_tri + s) * (mesh.areas / 12.0)[:, None]       # (T, M, 3)
    f_loc = g * scale[..., None]                              # (T, M, 3, 2)
    t = f_loc.shape[0]
    return reduce_local(mesh, f_loc.reshape(t, -1, 6))


def a1_blocks(mesh: TriMesh, g: jnp.ndarray) -> jnp.ndarray:
    """Dense per-frame data blocks (T, M, 6, 6) (only for the direct solver)."""
    w = _mass_pattern(g.dtype) * (mesh.areas[:, None, None] / 12.0)  # (M, 3, 3)
    blocks = jnp.einsum("tmia,tmjb,mij->tmiajb", g, g, w, precision=_HIGHEST)
    t, m = g.shape[0], g.shape[1]
    return blocks.reshape(t, m, 6, 6)


def scatter_dense(mesh: TriMesh, blocks: jnp.ndarray) -> jnp.ndarray:
    """Scatter per-triangle blocks (..., M, 6, 6) into dense (..., 2N, 2N)."""
    dof = local_dof_indices(mesh)
    rows = jnp.broadcast_to(dof[:, :, None], blocks.shape[-3:]).reshape(-1)
    cols = jnp.broadcast_to(dof[:, None, :], blocks.shape[-3:]).reshape(-1)
    nd = mesh.n_dof
    flat = blocks.reshape(*blocks.shape[:-3], -1)
    out = jnp.zeros((*blocks.shape[:-3], nd * nd), dtype=blocks.dtype)
    out = out.at[..., rows * nd + cols].add(flat)
    return out.reshape(*blocks.shape[:-3], nd, nd)


def dense_a2(mesh: TriMesh) -> jnp.ndarray:
    """Dense (2N, 2N) regularization matrix (small-mesh direct path)."""
    return scatter_dense(mesh, a2_blocks(mesh))


def diag_contributions(mesh: TriMesh, g: jnp.ndarray,
                       lambda_: float) -> jnp.ndarray:
    """Per-triangle per-corner diagonal 2x2 contributions (T, M, 3, 2, 2).

    Contribution of triangle m at corner c to the diagonal block of
    A = a1 + lambda a2:  lambda * (e_c^a . e_c^b)|grad_c|^2 A  +  g_c^a g_c^b A/6.
    Kept per-triangle so distributed solvers can shard the triangle axis and
    scatter + psum locally (parallel.partition). Computes in g's dtype (mesh
    geometry is cast down if needed): preconditioner accuracy only affects
    inner-iteration counts, so the refined solver builds it in f32 even
    when the mesh is f64 (solve.refine).
    """
    et = corner_bases(mesh).astype(g.dtype)                   # (M, 3, 2, 3)
    areas = mesh.areas.astype(g.dtype)
    ee = jnp.einsum("mcad,mcbd->mcab", et, et,
                    precision=_HIGHEST)  # (M, 3, 2, 2)
    gg = jnp.sum(mesh.grad_w * mesh.grad_w, axis=-1).astype(g.dtype)  # (M, 3)
    reg = ee * (gg * areas[:, None])[:, :, None, None]        # (M, 3, 2, 2)
    dat = jnp.einsum("tmca,tmcb->tmcab", g, g,
                     precision=_HIGHEST) * (areas / 6.0)[:, None, None, None]
    return lambda_ * reg[None] + dat                          # (T, M, 3, 2, 2)


def scatter_diag(contrib: jnp.ndarray, triangles: jnp.ndarray,
                 n_vertices: int) -> jnp.ndarray:
    """Scatter (T, M, 3, 2, 2) corner contributions -> (T, N, 2, 2)."""
    t = contrib.shape[0]
    out = jnp.zeros((t, n_vertices, 2, 2), dtype=contrib.dtype)
    idx = triangles.reshape(-1)
    return out.at[:, idx].add(contrib.reshape(t, -1, 2, 2))


def diag_blocks(mesh: TriMesh, g: jnp.ndarray, lambda_: float) -> jnp.ndarray:
    """Per-vertex 2x2 diagonal blocks of A = a1 + lambda a2: (T, N, 2, 2).

    Gather-mode reduction over each vertex's incident (cell, corner) slots
    (scatter-free, same rationale as reduce_local)."""
    contrib = diag_contributions(mesh, g, lambda_)            # (T, M, 3, 2, 2)
    t = contrib.shape[0]
    m = mesh.triangles.shape[0]
    idx = jnp.where(mesh.vertex_cells < 0, m * 3,
                    mesh.vertex_cells * 3 + mesh.vertex_cell_slot)  # (N, C)
    flat = jnp.concatenate(
        [contrib.reshape(t, m * 3, 4),
         jnp.zeros((t, 1, 4), contrib.dtype)], axis=1)        # (T, 3M+1, 4)
    picked = jnp.take(flat, idx, axis=1)                      # (T, N, C, 4)
    return picked.sum(axis=2).reshape(t, mesh.n_vertices, 2, 2)
