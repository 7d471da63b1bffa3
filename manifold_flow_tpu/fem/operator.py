"""Matrix-free batched operator A_k = a1_k + lambda * a2.

The batched replacement for per-frame scipy CSR matrices
(utils/compute_optical_flow.py:143-147): one gather -> local 6x6 contraction
-> segment scatter-add, batched over all frames simultaneously (frames ride
the leading axis; XLA fuses the whole matvec into a few kernels).

The a1 part is never materialized: its local block is
B1 = (A/12) * (J + I) ⊗ g g^T, so A1 x reduces to two tiny contractions per
triangle (s = <g, x_local>, then g * (s + sum s)), which is both fewer FLOPs
and less memory traffic than block matvecs.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from manifold_flow_tpu.fem import assembly
from manifold_flow_tpu.geometry.mesh import TriMesh

# f32 contractions run at full f32 precision (no TF32 on GPUs).
_HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FlowOperator:
    """Batched linear operator for T frames over one mesh.

    Fields:
      dof        (M, 6)      global DOF ids per triangle
      blocks2    (M, 6, 6)   a2 local blocks (frame-independent)
      g          (T, M, 3, 2) per-frame a1 factors (grad_M I . e)
      inv_mass   (M, 3)      A/12 scale used by the a1 contraction
      lambda_    ()          regularization weight
      n_dof      static      2N
    """

    dof: jnp.ndarray
    blocks2: jnp.ndarray
    g: jnp.ndarray
    w_scale: jnp.ndarray
    lambda_: jnp.ndarray
    # Gather-mode reduction table (N, C): flat index m*6 + slot*2 into the
    # local-contribution array for each vertex's incident (cell, corner);
    # padded entries point at an appended zero slot. Turns the scatter-add
    # into a fixed-width gather + sum (deterministic summation order).
    # Whether it still beats scatter-add on the GPU is ROADMAP C3.
    gather_base: jnp.ndarray | None = None
    n_dof: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def n_frames(self) -> int:
        return self.g.shape[0]

    def local_contributions(self, x: jnp.ndarray) -> jnp.ndarray:
        """Per-triangle local products y_loc (T, M, 6) of A x."""
        t = x.shape[0]
        m = self.dof.shape[0]
        xg = x[:, self.dof]                                  # (T, M, 6)
        y2 = jnp.einsum("mij,tmj->tmi", self.blocks2, xg,
                        precision=_HIGHEST)  # (T, M, 6)
        xg32 = xg.reshape(t, m, 3, 2)
        s = jnp.sum(self.g * xg32, axis=-1)                  # (T, M, 3)
        stot = jnp.sum(s, axis=-1, keepdims=True)            # (T, M, 1)
        w = self.w_scale[:, None] * (s + stot)               # (T, M, 3)
        y1 = self.g * w[..., None]                           # (T, M, 3, 2)
        return self.lambda_ * y2 + y1.reshape(t, m, 6)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """Apply A to x (T, 2N) -> (T, 2N).

        With a gather_base table the reduction is a fixed-width gather + sum
        (deterministic summation order); mesh-partitioned solves use
        parallel.halo.HaloOperator instead of this class.
        """
        t = x.shape[0]
        y_loc = self.local_contributions(x)
        if self.gather_base is not None:
            y_flat = jnp.concatenate(
                [y_loc.reshape(t, -1),
                 jnp.zeros((t, 2), dtype=y_loc.dtype)], axis=1)
            c0 = jnp.take(y_flat, self.gather_base, axis=1)       # (T, N, C)
            c1 = jnp.take(y_flat, self.gather_base + 1, axis=1)   # (T, N, C)
            return jnp.concatenate([c0.sum(-1), c1.sum(-1)], axis=-1)
        out = jnp.zeros((t, self.n_dof), dtype=x.dtype)
        return out.at[:, self.dof.reshape(-1)].add(y_loc.reshape(t, -1))


def make_operator(mesh: TriMesh, potentials: jnp.ndarray,
                  lambda_: float) -> FlowOperator:
    """Operator for frames k = 0..T-2 built from a (T, N) potentials movie.

    a1_k uses the frame-k field (utils/compute_optical_flow.py:116-117), so
    the factors are computed for potentials[:-1].
    """
    g = assembly.frame_factors(mesh, potentials[:-1])
    m = mesh.triangles.shape[0]
    pad = mesh.vertex_cells < 0
    gather_base = jnp.where(
        pad, m * 6,
        mesh.vertex_cells * 6 + mesh.vertex_cell_slot * 2).astype(jnp.int32)
    return FlowOperator(
        dof=assembly.local_dof_indices(mesh),
        blocks2=assembly.a2_blocks(mesh).astype(g.dtype),
        g=g,
        w_scale=(mesh.areas / 12.0).astype(g.dtype),
        lambda_=jnp.asarray(lambda_, dtype=g.dtype),
        gather_base=gather_base,
        n_dof=mesh.n_dof,
    )


def block_jacobi_inverse(mesh: TriMesh, g: jnp.ndarray,
                         lambda_: float) -> jnp.ndarray:
    """Inverted per-vertex 2x2 diagonal blocks (T, N, 2, 2) of A."""
    return invert_2x2_blocks(assembly.diag_blocks(mesh, g, lambda_))


def invert_2x2_blocks(d: jnp.ndarray) -> jnp.ndarray:
    """Analytic inverse of (..., 2, 2) blocks; singular blocks -> identity."""
    a, b = d[..., 0, 0], d[..., 0, 1]
    c, e = d[..., 1, 0], d[..., 1, 1]
    det = a * e - b * c
    safe = jnp.where(jnp.abs(det) > 0, det, 1.0)
    inv = jnp.stack(
        [jnp.stack([e, -b], axis=-1), jnp.stack([-c, a], axis=-1)], axis=-2
    ) / safe[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(2, dtype=d.dtype), inv.shape)
    return jnp.where((jnp.abs(det) > 0)[..., None, None], inv, eye)


def apply_block_diag(diag: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Apply per-vertex 2x2 blocks (T, N, 2, 2) to DOF vectors r (T, 2N).

    Written as four elementwise multiply-adds on the (T, N) component halves
    (not stack/einsum): keeps everything in the iterate's natural layout —
    no (T, N, 2) transposes in the CG hot loop.
    """
    n = diag.shape[1]
    r1, r2 = r[:, :n], r[:, n:]
    z1 = diag[:, :, 0, 0] * r1 + diag[:, :, 0, 1] * r2
    z2 = diag[:, :, 1, 0] * r1 + diag[:, :, 1, 1] * r2
    return jnp.concatenate([z1, z2], axis=-1)
