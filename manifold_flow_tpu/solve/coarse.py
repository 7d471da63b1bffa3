"""Two-level preconditioner: block-Jacobi smoother + coarse-grid correction.

The reference factors each (a1_k + lambda a2) system exactly with SuperLU
(utils/compute_optical_flow.py:143-147). This path is iterative (solve.cg)
and the systems are ill-conditioned (cond ~ 1e5 at lambda = 0.01), so plain
block-Jacobi PCG needs hundreds of iterations. This module adds the standard
cure — a two-level additive preconditioner

    M^{-1} r = D^{-1} r + P A_c^{-1} P^T r

with an aggregation-based prolongation P that is *tangent-aware*: each
aggregate carries one 3-D tangent vector expressed in its seed vertex's
orthonormal basis, and the per-vertex 2x2 blocks of P are the change-of-basis
projections e_v^a . ebar_s^b. Smooth tangent fields (the near-kernel of the
a2 stiffness term that CG resolves slowest) are exactly representable on the
coarse space, which is what collapses the iteration count.

Device mapping: the coarse matrices A_c = P^T A P are small (2Nc ~ a few
hundred) dense batched-over-frames arrays; they are assembled once per solve
by a triangle-local transform + segment reduction and *explicitly inverted*
with a batched dense factorization, so the per-iteration coarse correction
is one batched (T, 2Nc, 2Nc) @ (T, 2Nc) matmul — no triangular solves in the
iteration loop.

Only the aggregate assignment is host-side (greedy graph aggregation on the
1-ring adjacency, numpy, cached per mesh); everything numeric is traced.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from manifold_flow_tpu.fem import assembly
from manifold_flow_tpu.fem.operator import apply_block_diag
from manifold_flow_tpu.geometry.mesh import TriMesh
from manifold_flow_tpu.kernels import reduce as kreduce

# f32 contractions run at full f32 precision (no TF32 on GPUs).
_HIGHEST = jax.lax.Precision.HIGHEST


def aggregate_vertices(neighbors: np.ndarray, degrees: np.ndarray,
                       passes: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Greedy graph aggregation: (agg (N,) int32, seeds (Nc,) int32).

    Pass 1 sweeps vertices in index order; an unassigned vertex becomes a
    seed and absorbs its unassigned 1-ring. Leftovers join the aggregate of
    their first assigned neighbor (or become singleton seeds on isolated
    components). `passes > 1` re-runs the same procedure on the aggregate
    graph, roughly multiplying the coarsening ratio by ~5-7x per pass.
    Deterministic, O(N * max_degree).
    """
    n = neighbors.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    seeds = []
    for v in range(n):
        if agg[v] >= 0:
            continue
        a = len(seeds)
        seeds.append(v)
        agg[v] = a
        for u in neighbors[v, : degrees[v]]:
            if u >= 0 and agg[u] < 0:
                agg[u] = a
    for v in range(n):
        if agg[v] >= 0:
            continue
        placed = False
        for u in neighbors[v, : degrees[v]]:
            if u >= 0 and agg[u] >= 0:
                agg[v] = agg[u]
                placed = True
                break
        if not placed:
            agg[v] = len(seeds)
            seeds.append(v)
    seeds_arr = np.asarray(seeds, dtype=np.int64)

    for _ in range(passes - 1):
        nc = len(seeds_arr)
        if nc <= 8:
            break
        # Aggregate-level adjacency from the fine edges.
        adj: list[set[int]] = [set() for _ in range(nc)]
        for v in range(n):
            av = agg[v]
            for u in neighbors[v, : degrees[v]]:
                if u >= 0 and agg[u] != av:
                    adj[av].add(int(agg[u]))
        max_deg = max((len(s) for s in adj), default=1) or 1
        cn = np.full((nc, max_deg), -1, dtype=np.int64)
        cd = np.zeros(nc, dtype=np.int64)
        for i, s in enumerate(adj):
            lst = sorted(s)
            cn[i, : len(lst)] = lst
            cd[i] = len(lst)
        agg2, seed_of_agg = aggregate_vertices(cn, cd, passes=1)
        agg = agg2[agg]
        seeds_arr = seeds_arr[seed_of_agg]
    return agg.astype(np.int32), seeds_arr.astype(np.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CoarseTables:
    """Host-precomputed integer tables for one mesh (hashable-static sizes).

    agg     (N,)     aggregate id per vertex
    seeds   (Nc,)    seed vertex per aggregate (reference tangent basis)
    members (Nc, K)  member vertices per aggregate, padded with N — turns the
                     restriction P^T (a per-vertex scatter-add over
                     aggregates) into a fixed-width gather + sum
    asm_plan         kernels.reduce.ReducePlan assembling the (M, 3, 2, 3, 2)
                     triangle-local coarse contributions into the dense
                     (2Nc)^2 matrix without any scatter
    n_coarse         static aggregate count Nc
    """

    agg: jnp.ndarray
    seeds: jnp.ndarray
    members: jnp.ndarray
    asm_plan: kreduce.ReducePlan
    n_coarse: int = dataclasses.field(default=0, metadata=dict(static=True))


_TABLE_CACHE: dict = {}

# 'auto' pass count: keep aggregating until at most this many aggregates.
# The coarse correction is applied as a dense (T, 2Nc, 2Nc) matvec; capping
# Nc keeps its per-iteration HBM traffic scale-free (at 2Nc ~ 1000+ the
# inverse reads would dominate the whole CG iteration), while each extra
# pass only mildly raises iteration counts.
MAX_COARSE_SIZE = 512
_MAX_PASSES = 8


def build_tables(mesh: TriMesh, passes: int | None = None) -> CoarseTables:
    """Aggregation tables for `mesh` (cached by mesh identity).

    `passes=None` (auto) aggregates until n_coarse <= MAX_COARSE_SIZE.
    Must be called with concrete (non-traced) topology arrays — i.e. outside
    jit, or with the mesh closed over as a constant.
    """
    # Identity key PLUS a pinned reference + `is` check: a bare id() can be
    # recycled by CPython after the keyed array is freed, silently returning
    # another mesh's aggregation (same hazard class as parallel.halo's
    # partition cache).
    key = (id(mesh.vertex_neighbors), passes)
    entry = _TABLE_CACHE.get(key)
    hit = (entry[1] if entry is not None
           and entry[0] is mesh.vertex_neighbors else None)
    if hit is None:
        # np.asarray raises on traced topology — callers fall back to Jacobi.
        neighbors = np.asarray(mesh.vertex_neighbors)
        degrees = np.asarray(mesh.vertex_degree)
        n = neighbors.shape[0]
        # Aggregate the VALID subgraph only. Pad vertices (pad_mesh) have
        # empty adjacency rows, so feeding them through would make each one
        # a permanent singleton aggregate squatting on the MAX_COARSE_SIZE
        # budget and over-coarsening the real vertices.
        nv = int(mesh.valid_vertices)
        neighbors_v, degrees_v = neighbors[:nv], degrees[:nv]
        if passes is None:
            agg, seeds = aggregate_vertices(neighbors_v, degrees_v, passes=1)
            n_passes = 1
            while (seeds.shape[0] > MAX_COARSE_SIZE
                   and n_passes < _MAX_PASSES):
                agg, seeds = aggregate_vertices(
                    neighbors_v, degrees_v, passes=n_passes + 1)
                n_passes += 1
        else:
            agg, seeds = aggregate_vertices(neighbors_v, degrees_v,
                                            passes=passes)
        nc = int(seeds.shape[0])
        order = np.argsort(agg, kind="stable")
        counts = np.bincount(agg, minlength=nc)
        if nv < n:
            # ONE dedicated aggregate absorbs every pad vertex. Its coarse
            # row is pure ridge (pad triangles contribute zero), its
            # restricted residual is identically zero (pad members are left
            # out of the gather table), so its correction — the value
            # prolongation writes back into pad DOFs — is exactly zero.
            agg = np.concatenate(
                [agg, np.full(n - nv, nc, dtype=agg.dtype)])
            seeds = np.concatenate(
                [seeds, np.asarray([nv], dtype=seeds.dtype)])
            nc += 1
        k = max(int(counts.max()), 1)
        members = np.full((nc, k), n, dtype=np.int32)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for a in range(len(counts)):
            span = order[offsets[a]: offsets[a + 1]]
            members[a, : span.size] = span
        # Scatter-free assembly plan for the (M, 3, 2, 3, 2) local coarse
        # contributions -> flat (2Nc)^2 targets.
        tris = np.clip(np.asarray(mesh.triangles), 0, n - 1)
        nc2 = 2 * nc
        cdof = 2 * agg[tris][:, :, None] + np.arange(2)        # (M, 3, 2)
        rows = cdof[:, :, :, None, None]
        cols = cdof[:, None, None, :, :]
        flat = (rows * nc2 + cols).reshape(-1)
        plan_np = kreduce.build_reduce_plan_np(flat, nc2 * nc2)
        hit = (agg, seeds, members, plan_np)
        _TABLE_CACHE[key] = (mesh.vertex_neighbors, hit)
        # Capped FIFO: entries pin the keyed device array (that is what
        # makes the id key safe), so unbounded growth across a batch sweep
        # over many surfaces would leak host+device memory.
        while len(_TABLE_CACHE) > 8:
            _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
    agg, seeds, members, plan_np = hit
    pad_perm, slot_groups, dense_gather, n_vals = plan_np
    # Convert to jnp per call (NOT cached): under an active trace these are
    # constants bound to that trace; caching them would leak tracers.
    plan = kreduce.ReducePlan(
        pad_perm=jnp.asarray(pad_perm), slot_groups=jnp.asarray(slot_groups),
        dense_gather=jnp.asarray(dense_gather), n_vals=n_vals)
    return CoarseTables(agg=jnp.asarray(agg), seeds=jnp.asarray(seeds),
                        members=jnp.asarray(members), asm_plan=plan,
                        n_coarse=int(seeds.shape[0]))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TwoLevelPrecond:
    """M^{-1} = block-Jacobi + tangent-aware coarse correction (a pytree).

    diag    (T, N, 2, 2)   inverted per-vertex diagonal blocks
    r_blk   (N, 2, 2)      prolongation blocks R_v[a, b] = e_v^a . ebar^b
    agg     (N,)           aggregate ids (prolongation gather)
    members (Nc, K)        member vertices per aggregate (restriction gather)
    ac_inv  (T, 2Nc, 2Nc)  explicit inverses of the coarse matrices
    """

    diag: jnp.ndarray
    r_blk: jnp.ndarray
    agg: jnp.ndarray
    members: jnp.ndarray
    ac_inv: jnp.ndarray
    n_coarse: int = dataclasses.field(default=0, metadata=dict(static=True))

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        """Apply M^{-1} to residuals r (T, 2N) -> (T, 2N).

        All per-vertex 2-blocks are applied as elementwise multiply-adds on
        (T, N) component planes (no (T, N, 2) transposes); the restriction
        P^T is a fixed-width member gather + sum, the coarse solve is one
        batched dense matvec on the precomputed inverse.
        """
        z_fine = apply_block_diag(self.diag, r)
        t = r.shape[0]
        n = self.r_blk.shape[0]
        r1, r2 = r[:, :n], r[:, n:]
        r00, r01 = self.r_blk[:, 0, 0], self.r_blk[:, 0, 1]
        r10, r11 = self.r_blk[:, 1, 0], self.r_blk[:, 1, 1]
        # q_b = sum_a R[a, b] r_a  (coarse-basis components per vertex)
        q1 = r00 * r1 + r10 * r2                               # (T, N)
        q2 = r01 * r1 + r11 * r2                               # (T, N)
        zero = jnp.zeros((t, 1), dtype=r.dtype)
        q1p = jnp.concatenate([q1, zero], axis=1)
        q2p = jnp.concatenate([q2, zero], axis=1)
        # Restriction: fixed-width gather + sum (members pads with row N).
        rc1 = jnp.take(q1p, self.members, axis=1).sum(axis=2)  # (T, Nc)
        rc2 = jnp.take(q2p, self.members, axis=1).sum(axis=2)  # (T, Nc)
        rc_flat = jnp.stack([rc1, rc2], axis=-1).reshape(t, -1)  # (T, 2Nc)
        if self.ac_inv.shape[0] == 1:   # shared coarse matrix: one matmul
            yc = jnp.matmul(rc_flat, self.ac_inv[0], precision=_HIGHEST)
        else:
            yc = jnp.einsum("tij,tj->ti", self.ac_inv, rc_flat,
                            preferred_element_type=rc_flat.dtype,
          precision=_HIGHEST)  # (T, 2Nc)
        ycr = yc.reshape(t, self.n_coarse, 2)
        ya = jnp.take(ycr[:, :, 0], self.agg, axis=1)          # (T, N)
        yb = jnp.take(ycr[:, :, 1], self.agg, axis=1)          # (T, N)
        # Prolongation: z_a = sum_b R[a, b] y_b
        z1 = r00 * ya + r01 * yb
        z2 = r10 * ya + r11 * yb
        return z_fine + jnp.concatenate([z1, z2], axis=-1)


def coarse_matrices(mesh: TriMesh, g: jnp.ndarray, lambda_,
                    tables: CoarseTables, a1_mode: str = "full"):
    """Assemble A_c = P^T (a1_k + lambda a2) P for all frames: (T, 2Nc, 2Nc).

    Triangle-local: transform each 6x6 local block by the corner R blocks and
    assemble into the dense coarse matrix with the scatter-free two-stage
    reduction (tables.asm_plan, kernels/reduce.py). The a2 part is
    frame-independent and assembled once; the a1 part is the rank-structured
    outer product of the coarse-projected factors Rg (fem.assembly docstring,
    reference compute_a1 utils/compute_optical_flow.py:273-285).
    """
    dtype = g.dtype
    nc2 = 2 * tables.n_coarse
    ebar = mesh.basis[tables.seeds].astype(dtype)              # (Nc, 2, 3)
    r_blk = jnp.einsum("nad,nbd->nab", mesh.basis.astype(dtype),
                       ebar[tables.agg],
          precision=_HIGHEST)  # (N, 2, 2)
    rc = r_blk[mesh.triangles]                                 # (M, 3, 2, 2)

    # a2: B2c[m, c, x, c', y] = sum_{a,b} R_c[a,x] B2[c,a,c',b] R_c'[b,y]
    m = mesh.triangles.shape[0]
    b2 = assembly.a2_blocks(mesh).astype(dtype).reshape(m, 3, 2, 3, 2)
    b2c = jnp.einsum("mcax,mcadb,mdby->mcxdy", rc, b2, rc, precision=_HIGHEST)
    a2c = kreduce.apply_reduce(
        tables.asm_plan, b2c.reshape(1, -1))[0].reshape(nc2, nc2)

    # a1_k: coarse-projected factors Rg (T, M, 3, 2); local block is
    # w[c,c'] Rg_c Rg_c'^T with w = (A/12) * (1 + delta_{cc'}).
    # a1_mode:
    #   'full' — exact per-frame coarse data term (strongest correction; the
    #            assembly reduction runs over all T frames);
    #   'mean' — time-averaged data term, ONE shared coarse matrix: ~T x
    #            cheaper to build/invert and the correction becomes a single
    #            shared-matrix matmul; iteration counts rise only mildly
    #            because the coarse space mainly carries the smooth a2
    #            near-kernel;
    #   'none' — lambda*a2 only (frame-independent regularization term).
    t = g.shape[0]
    rg = jnp.einsum("tmca,mcab->tmcb", g, rc,
                    precision=_HIGHEST)  # (T, M, 3, 2)
    w = (jnp.ones((3, 3), dtype) + jnp.eye(3, dtype=dtype)) \
        * (mesh.areas.astype(dtype)[:, None, None] / 12.0)     # (M, 3, 3)
    if a1_mode == "full":
        b1c = jnp.einsum("tmxy,tmuv,mxu->tmxyuv", rg, rg, w,
                         precision=_HIGHEST)  # (T,M,3,2,3,2)
        a1c = kreduce.apply_reduce(
            tables.asm_plan, b1c.reshape(t, -1)).reshape(t, nc2, nc2)
        ac = a1c + lambda_ * a2c[None]
    elif a1_mode == "mean":
        b1c = jnp.einsum("tmxy,tmuv,mxu->mxyuv", rg, rg, w,
                         precision=_HIGHEST) / t
        a1c = kreduce.apply_reduce(
            tables.asm_plan, b1c.reshape(1, -1)).reshape(nc2, nc2)
        ac = (a1c + lambda_ * a2c)[None]
    elif a1_mode == "none":
        ac = (lambda_ * a2c)[None]
    else:
        raise ValueError(f"unknown a1_mode {a1_mode!r}")
    # Tiny ridge keeps the factorization safe if some R_v happen to be
    # nearly singular (tangent plane ~ orthogonal to the seed's).
    scale = jnp.max(jnp.abs(jnp.diagonal(ac, axis1=-2, axis2=-1)),
                    axis=-1)
    ridge = (1e-6 * scale)[:, None, None] * jnp.eye(nc2, dtype=dtype)[None]
    return ac + ridge, r_blk


def make_two_level(mesh: TriMesh, g: jnp.ndarray, lambda_,
                   tables: CoarseTables,
                   a1_mode: str = "full") -> TwoLevelPrecond:
    """Build the two-level preconditioner for the operator defined by g."""
    from manifold_flow_tpu.fem.operator import block_jacobi_inverse

    diag = block_jacobi_inverse(mesh, g, lambda_)
    ac, r_blk = coarse_matrices(mesh, g, lambda_, tables, a1_mode=a1_mode)
    # Explicit inverse via Cholesky: two triangular solves against I at build
    # time; the iteration loop then only does batched matmuls.
    chol = jnp.linalg.cholesky(ac)
    eye = jnp.broadcast_to(jnp.eye(ac.shape[-1], dtype=ac.dtype), ac.shape)
    linv = jax.lax.linalg.triangular_solve(
        chol, eye, left_side=True, lower=True)
    ac_inv = jnp.einsum("tki,tkj->tij", linv, linv,
                        preferred_element_type=ac.dtype, precision=_HIGHEST)
    # Fall back to plain Jacobi (identity coarse term of size 0 is awkward in
    # fixed shapes, so instead zero the correction) if the factorization
    # failed: NaNs in chol -> zero ac_inv.
    bad = jnp.any(jnp.isnan(linv), axis=(-2, -1), keepdims=True)
    ac_inv = jnp.where(bad, jnp.zeros_like(ac_inv), ac_inv)
    return TwoLevelPrecond(diag=diag, r_blk=r_blk, agg=tables.agg,
                           members=tables.members, ac_inv=ac_inv,
                           n_coarse=tables.n_coarse)
