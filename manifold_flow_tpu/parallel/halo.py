"""Halo-exchange vertex-block mesh partition: the mesh axis shards MEMORY.

The first-generation mesh-axis scheme (partition.py history) partitioned
triangles but kept every CG vector mesh-replicated, psum-ing full (T, 2N)
vectors each matvec — FLOPs sharded, memory did not. This module implements
the real thing (SURVEY.md §5.7): vertices partition into blocks (recursive
coordinate bisection), each device owns the DOF/iterate/preconditioner rows
of its block (~2N / n_mesh + halo), and the only per-matvec communication is
an all_gather of BLOCK-BOUNDARY vertex values (the halo), not a sum over the
full DOF space.

Ghost-triangle construction: every triangle touching an owned vertex is
present locally, so each owned vertex's matvec/RHS/diagonal row is complete
without any reverse exchange — one collective per matvec (the halo gather of
x), plus tiny psums for CG dot products. Triangles replicated on several
shards carry a single ASSEMBLY owner for quantities that psum over the mesh
axis (the coarse-grid matrices) so nothing double-counts.

The refined solver (f32 inner PCG + f64 residuals, solve/refine.py) runs
on the same layout: halo exchange copies values exactly (no summation), so
large meshes get mesh-sharded memory AND direct-solver accuracy.

Per-device working set (solve loop): x, r, z, p at (T_local, 2 V_own) plus a
(T_local, H, 2) halo buffer — asserted < N in tests/test_parallel.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from manifold_flow_tpu.geometry.mesh import TriMesh
from manifold_flow_tpu.kernels import reduce as kreduce

# f32 contractions run at full f32 precision (no TF32 on GPUs).
_HIGHEST = jax.lax.Precision.HIGHEST


def partition_vertices(points: np.ndarray, n_shards: int) -> np.ndarray:
    """Owner shard per vertex via recursive coordinate bisection.

    Splits the widest bounding-box axis at the balanced quantile, recursing
    into floor/ceil halves — O(N log N), deterministic, block boundaries
    ~ O(sqrt(N / n_shards)) on surface meshes (the halo traffic).
    """
    points = np.asarray(points)
    owner = np.zeros(points.shape[0], dtype=np.int32)

    def rec(ids, lo, hi):
        k = hi - lo
        if k <= 1:
            owner[ids] = lo
            return
        k1 = k // 2
        pts = points[ids]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, ax], kind="stable")
        cut = int(round(len(ids) * k1 / k))
        rec(ids[order[:cut]], lo, lo + k1)
        rec(ids[order[cut:]], lo + k1, hi)

    rec(np.arange(points.shape[0]), 0, n_shards)
    return owner


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloPartition:
    """Host-precomputed partition tables, stacked (n_shards, ...) so each
    row shards over the 'mesh' axis of a device mesh.

    Local vertex index space per shard (size v_local = v_owned + v_halo):
    slots [0, n_owned) hold owned vertices, [v_owned, v_owned + n_halo) hold
    halo vertices; the remainder is padding. Local DOF layout mirrors the
    global one: dof = slot + v_local * alpha.

      owner        (N,)            owning shard per global vertex
      owned_slot   (N,)            owned-slot index per global vertex
      owned_ids    (S, Vo)         global vertex per owned slot (pad N)
      tri_ids      (S, Ml)         global triangle per local slot (pad M)
      tri_corners  (S, Ml, 3)      global corner ids (pad N)
      dof_local    (S, Ml, 6)      local DOF ids into x_full (pad 0)
      base6        (S, Vo, C)      owned-vertex reduction table over local
                                   (cell*6 + slot*2) positions (pad Ml*6)
      base3        (S, Vo, C)      ditto for 3-slot diagonal reduction
      send_idx     (S, B)          owned slots published to the halo ring
      halo_src     (S, H)          flat (shard*B + pos) index per halo slot
                                   into the all_gathered buffer (pad S*B)
      asm_w        (S, Ml)         1.0 where this shard is the triangle's
                                   unique assembly owner, else 0.0
    """

    owner: jnp.ndarray
    owned_slot: jnp.ndarray
    owned_ids: jnp.ndarray
    tri_ids: jnp.ndarray
    tri_corners: jnp.ndarray
    dof_local: jnp.ndarray
    base6: jnp.ndarray
    base3: jnp.ndarray
    send_idx: jnp.ndarray
    halo_src: jnp.ndarray
    asm_w: jnp.ndarray
    n_shards: int = dataclasses.field(default=1, metadata=dict(static=True))
    v_owned: int = dataclasses.field(default=0, metadata=dict(static=True))
    v_halo: int = dataclasses.field(default=0, metadata=dict(static=True))
    m_local: int = dataclasses.field(default=0, metadata=dict(static=True))
    b_send: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def v_local(self) -> int:
        return self.v_owned + self.v_halo


_PARTITION_CACHE: dict = {}


def _content_key(*arrays) -> str:
    """Content digest of host arrays — cache keys must not use id():
    CPython recycles object ids, and pad_mesh deliberately buckets different
    surfaces into identical shapes, so a stale id hit would silently return
    another mesh's tables."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def build_partition(mesh: TriMesh, n_shards: int) -> HaloPartition:
    """Build (and cache) the halo partition tables for `mesh`.

    Host-side numpy, once per (mesh content, n_shards); requires concrete
    topology.
    """
    key = (_content_key(mesh.triangles, mesh.points), n_shards)
    hit = _PARTITION_CACHE.get(key)
    if hit is not None:
        return hit
    points = np.asarray(mesh.points)
    tris = np.asarray(mesh.triangles)
    n = points.shape[0]
    m = tris.shape[0]
    owner = partition_vertices(points, n_shards)

    owned_lists = [np.where(owner == s)[0] for s in range(n_shards)]
    vo = max(max(len(o) for o in owned_lists), 1)
    owned_slot = np.zeros(n, dtype=np.int32)
    for o in owned_lists:
        owned_slot[o] = np.arange(len(o), dtype=np.int32)

    tri_shard = owner[tris]                                  # (M, 3)
    tri_lists = [np.where((tri_shard == s).any(axis=1))[0]
                 for s in range(n_shards)]
    ml = max(max(len(tl) for tl in tri_lists), 1)
    asm_owner = tri_shard[:, 0]                              # unique owner

    halo_lists = []
    for s in range(n_shards):
        corners = np.unique(tris[tri_lists[s]])
        halo_lists.append(np.sort(corners[owner[corners] != s]))
    vh = max(max((len(h) for h in halo_lists), default=0), 1)
    vl = vo + vh

    # Send lists: owned vertices any other shard needs.
    needed = np.zeros(n, dtype=bool)
    for h in halo_lists:
        needed[h] = True
    send_lists = [owned_lists[s][needed[owned_lists[s]]]
                  for s in range(n_shards)]
    b = max(max((len(sl) for sl in send_lists), default=0), 1)
    send_pos = np.full(n, -1, dtype=np.int64)                # flat buffer pos
    for s, sl in enumerate(send_lists):
        send_pos[sl] = s * b + np.arange(len(sl))

    owned_ids = np.full((n_shards, vo), n, dtype=np.int32)
    tri_ids = np.full((n_shards, ml), m, dtype=np.int32)
    tri_corners = np.full((n_shards, ml, 3), n, dtype=np.int32)
    dof_local = np.zeros((n_shards, ml, 6), dtype=np.int32)
    send_idx = np.zeros((n_shards, b), dtype=np.int32)
    halo_src = np.full((n_shards, vh), n_shards * b, dtype=np.int32)
    asm_w = np.zeros((n_shards, ml), dtype=np.float32)

    cmax = 1
    incid = []
    for s in range(n_shards):
        o, tl, h = owned_lists[s], tri_lists[s], halo_lists[s]
        owned_ids[s, : len(o)] = o
        tri_ids[s, : len(tl)] = tl
        tri_corners[s, : len(tl)] = tris[tl]
        local_of = np.full(n, 0, dtype=np.int32)             # pad target 0
        local_of[o] = np.arange(len(o), dtype=np.int32)
        local_of[h] = vo + np.arange(len(h), dtype=np.int32)
        corners_local = local_of[tris[tl]]                   # (Ms, 3)
        dof_local[s, : len(tl)] = (
            corners_local[:, :, None]
            + vl * np.arange(2, dtype=np.int32)).reshape(len(tl), 6)
        send_idx[s, : len(send_lists[s])] = owned_slot[send_lists[s]]
        halo_src[s, : len(h)] = send_pos[h]
        asm_w[s, : len(tl)] = (asm_owner[tl] == s).astype(np.float32)

        # Owned-vertex incidence over LOCAL triangle slots.
        inc = [[] for _ in range(len(o))]
        for j, tri in enumerate(tris[tl]):
            for slot, v in enumerate(tri):
                if owner[v] == s:
                    inc[owned_slot[v]].append((j, slot))
        incid.append(inc)
        cmax = max(cmax, max((len(x) for x in inc), default=1))

    base6 = np.full((n_shards, vo, cmax), ml * 6, dtype=np.int32)
    base3 = np.full((n_shards, vo, cmax), ml * 3, dtype=np.int32)
    for s in range(n_shards):
        for v, lst in enumerate(incid[s]):
            for c, (j, slot) in enumerate(lst):
                base6[s, v, c] = j * 6 + slot * 2
                base3[s, v, c] = j * 3 + slot

    part = HaloPartition(
        owner=jnp.asarray(owner), owned_slot=jnp.asarray(owned_slot),
        owned_ids=jnp.asarray(owned_ids), tri_ids=jnp.asarray(tri_ids),
        tri_corners=jnp.asarray(tri_corners),
        dof_local=jnp.asarray(dof_local),
        base6=jnp.asarray(base6), base3=jnp.asarray(base3),
        send_idx=jnp.asarray(send_idx), halo_src=jnp.asarray(halo_src),
        asm_w=jnp.asarray(asm_w),
        n_shards=n_shards, v_owned=vo, v_halo=vh, m_local=ml, b_send=b)
    _PARTITION_CACHE[key] = part
    return part


# --------------------------------------------------------------------------
# Shard-local operator (one mesh shard's view; runs inside shard_map)
# --------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloOperator:
    """A = a1 + lambda a2 restricted to one vertex block, with halo exchange.

    All arrays are the LOCAL row of the stacked partition tables plus the
    shard's triangle-local numeric data. `matvec` takes and returns owned
    DOF vectors (T, 2 Vo); the halo gather of boundary x values over
    `axis_name` is the only collective.
    """

    dof: jnp.ndarray        # (Ml, 6) local DOF ids
    blocks2: jnp.ndarray    # (Ml, 6, 6)
    g: jnp.ndarray          # (T, Ml, 3, 2)
    w_scale: jnp.ndarray    # (Ml,)
    lambda_: jnp.ndarray    # ()
    base6: jnp.ndarray      # (Vo, C)
    send_idx: jnp.ndarray   # (B,)
    halo_src: jnp.ndarray   # (H,)
    v_owned: int = dataclasses.field(default=0, metadata=dict(static=True))
    v_halo: int = dataclasses.field(default=0, metadata=dict(static=True))
    axis_name: str = dataclasses.field(default="mesh",
                                       metadata=dict(static=True))

    def exchange(self, x: jnp.ndarray) -> jnp.ndarray:
        """Owned (T, 2 Vo) -> full local (T, 2 Vl) via halo gather.

        Traffic per call: (T, 2, B) values all_gathered over the mesh
        axis — the block boundary, not the DOF space.
        """
        vo, vh = self.v_owned, self.v_halo
        t = x.shape[0]
        xs = x.reshape(t, 2, vo)
        pub = jnp.take(xs, self.send_idx, axis=2)            # (T, 2, B)
        buf = jax.lax.all_gather(pub, self.axis_name)        # (S, T, 2, B)
        buf = jnp.moveaxis(buf, 0, 2).reshape(t, 2, -1)      # (T, 2, S*B)
        buf = jnp.concatenate([buf, jnp.zeros((t, 2, 1), x.dtype)], axis=2)
        halo = jnp.take(buf, self.halo_src, axis=2)          # (T, 2, H)
        full = jnp.concatenate([xs, halo], axis=2)           # (T, 2, Vl)
        return full.reshape(t, 2 * (vo + vh))

    def local_contributions(self, x_full: jnp.ndarray) -> jnp.ndarray:
        """Per-triangle products (T, Ml, 6) of A x on the local block."""
        t = x_full.shape[0]
        ml = self.dof.shape[0]
        xg = x_full[:, self.dof]                             # (T, Ml, 6)
        y2 = jnp.einsum("mij,tmj->tmi", self.blocks2, xg, precision=_HIGHEST)
        xg32 = xg.reshape(t, ml, 3, 2)
        s = jnp.sum(self.g * xg32, axis=-1)
        stot = jnp.sum(s, axis=-1, keepdims=True)
        w = self.w_scale[:, None] * (s + stot)
        y1 = self.g * w[..., None]
        return self.lambda_ * y2 + y1.reshape(t, ml, 6)

    def reduce_owned(self, y_loc: jnp.ndarray) -> jnp.ndarray:
        """(T, Ml, 6) local contributions -> owned DOF vector (T, 2 Vo)."""
        t = y_loc.shape[0]
        y_flat = jnp.concatenate(
            [y_loc.reshape(t, -1), jnp.zeros((t, 2), y_loc.dtype)], axis=1)
        c0 = jnp.take(y_flat, self.base6, axis=1)            # (T, Vo, C)
        c1 = jnp.take(y_flat, self.base6 + 1, axis=1)
        return jnp.concatenate([c0.sum(-1), c1.sum(-1)], axis=-1)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.reduce_owned(self.local_contributions(self.exchange(x)))


def _local_factors(potentials, d_i, tri_corners, grad_l, basis_c):
    """Shard-local g (T, Ml, 3, 2) and RHS scale inputs from replicated
    (T, N+1) movies (zero pad column) and local triangle geometry."""
    i_tri = potentials[:, tri_corners]                       # (T, Ml, 3)
    grad_m = jnp.einsum("tmc,mcd->tmd", i_tri, grad_l,
                        precision=_HIGHEST)  # (T, Ml, 3)
    g = jnp.einsum("tmd,mcad->tmca", grad_m, basis_c,
                   precision=_HIGHEST)  # (T, Ml, 3, 2)
    di_tri = d_i[:, tri_corners]                             # (T, Ml, 3)
    return g, di_tri


def _rhs_owned(op: HaloOperator, g, di_tri, areas_l):
    s = jnp.sum(di_tri, axis=-1, keepdims=True)
    scale = (di_tri + s) * (areas_l / 12.0)[:, None]
    f_loc = g * scale[..., None]                             # (T, Ml, 3, 2)
    t = f_loc.shape[0]
    return op.reduce_owned(f_loc.reshape(t, -1, 6))


def _diag_owned(g, basis_c, grad_l, areas_l, lambda_, base3):
    """Inverted per-owned-vertex 2x2 Jacobi blocks (T, Vo, 2, 2)."""
    from manifold_flow_tpu.fem.operator import invert_2x2_blocks

    et = basis_c.astype(g.dtype)
    ee = jnp.einsum("mcad,mcbd->mcab", et, et, precision=_HIGHEST)
    gg = jnp.sum(grad_l * grad_l, axis=-1).astype(g.dtype)
    reg = ee * (gg * areas_l[:, None])[:, :, None, None]
    dat = jnp.einsum("tmca,tmcb->tmcab", g, g, precision=_HIGHEST) \
        * (areas_l / 6.0)[:, None, None, None]
    contrib = lambda_ * reg[None] + dat                      # (T, Ml, 3, 2, 2)
    t, ml = contrib.shape[0], contrib.shape[1]
    flat = jnp.concatenate(
        [contrib.reshape(t, ml * 3, 4), jnp.zeros((t, 1, 4), contrib.dtype)],
        axis=1)
    diag = jnp.take(flat, base3, axis=1).sum(axis=2)         # (T, Vo, 4)
    return invert_2x2_blocks(diag.reshape(t, -1, 2, 2))


def owned_to_global(part: HaloPartition, x_stacked: jnp.ndarray,
                    n_vertices: int) -> jnp.ndarray:
    """(T, S * 2 Vo) stacked owned vectors -> global (T, 2N) DOF layout."""
    t = x_stacked.shape[0]
    x3 = x_stacked.reshape(t, part.n_shards, 2, part.v_owned)
    sh, sl = part.owner, part.owned_slot
    x1 = x3[:, sh, 0, sl]                                    # (T, N)
    x2 = x3[:, sh, 1, sl]
    return jnp.concatenate([x1, x2], axis=-1)


def global_to_owned(part: HaloPartition, x: jnp.ndarray) -> jnp.ndarray:
    """Global (T, 2N) -> stacked owned (T, S, 2 Vo) (pads read zero)."""
    t = x.shape[0]
    n = part.owner.shape[0]
    xp = jnp.concatenate([x, jnp.zeros((t, 1), x.dtype)], axis=1)
    idx1 = jnp.where(part.owned_ids < n, part.owned_ids, 2 * n)  # (S, Vo)
    comp1 = xp[:, idx1]                                      # (T, S, Vo)
    idx2 = jnp.where(part.owned_ids < n, part.owned_ids + n, 2 * n)
    comp2 = xp[:, idx2]
    return jnp.stack([comp1, comp2], axis=2).reshape(
        t, part.n_shards, 2 * part.v_owned)


def _local_geometry(mesh: TriMesh, part: HaloPartition, dtype):
    """Per-shard triangle geometry, stacked (S, ...): gathered once from the
    mesh arrays (padded triangles/corners hit appended zero rows, so their
    contributions vanish identically)."""
    zero3 = jnp.zeros((1, 3, 3), mesh.grad_w.dtype)
    grad_l = jnp.concatenate([mesh.grad_w, zero3])[part.tri_ids]
    areas_l = jnp.concatenate(
        [mesh.areas, jnp.zeros((1,), mesh.areas.dtype)])[part.tri_ids]
    basis_pad = jnp.concatenate(
        [mesh.basis, jnp.zeros((1, 2, 3), mesh.basis.dtype)])
    basis_c = basis_pad[part.tri_corners]                    # (S, Ml, 3, 2, 3)
    gg = jnp.einsum("smid,smjd->smij", grad_l, grad_l, precision=_HIGHEST)
    ee = jnp.einsum("smiad,smjbd->smiajb", basis_c, basis_c,
                    precision=_HIGHEST)
    blocks2 = (ee * gg[:, :, :, None, :, None]
               * areas_l[:, :, None, None, None, None])
    s, ml = part.n_shards, part.m_local
    return (grad_l.astype(dtype), areas_l.astype(dtype),
            basis_c.astype(dtype), blocks2.reshape(s, ml, 6, 6).astype(dtype))


def _pad_frames(x: jnp.ndarray, nf: int) -> jnp.ndarray:
    pad = (-x.shape[0]) % nf
    if pad == 0:
        return x
    return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))


def halo_compute_velocity_fields(
    mesh: TriMesh,
    potentials: jnp.ndarray,
    times: jnp.ndarray,
    device_mesh: Mesh,
    lambda_: float = 0.01,
    tol: float = 1e-10,
    max_iter: int = 2000,
    precond: str = "auto",
):
    """Mesh-memory-sharded batched PCG velocity solve.

    Frames shard over 'frames' (data parallel); the DOF space shards over
    'mesh' in owned vertex blocks. Per iteration: one halo all_gather of
    boundary x values + three scalar psums (CG dots) — no (T, 2N) collective
    anywhere, and no (T, 2N) array on any device.

    precond: 'jacobi', 'two_level' (aggregation coarse correction, assembled
    distributed: each shard reduces its owned triangles' coarse blocks and
    one (2Nc)^2 psum combines them), or 'auto' (solve.api crossover rule).

    Returns a solve.api.VelocityResult in the global DOF layout.
    """
    from manifold_flow_tpu.solve.api import (
        TWO_LEVEL_MIN_VERTICES,
        VelocityResult,
    )
    from manifold_flow_tpu.solve.cg import solve_cg

    potentials = jnp.asarray(potentials)
    times = jnp.asarray(times, dtype=potentials.dtype)
    nf = device_mesh.shape["frames"]
    nm = device_mesh.shape["mesh"]
    part = build_partition(mesh, nm)
    dtype = potentials.dtype
    t = potentials.shape[0] - 1
    vo, vh, ml = part.v_owned, part.v_halo, part.m_local
    lam = jnp.asarray(lambda_, dtype=dtype)

    if precond == "auto":
        precond = ("two_level" if mesh.n_vertices >= TWO_LEVEL_MIN_VERTICES
                   else "jacobi")
    tables = plans = members = agg_owned = None
    if precond == "two_level":
        from manifold_flow_tpu.solve import coarse

        tables = coarse.build_tables(mesh)
        plans, members, agg_owned = _coarse_partition_tables(
            mesh, part, tables)
    elif precond != "jacobi":
        raise ValueError(f"unknown precond {precond!r}")

    def run(pot, tms):
        dt = (tms[1:] - tms[:-1])[:, None]
        d_i = (pot[1:] - pot[:-1]) / dt
        zcol = jnp.zeros((t, 1), dtype)
        potp = _pad_frames(jnp.concatenate([pot[:-1], zcol], axis=1), nf)
        dip = _pad_frames(jnp.concatenate([d_i, zcol], axis=1), nf)
        grad_l, areas_l, basis_c, blocks2 = _local_geometry(mesh, part, dtype)

        if tables is not None:
            ebar = mesh.basis[tables.seeds].astype(dtype)    # (Nc, 2, 3)
            r_blk = jnp.einsum("nad,nbd->nab", mesh.basis.astype(dtype),
                               ebar[tables.agg],
                               precision=_HIGHEST)           # (N, 2, 2)
            r_pad = jnp.concatenate(
                [r_blk, jnp.zeros((1, 2, 2), dtype)])
            rc_l = r_pad[part.tri_corners]                   # (S, Ml, 3, 2, 2)
            r_blk_o = r_pad[part.owned_ids]                  # (S, Vo, 2, 2)
            pp_s, sg_s, dg_s, n_vals, group = plans
            coarse_in = (rc_l, r_blk_o, members, agg_owned,
                         pp_s, sg_s, dg_s)
        else:
            coarse_in = ()

        def local_solve(tc, gr, ar, bc, b2, dof, b6, b3, snd, hsrc, asw,
                        pp, dd, *cz):
            g, di_tri = _local_factors(pp, dd, tc[0], gr[0], bc[0])
            op = HaloOperator(
                dof=dof[0], blocks2=b2[0], g=g, w_scale=ar[0] / 12.0,
                lambda_=lam, base6=b6[0], send_idx=snd[0], halo_src=hsrc[0],
                v_owned=vo, v_halo=vh)
            f = _rhs_owned(op, g, di_tri, ar[0])
            diag = _diag_owned(g, bc[0], gr[0], ar[0], lam, b3[0])
            if cz:
                rc_s, rbo_s, mem_s, agg_s, pp_l, sg_l, dg_l = cz
                plan = kreduce.ReducePlan(
                    pad_perm=pp_l[0], slot_groups=sg_l[0],
                    dense_gather=dg_l[0], n_vals=n_vals, group=group)
                ac_inv = _coarse_inverse_local(
                    g, rc_s[0], b2[0], ar[0], asw[0], lam, plan,
                    tables.n_coarse)
                pre = HaloTwoLevel(
                    diag=diag, r_blk=rbo_s[0], agg=agg_s[0],
                    members=mem_s[0], ac_inv=ac_inv,
                    n_coarse=tables.n_coarse)
            else:
                pre = diag
            res = solve_cg(op, f, precond=pre, tol=tol, max_iter=max_iter,
                           psum_axis="mesh")
            return res.x, res.iterations[None], res.residual, res.converged

        ms = P("mesh")
        shard = jax.shard_map(
            local_solve, mesh=device_mesh,
            in_specs=(ms,) * 11 + (P("frames"), P("frames"))
            + (ms,) * len(coarse_in),
            out_specs=(P("frames", "mesh"), P("frames"), P("frames"),
                       P("frames")),
            check_vma=False)
        x, iters, resid, conv = shard(
            part.tri_corners, grad_l, areas_l, basis_c, blocks2,
            part.dof_local, part.base6, part.base3, part.send_idx,
            part.halo_src, part.asm_w, potp, dip, *coarse_in)
        x_global = owned_to_global(part, x[:t], mesh.n_vertices)
        return x_global, iters, resid[:t], conv[:t]

    x, iters, resid, conv = jax.jit(run)(potentials, times)
    return VelocityResult(v_k=x, e=mesh.basis, iterations=jnp.max(iters),
                          residual=resid, converged=conv)


# --------------------------------------------------------------------------
# Two-level preconditioner under the halo partition
# --------------------------------------------------------------------------
def _stacked_reduce_plans(flat_rows, n_out: int, group: int = 8):
    """Per-shard ReducePlans padded to COMMON shapes and stacked (S, ...).

    Each shard assembles its local triangles' coarse contributions with its
    own plan; shard_map needs one program, so the per-shard tables pad to the
    max sizes with sentinels remapped to the common zero slots (pad_perm ->
    n_vals, slot_groups -> G, dense_gather -> U).
    """
    plans = [kreduce.build_reduce_plan_np(fi, n_out, group)
             for fi in flat_rows]
    n_vals = plans[0][3]
    assert all(p[3] == n_vals for p in plans)
    l_common = max(p[0].shape[0] for p in plans)
    l_common = -(-l_common // group) * group
    g_common = l_common // group
    u_common = max(p[1].shape[0] for p in plans)
    kg_common = max(p[1].shape[1] for p in plans)
    pps, sgs, dgs = [], [], []
    for pad_perm, slot_groups, dense_gather, _ in plans:
        g_s = pad_perm.shape[0] // group
        u_s = slot_groups.shape[0]
        pp = np.full(l_common, n_vals, dtype=np.int32)
        pp[: pad_perm.shape[0]] = pad_perm
        sg = np.full((u_common, kg_common), g_common, dtype=np.int32)
        sg_fix = np.where(slot_groups == g_s, g_common, slot_groups)
        sg[: u_s, : slot_groups.shape[1]] = sg_fix
        dg = np.where(dense_gather == u_s, u_common,
                      dense_gather).astype(np.int32)
        pps.append(pp)
        sgs.append(sg)
        dgs.append(dg)
    return (jnp.asarray(np.stack(pps)), jnp.asarray(np.stack(sgs)),
            jnp.asarray(np.stack(dgs)), n_vals, group)


_COARSE_CACHE: dict = {}


def _coarse_partition_tables(mesh: TriMesh, part: HaloPartition, tables):
    """Halo-layout coarse tables: per-shard assembly plans + owned-member
    restriction tables (host-side, cached per (mesh, n_shards))."""
    key = (_content_key(mesh.triangles, tables.agg), part.n_shards)
    hit = _COARSE_CACHE.get(key)
    if hit is not None:
        return hit
    agg = np.asarray(tables.agg)
    nc = tables.n_coarse
    tris = np.asarray(mesh.triangles)
    tri_ids = np.asarray(part.tri_ids)
    m = tris.shape[0]
    ml = part.m_local
    flat_rows = []
    for s in range(part.n_shards):
        tl = tri_ids[s]
        corners = np.where(tl[:, None] < m, tris[np.minimum(tl, m - 1)], 0)
        cdof = 2 * agg[corners][:, :, None] + np.arange(2)   # (Ml, 3, 2)
        rows = cdof[:, :, :, None, None]
        cols = cdof[:, None, None, :, :]
        flat_rows.append((rows * (2 * nc) + cols).reshape(-1))
    plans = _stacked_reduce_plans(flat_rows, (2 * nc) ** 2)

    # Owned-member table per shard: (S, Nc, Kl) owned slots, sentinel Vo.
    owner = np.asarray(part.owner)
    owned_slot = np.asarray(part.owned_slot)
    n = owner.shape[0]
    kl = 1
    members_list = []
    for s in range(part.n_shards):
        rows_s = [[] for _ in range(nc)]
        for v in range(n):
            if owner[v] == s:
                rows_s[agg[v]].append(int(owned_slot[v]))
        kl = max(kl, max((len(r) for r in rows_s), default=1))
        members_list.append(rows_s)
    members = np.full((part.n_shards, nc, kl), part.v_owned, dtype=np.int32)
    for s, rows_s in enumerate(members_list):
        for a, r in enumerate(rows_s):
            members[s, a, : len(r)] = r
    agg_pad = np.concatenate([agg, [0]]).astype(np.int32)
    agg_owned = agg_pad[np.minimum(np.asarray(part.owned_ids), n)]
    hit = (plans, jnp.asarray(members), jnp.asarray(agg_owned))
    _COARSE_CACHE[key] = hit
    return hit


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloTwoLevel:
    """Two-level preconditioner on the owned DOF block (solve/coarse.py
    semantics; one tiny (T, 2Nc) psum per application).

    diag     (T, Vo, 2, 2)  inverted local Jacobi blocks
    r_blk    (Vo, 2, 2)     prolongation blocks at owned vertices
    agg      (Vo,)          aggregate id per owned slot
    members  (Nc, Kl)       owned slots per aggregate (sentinel Vo)
    ac_inv   (T, 2Nc, 2Nc)  replicated coarse inverses
    """

    diag: jnp.ndarray
    r_blk: jnp.ndarray
    agg: jnp.ndarray
    members: jnp.ndarray
    ac_inv: jnp.ndarray
    n_coarse: int = dataclasses.field(default=0, metadata=dict(static=True))
    axis_name: str = dataclasses.field(default="mesh",
                                       metadata=dict(static=True))

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        from manifold_flow_tpu.fem.operator import apply_block_diag

        z_fine = apply_block_diag(self.diag, r)
        t = r.shape[0]
        vo = self.r_blk.shape[0]
        r1, r2 = r[:, :vo], r[:, vo:]
        r00, r01 = self.r_blk[:, 0, 0], self.r_blk[:, 0, 1]
        r10, r11 = self.r_blk[:, 1, 0], self.r_blk[:, 1, 1]
        q1 = r00 * r1 + r10 * r2
        q2 = r01 * r1 + r11 * r2
        zero = jnp.zeros((t, 1), dtype=r.dtype)
        rc1 = jnp.take(jnp.concatenate([q1, zero], axis=1), self.members,
                       axis=1).sum(axis=2)                   # (T, Nc)
        rc2 = jnp.take(jnp.concatenate([q2, zero], axis=1), self.members,
                       axis=1).sum(axis=2)
        rc = jnp.stack([rc1, rc2], axis=-1).reshape(t, -1)   # (T, 2Nc)
        rc = jax.lax.psum(rc, self.axis_name)
        yc = jnp.einsum("tij,tj->ti", self.ac_inv, rc,
                        preferred_element_type=rc.dtype, precision=_HIGHEST)
        ycr = yc.reshape(t, self.n_coarse, 2)
        ya = jnp.take(ycr[:, :, 0], self.agg, axis=1)        # (T, Vo)
        yb = jnp.take(ycr[:, :, 1], self.agg, axis=1)
        z1 = r00 * ya + r01 * yb
        z2 = r10 * ya + r11 * yb
        return z_fine + jnp.concatenate([z1, z2], axis=-1)


def _coarse_inverse_local(g, rc_l, blocks2_l, areas_l, asm_w, lam, plan,
                          n_coarse: int):
    """Per-frame coarse inverses (T, 2Nc, 2Nc), assembled from this shard's
    OWNED triangles (asm_w) and psum'd over 'mesh' (solve/coarse.py
    coarse_matrices, distributed)."""
    dtype = g.dtype
    nc2 = 2 * n_coarse
    t, ml = g.shape[0], g.shape[1]
    w_asm = asm_w.astype(dtype)
    b2 = blocks2_l.reshape(ml, 3, 2, 3, 2)
    b2c = jnp.einsum("mcax,mcadb,mdby->mcxdy", rc_l, b2, rc_l,
                     precision=_HIGHEST) \
        * w_asm[:, None, None, None, None]
    a2c = kreduce.apply_reduce(plan, b2c.reshape(1, -1))[0]
    rg = jnp.einsum("tmca,mcab->tmcb", g, rc_l,
                    precision=_HIGHEST)  # (T, Ml, 3, 2)
    w = (jnp.ones((3, 3), dtype) + jnp.eye(3, dtype=dtype)) \
        * (areas_l * w_asm)[:, None, None] / 12.0
    b1c = jnp.einsum("tmxy,tmuv,mxu->tmxyuv", rg, rg, w,
                     precision=_HIGHEST)
    a1c = kreduce.apply_reduce(plan, b1c.reshape(t, -1))
    ac = (a1c + lam * a2c[None]).reshape(t, nc2, nc2)
    ac = jax.lax.psum(ac, "mesh")
    scale = jnp.max(jnp.abs(jnp.diagonal(ac, axis1=-2, axis2=-1)), axis=-1)
    ridge = (1e-6 * scale)[:, None, None] * jnp.eye(nc2, dtype=dtype)[None]
    ac = ac + ridge
    chol = jnp.linalg.cholesky(ac)
    eye = jnp.broadcast_to(jnp.eye(nc2, dtype=dtype), ac.shape)
    linv = jax.lax.linalg.triangular_solve(chol, eye, left_side=True,
                                           lower=True)
    ac_inv = jnp.einsum("tki,tkj->tij", linv, linv,
                        preferred_element_type=dtype, precision=_HIGHEST)
    bad = jnp.any(jnp.isnan(linv), axis=(-2, -1), keepdims=True)
    return jnp.where(bad, jnp.zeros_like(ac_inv), ac_inv)


# --------------------------------------------------------------------------
# Refined solve under the halo partition
# --------------------------------------------------------------------------
def halo_refined_velocity_fields(
    mesh: TriMesh,
    potentials: jnp.ndarray,
    times: jnp.ndarray,
    device_mesh: Mesh,
    lambda_: float = 0.01,
    tol: float = 1e-8,
    inner_tol=None,
    max_iter: int = 2000,
    refine_steps: int = 8,
    precond: str = "auto",
):
    """Mesh-memory-sharded refined solve: f32 halo PCG inner iterations +
    f64 halo residuals, converging to direct-solver accuracy
    (solve/refine.py semantics on sharded DOF blocks). Requires f64 inputs.
    """
    from manifold_flow_tpu.solve.api import (
        TWO_LEVEL_MIN_VERTICES,
        VelocityResult,
    )
    from manifold_flow_tpu.solve.cg import solve_cg

    potentials = jnp.asarray(potentials)
    if potentials.dtype != jnp.float64:
        raise ValueError("halo refined solve needs float64 potentials; got "
                         f"{potentials.dtype}")
    times = jnp.asarray(times, dtype=jnp.float64)
    nf = device_mesh.shape["frames"]
    nm = device_mesh.shape["mesh"]
    part = build_partition(mesh, nm)
    t = potentials.shape[0] - 1
    vo, vh = part.v_owned, part.v_halo

    if precond == "auto":
        precond = ("two_level" if mesh.n_vertices >= TWO_LEVEL_MIN_VERTICES
                   else "jacobi")
    tables = plans = members = agg_owned = None
    if precond == "two_level":
        from manifold_flow_tpu.solve import coarse

        tables = coarse.build_tables(mesh)
        plans, members, agg_owned = _coarse_partition_tables(
            mesh, part, tables)
    elif precond != "jacobi":
        raise ValueError(f"unknown precond {precond!r}")

    lam64 = jnp.asarray(lambda_, jnp.float64)
    lam32 = jnp.asarray(lambda_, jnp.float32)
    # Per-outer-step inner tolerances (solve/refine.py semantics: scalar =
    # every step; a sequence's last entry repeats — tight-first schedules,
    # see solve_refined's docstring).
    from manifold_flow_tpu.solve.refine import (
        DEFAULT_INNER_TOL, as_inner_schedule)

    if inner_tol is None:
        inner_tol = DEFAULT_INNER_TOL
    inner_sched = np.asarray(as_inner_schedule(inner_tol), np.float32)

    def run(pot, tms):
        dt = (tms[1:] - tms[:-1])[:, None]
        d_i = (pot[1:] - pot[:-1]) / dt
        zcol = jnp.zeros((t, 1), jnp.float64)
        potp = _pad_frames(jnp.concatenate([pot[:-1], zcol], axis=1), nf)
        dip = _pad_frames(jnp.concatenate([d_i, zcol], axis=1), nf)
        grad_l, areas_l, basis_c, blocks2 = _local_geometry(
            mesh, part, jnp.float64)

        if tables is not None:
            ebar = mesh.basis[tables.seeds].astype(jnp.float32)
            r_blk = jnp.einsum(
                "nad,nbd->nab", mesh.basis.astype(jnp.float32),
                ebar[tables.agg], precision=_HIGHEST)
            r_pad = jnp.concatenate(
                [r_blk, jnp.zeros((1, 2, 2), jnp.float32)])
            rc_l = r_pad[part.tri_corners]
            r_blk_o = r_pad[part.owned_ids]
            pp_s, sg_s, dg_s, n_vals, group = plans
            coarse_in = (rc_l, r_blk_o, members, agg_owned,
                         pp_s, sg_s, dg_s)
        else:
            coarse_in = ()

        def local_solve(tc, gr, ar, bc, b2, dof, b6, b3, snd, hsrc, asw,
                        pp, dd, *cz):
            # f64 operator (the residual) and its f32 rounding (the inner
            # PCG); the halo exchange copies values exactly in either dtype.
            g64, di_tri64 = _local_factors(pp, dd, tc[0], gr[0], bc[0])
            op64 = HaloOperator(
                dof=dof[0], blocks2=b2[0], g=g64, w_scale=ar[0] / 12.0,
                lambda_=lam64, base6=b6[0], send_idx=snd[0],
                halo_src=hsrc[0], v_owned=vo, v_halo=vh)
            f64 = _rhs_owned(op64, g64, di_tri64, ar[0])
            f32 = jnp.float32
            op32 = dataclasses.replace(
                op64, blocks2=op64.blocks2.astype(f32), g=g64.astype(f32),
                w_scale=op64.w_scale.astype(f32), lambda_=lam32)
            diag = _diag_owned(op32.g, bc[0].astype(f32), gr[0].astype(f32),
                               ar[0].astype(f32), lam32, b3[0])
            if cz:
                rc_s, rbo_s, mem_s, agg_s, pp_l, sg_l, dg_l = cz
                plan = kreduce.ReducePlan(
                    pad_perm=pp_l[0], slot_groups=sg_l[0],
                    dense_gather=dg_l[0], n_vals=n_vals, group=group)
                ac_inv = _coarse_inverse_local(
                    op32.g, rc_s[0], op32.blocks2, ar[0].astype(f32),
                    asw[0], lam32, plan, tables.n_coarse)
                pre = HaloTwoLevel(
                    diag=diag, r_blk=rbo_s[0], agg=agg_s[0],
                    members=mem_s[0], ac_inv=ac_inv,
                    n_coarse=tables.n_coarse)
            else:
                pre = diag

            def pnorm(v):
                return jnp.sqrt(jax.lax.psum(jnp.sum(v * v, axis=-1),
                                             "mesh"))

            fnorm = pnorm(f64)
            target = tol * jnp.maximum(fnorm, jnp.finfo(f32).tiny)

            def cond(state):
                _, r, _, step = state
                return (step < refine_steps) & jnp.any(pnorm(r) > target)

            def body(state):
                x, r, total, step = state
                step_tol = jnp.asarray(inner_sched)[
                    jnp.minimum(step, inner_sched.shape[0] - 1)]
                inner = solve_cg(op32, r.astype(f32), precond=pre,
                                 tol=step_tol, max_iter=max_iter,
                                 psum_axis="mesh")
                x = x + inner.x.astype(x.dtype)
                r = f64 - op64.matvec(x)
                return x, r, total + inner.iterations, step + 1

            x, r, total, _ = jax.lax.while_loop(
                cond, body,
                (jnp.zeros_like(f64), f64, jnp.int32(0), jnp.int32(0)))
            rn = pnorm(r)
            return x, total[None], rn, rn <= target

        ms = P("mesh")
        shard = jax.shard_map(
            local_solve, mesh=device_mesh,
            in_specs=(ms,) * 11 + (P("frames"), P("frames"))
            + (ms,) * len(coarse_in),
            out_specs=(P("frames", "mesh"), P("frames"), P("frames"),
                       P("frames")),
            check_vma=False)
        x, iters, resid, conv = shard(
            part.tri_corners, grad_l, areas_l, basis_c, blocks2,
            part.dof_local, part.base6, part.base3, part.send_idx,
            part.halo_src, part.asm_w, potp, dip, *coarse_in)
        x_global = owned_to_global(part, x[:t], mesh.n_vertices)
        return x_global, iters, resid[:t], conv[:t]

    x, iters, resid, conv = jax.jit(run)(potentials, times)
    return VelocityResult(v_k=x, e=mesh.basis, iterations=jnp.max(iters),
                          residual=resid, converged=conv)
