"""Singularity detection and classification on velocity movies.

Batched redesign of utils/find_singularity_point.py:72-189 (detection) and
:355-498 (Jacobian classification): everything is computed for all vertices /
triangles / frames at once with masks, instead of per-frame Python loops; the
interior zero test solves the 2x2 least-squares system in closed form instead
of `np.linalg.lstsq`.

Outputs are fixed-capacity masked arrays; `compact_frame` converts one frame
back to reference-style Python lists on the host.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from manifold_flow_tpu.geometry.mesh import PAD_INDEX, TriMesh
from manifold_flow_tpu.geometry.tangent import (
    express_on_basis,
    position_diff_on_basis,
    project_to_plane,
    tangent_basis,
)

# f32 contractions run at full f32 precision (no TF32 on GPUs).
_HIGHEST = jax.lax.Precision.HIGHEST

# Classification codes (classify_critical_point,
# utils/find_singularity_point.py:463-498; the finer stable/unstable branches
# there are dead code after the early returns).
NODE, FOCUS, SADDLE, INDETERMINATE = 0, 1, 2, 3
CLASS_NAMES = ("Node", "Focus", "Saddle", "Indeterminate")


class SingularityField(NamedTuple):
    """Per-frame masked singularity data (leading axis = frames).

    vertex_mask    (T, N)  vertex singular (|v|/vmax <= eps)
    interior_mask  (T, M)  triangle-interior zero found
    interior_bary  (T, M, 2) (lam, mu) barycentric coords of the zero
    interior_point (T, M, 3) world coords of the interior zero
    v_max          (T,)    per-frame max |v| (the normalizer)
    """

    vertex_mask: jnp.ndarray
    interior_mask: jnp.ndarray
    interior_bary: jnp.ndarray
    interior_point: jnp.ndarray
    v_max: jnp.ndarray


@partial(jax.jit, static_argnames=("eps",))
def detect(mesh: TriMesh, v_world: jnp.ndarray, eps: float = 1e-4
           ) -> SingularityField:
    """Find singular vertices and triangle-interior zeros for all frames.

    v_world: (T, N, 3) world-frame velocity vectors (from velocity_to_world).
    eps: normalized-speed threshold (config.yaml:4).

    Mirrors find_singularity_points (utils/find_singularity_point.py:140-189):
    speeds are normalized by the per-frame max; triangles touching a singular
    vertex are skipped; the interior test projects corner velocities onto the
    triangle plane and solves [VA-VC, VB-VC] [lam, mu]^T = -VC in the
    least-squares sense, accepting lam >= 0, mu >= 0, lam + mu <= 1.

    On a padded mesh (geometry.mesh.pad_mesh), padding vertices/triangles are
    masked out of both outputs (their zero velocities would otherwise always
    flag as singular).
    """
    speeds = jnp.linalg.norm(v_world, axis=-1)             # (T, N)
    v_max = jnp.max(speeds, axis=-1)                       # (T,)
    vn = v_world / v_max[:, None, None]
    vertex_mask = (speeds / v_max[:, None]) <= eps         # (T, N)
    # Unconditional padding mask (all-true on unpadded meshes): the valid
    # count is a data leaf so it may be traced — no host branch on it.
    vertex_mask &= (jnp.arange(mesh.n_vertices)
                    < mesh.valid_vertices)[None, :]

    tri = mesh.triangles                                   # (M, 3)
    p = mesh.points[tri]                                   # (M, 3, 3)
    n = jnp.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.where(nn > 0, nn, 1.0)                     # (M, 3) unit

    vt = vn[:, tri]                                        # (T, M, 3c, 3d)
    vproj = vt - jnp.sum(vt * n[None, :, None, :], axis=-1, keepdims=True) * n[None, :, None, :]
    va, vb, vc = vproj[:, :, 0], vproj[:, :, 1], vproj[:, :, 2]
    c1 = va - vc                                           # (T, M, 3)
    c2 = vb - vc
    # Normal equations of the 3x2 least-squares system M x = -vc.
    a11 = jnp.sum(c1 * c1, axis=-1)
    a12 = jnp.sum(c1 * c2, axis=-1)
    a22 = jnp.sum(c2 * c2, axis=-1)
    b1 = -jnp.sum(c1 * vc, axis=-1)
    b2 = -jnp.sum(c2 * vc, axis=-1)
    det = a11 * a22 - a12 * a12
    safe = jnp.where(jnp.abs(det) > 0, det, 1.0)
    lam = (b1 * a22 - b2 * a12) / safe
    mu = (a11 * b2 - a12 * b1) / safe
    solvable = jnp.abs(det) > 0
    inside = (lam >= 0) & (mu >= 0) & (lam + mu <= 1)

    touches_singular = jnp.any(vertex_mask[:, tri], axis=-1)  # (T, M)
    interior_mask = solvable & inside & ~touches_singular
    interior_mask &= (jnp.arange(mesh.n_triangles)
                      < mesh.valid_triangles)[None, :]

    bary = jnp.stack([lam, mu], axis=-1)                   # (T, M, 2)
    w = jnp.stack([lam, mu, 1.0 - lam - mu], axis=-1)      # (T, M, 3)
    point = jnp.einsum("tmc,mcd->tmd", w, p, precision=_HIGHEST)
    return SingularityField(vertex_mask, interior_mask, bary, point, v_max)


def _jacobian_from_neighbors(origin, e1, e2, nb_points, nb_vel, nb_mask):
    """Accumulate the reference's finite-difference 2x2 Jacobian.

    For each neighbor: (u, v) = velocity expressed on (e1, e2) after
    projection; (d1, d2) = neighbor position difference on the basis;
    J += [[u/d1, u/d2], [v/d1, v/d2]]
    (compute_jacobian_matrix_for_vertex, utils/find_singularity_point.py:355-402).
    Zero-distance components contribute 0 (the reference would emit inf).
    """
    vp = project_to_plane(nb_vel, e1, e2)
    uv = express_on_basis(vp, e1, e2)                      # (..., D, 2)
    duv = position_diff_on_basis(origin, nb_points, e1, e2)
    inv = jnp.where(duv != 0, 1.0 / jnp.where(duv != 0, duv, 1.0), 0.0)
    contrib = uv[..., :, None] * inv[..., None, :]         # (..., D, 2, 2)
    contrib = jnp.where(nb_mask[..., None, None], contrib, 0.0)
    return jnp.sum(contrib, axis=-3)                       # (..., 2, 2)


def _nearest_edge(pt, pa, pb, pc, quirks: bool = False):
    """Index (0: AB, 1: BC, 2: CA) of the edge used for the across-edge
    neighbor triangle of an interior critical point at `pt`.

    quirks=False (default): true point-to-line distances, argmin over the 3
    edges. quirks=True: the reference's find_nearest_edge_and_vertices
    (utils/find_singularity_point.py:318-351), which builds the 3x3 array of
    |cross(P-A, B-A)| / |B-A| COMPONENT vectors, argmins over all 9 scalars,
    and maps the flat component index through {0: AB, 1: BC, else: CA} — so
    it selects AB/BC only when the very first/second component happens to be
    the global minimum, and CA otherwise. Reproduced for artifact parity.
    """
    def safe_norm(v):
        n = jnp.linalg.norm(v, axis=-1, keepdims=True)
        return jnp.maximum(n, 1e-300)

    if not quirks:
        def edge_dist(q, a, b):
            ab = b - a
            c = jnp.cross(q - a, ab)
            return jnp.linalg.norm(c, axis=-1) / safe_norm(ab)[..., 0]

        d = jnp.stack([edge_dist(pt, pa, pb), edge_dist(pt, pb, pc),
                       edge_dist(pt, pc, pa)], axis=-1)
        return jnp.argmin(d, axis=-1)
    c1 = jnp.cross(pt - pa, pb - pa) / safe_norm(pb - pa)
    c2 = jnp.cross(pt - pb, pc - pb) / safe_norm(pc - pb)
    c3 = jnp.cross(pt - pc, pa - pc) / safe_norm(pa - pc)
    d9 = jnp.abs(jnp.concatenate([c1, c2, c3], axis=-1))   # (..., 9)
    flat = jnp.argmin(d9, axis=-1)
    return jnp.where(flat == 0, 0, jnp.where(flat == 1, 1, 2))


def classify_jacobian(jac: jnp.ndarray) -> jnp.ndarray:
    """Trace/determinant classification -> codes (NODE/FOCUS/SADDLE/INDET)."""
    tr = jac[..., 0, 0] + jac[..., 1, 1]
    det = jac[..., 0, 0] * jac[..., 1, 1] - jac[..., 0, 1] * jac[..., 1, 0]
    node_or_focus = jnp.where(tr * tr > 4.0 * det, NODE, FOCUS)
    return jnp.where(det > 0, node_or_focus,
                     jnp.where(det < 0, SADDLE, INDETERMINATE)).astype(jnp.int32)


@jax.jit
def vertex_jacobians(mesh: TriMesh, v_world: jnp.ndarray,
                     v_max: jnp.ndarray) -> jnp.ndarray:
    """2x2 Jacobians (T, N, 2, 2) at every vertex (select singular ones later).

    Velocities are normalized by the frame max as in the reference (:387).
    """
    vn = v_world / v_max[:, None, None]
    nb = mesh.vertex_neighbors                             # (N, D)
    nb_mask = nb != PAD_INDEX
    nb_safe = jnp.where(nb_mask, nb, 0)
    nb_points = mesh.points[nb_safe]                       # (N, D, 3)
    nb_vel = vn[:, nb_safe]                                # (T, N, D, 3)
    e1 = mesh.basis[:, 0][None, :, None, :]
    e2 = mesh.basis[:, 1][None, :, None, :]
    origin = mesh.points[None, :, None, :]
    return _jacobian_from_neighbors(
        origin, e1, e2, nb_points[None], nb_vel, nb_mask[None])


@partial(jax.jit, static_argnames=("quirks",))
def interior_jacobians(mesh: TriMesh, v_world: jnp.ndarray, v_max: jnp.ndarray,
                       interior_point: jnp.ndarray,
                       quirks: bool = False) -> jnp.ndarray:
    """2x2 Jacobians (T, M, 2, 2) for triangle-interior critical points.

    Mirrors compute_jacobian_matrix_for_interior
    (utils/find_singularity_point.py:405-460): the basis comes from the flat
    triangle normal; the neighbor set is the triangle's corners plus the
    corners of the neighbor triangle across the edge nearest to the critical
    point. Deviations from the reference, both deliberate:
      * nearest edge uses true point-to-edge distances by default
        (quirks=True reproduces the reference's flat-component argmin,
        see _nearest_edge);
      * the across-edge neighbor is the unique edge-adjacent triangle (the
        reference pops an arbitrary member of a VTK line-intersection set).
    """
    tri = mesh.triangles
    p = mesh.points[tri]                                   # (M, 3, 3)
    nrm = jnp.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    nrm = nrm / jnp.where(
        jnp.linalg.norm(nrm, axis=-1, keepdims=True) > 0,
        jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1.0)
    e = tangent_basis(nrm)                                 # (M, 2, 3)

    pt = interior_point                                    # (T, M, 3)
    nearest = _nearest_edge(pt, p[None, :, 0], p[None, :, 1],
                            p[None, :, 2], quirks=quirks)  # (T, M)
    edge_corner = jnp.array([[0, 1], [1, 2], [2, 0]])
    ca = jnp.take_along_axis(
        tri[None], edge_corner[nearest][..., 0:1], axis=-1)[..., 0]
    cb = jnp.take_along_axis(
        tri[None], edge_corner[nearest][..., 1:2], axis=-1)[..., 0]

    # Neighbor triangle across that edge (PAD -> fall back to self).
    from manifold_flow_tpu.geometry.topology import other_cell_across_edge

    cell_ids = jnp.arange(tri.shape[0])
    other = jax.vmap(
        jax.vmap(other_cell_across_edge, in_axes=(None, None, 0, 0, 0)),
        in_axes=(None, None, None, 0, 0),
    )(mesh.edges, mesh.edge_cells, cell_ids, ca, cb)       # (T, M)
    other_safe = jnp.where(other >= 0, other, cell_ids[None])

    nb_idx = jnp.concatenate(
        [jnp.broadcast_to(tri[None], (pt.shape[0], *tri.shape)),
         mesh.triangles[other_safe]], axis=-1)             # (T, M, 6)
    # Mask duplicate vertices (shared edge corners appear twice; the
    # reference takes a set union, so each vertex contributes once).
    first_occurrence = jnp.ones(nb_idx.shape, dtype=bool)
    for i in range(1, 6):
        dup = jnp.any(
            nb_idx[..., i:i + 1] == nb_idx[..., :i], axis=-1)
        first_occurrence = first_occurrence.at[..., i].set(~dup)

    vn = v_world / v_max[:, None, None]
    t_idx = jnp.arange(pt.shape[0])[:, None, None]
    nb_vel = vn[t_idx, nb_idx]                             # (T, M, 6, 3)
    nb_points = mesh.points[nb_idx]                        # (T, M, 6, 3)
    e1 = e[None, :, None, 0]
    e2 = e[None, :, None, 1]
    return _jacobian_from_neighbors(
        pt[:, :, None], e1, e2, nb_points, nb_vel, first_occurrence)


def classify(mesh: TriMesh, v_world: jnp.ndarray, field: SingularityField,
             quirks: bool = False):
    """Classification codes for vertex (T, N) and interior (T, M) candidates."""
    jv = vertex_jacobians(mesh, v_world, field.v_max)
    ji = interior_jacobians(mesh, v_world, field.v_max, field.interior_point,
                            quirks=quirks)
    return classify_jacobian(jv), classify_jacobian(ji)


class DetectedClasses(NamedTuple):
    vertex_ids: jnp.ndarray     # (T, S) candidate vertex ids (compacted)
    vertex_valid: jnp.ndarray   # (T, S) bool
    vertex_codes: jnp.ndarray   # (T, S) class codes
    interior_ids: jnp.ndarray   # (T, S) candidate triangle ids (compacted)
    interior_valid: jnp.ndarray  # (T, S) bool
    interior_codes: jnp.ndarray  # (T, S) class codes


@partial(jax.jit, static_argnames=("capacity", "quirks"))
def classify_detected(mesh: TriMesh, v_world: jnp.ndarray,
                      field: SingularityField,
                      capacity: int = 64,
                      quirks: bool = False) -> DetectedClasses:
    """Classify only the detected candidates, at fixed capacity per frame.

    The reference classifies each detected singularity
    (find_singularity_points_and_classify_for_all_Vk,
    utils/find_singularity_point.py:561-605); computing Jacobians at every
    vertex and triangle of every frame (`classify`) does ~N/S times more
    work than needed. Candidates compact to the first `capacity` slots per
    frame (choose capacity >= the per-frame maximum; pipeline.stages sizes
    it from the detection masks).
    """
    t = v_world.shape[0]
    t_col = jnp.arange(t)[:, None]
    vn = v_world / field.v_max[:, None, None]

    # ---- vertex candidates ----
    order_v = jnp.argsort(~field.vertex_mask, axis=1, stable=True)
    idx_v = order_v[:, :capacity]                            # (T, S)
    valid_v = jnp.take_along_axis(field.vertex_mask, idx_v, axis=1)
    nb = mesh.vertex_neighbors[idx_v]                        # (T, S, D)
    nb_mask = (nb != PAD_INDEX) & valid_v[..., None]
    nb_safe = jnp.where(nb_mask, nb, 0)
    nb_points = mesh.points[nb_safe]                         # (T, S, D, 3)
    nb_vel = vn[t_col[..., None], nb_safe]                   # (T, S, D, 3)
    e_sel = mesh.basis[idx_v]                                # (T, S, 2, 3)
    jv = _jacobian_from_neighbors(
        mesh.points[idx_v][:, :, None], e_sel[:, :, None, 0],
        e_sel[:, :, None, 1], nb_points, nb_vel, nb_mask)
    codes_v = classify_jacobian(jv)

    # ---- interior candidates ----
    order_i = jnp.argsort(~field.interior_mask, axis=1, stable=True)
    idx_i = order_i[:, :capacity]                            # (T, S)
    valid_i = jnp.take_along_axis(field.interior_mask, idx_i, axis=1)
    tri = mesh.triangles[idx_i]                              # (T, S, 3)
    p = mesh.points[tri]                                     # (T, S, 3, 3)
    nrm = jnp.cross(p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :])
    nl = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / jnp.where(nl > 0, nl, 1.0)
    e = tangent_basis(nrm)                                   # (T, S, 2, 3)
    pt = jnp.take_along_axis(field.interior_point, idx_i[..., None], axis=1)

    nearest = _nearest_edge(pt, p[..., 0, :], p[..., 1, :], p[..., 2, :],
                            quirks=quirks)                   # (T, S)
    edge_corner = jnp.array([[0, 1], [1, 2], [2, 0]])
    ca = jnp.take_along_axis(tri, edge_corner[nearest][..., 0:1], axis=-1)[..., 0]
    cb = jnp.take_along_axis(tri, edge_corner[nearest][..., 1:2], axis=-1)[..., 0]

    from manifold_flow_tpu.geometry.topology import other_cell_across_edge

    other = jax.vmap(jax.vmap(
        other_cell_across_edge, in_axes=(None, None, 0, 0, 0)),
        in_axes=(None, None, 0, 0, 0))(
            mesh.edges, mesh.edge_cells, idx_i, ca, cb)      # (T, S)
    other_safe = jnp.where(other >= 0, other, idx_i)
    nb_idx = jnp.concatenate([tri, mesh.triangles[other_safe]], axis=-1)
    first = jnp.ones(nb_idx.shape, dtype=bool)
    for i in range(1, 6):
        dup = jnp.any(nb_idx[..., i:i + 1] == nb_idx[..., :i], axis=-1)
        first = first.at[..., i].set(~dup)
    first = first & valid_i[..., None]
    nb_vel_i = vn[t_col[..., None], nb_idx]                  # (T, S, 6, 3)
    nb_points_i = mesh.points[nb_idx]
    ji = _jacobian_from_neighbors(
        pt[:, :, None], e[:, :, None, 0], e[:, :, None, 1],
        nb_points_i, nb_vel_i, first)
    codes_i = classify_jacobian(ji)

    return DetectedClasses(
        vertex_ids=idx_v, vertex_valid=valid_v, vertex_codes=codes_v,
        interior_ids=idx_i, interior_valid=valid_i, interior_codes=codes_i)


@jax.jit
def detection_counts(field: SingularityField):
    """Per-movie maximum per-frame candidate counts, as two scalars.

    Sizing a fixed capacity from the full masks would fetch ~1 MB at
    reference scale; this program reduces on device so the host fetches
    two ints. `initial=0` keeps a degenerate
    0-frame movie (e.g. a single-frame input upstream) well-defined:
    zero candidates, not a reduction-over-empty-axis error."""
    return (jnp.max(field.vertex_mask.sum(axis=1),
                    initial=0).astype(jnp.int32),
            jnp.max(field.interior_mask.sum(axis=1),
                    initial=0).astype(jnp.int32))


@partial(jax.jit, static_argnames=("eps",))
def detect_with_counts(mesh: TriMesh, v_world: jnp.ndarray,
                       eps: float = 1e-4):
    """detect + detection_counts fused into ONE device program (one
    dispatch instead of two; the pipeline stage always needs both). The
    counts come back as one (2,) array so the host pays a single
    scalar-fetch round trip."""
    field = detect(mesh, v_world, eps=eps)
    vc, ic = detection_counts(field)
    return field, jnp.stack([vc, ic])


class CompactDetections(NamedTuple):
    """Detections compacted to `capacity` slots per frame (device-side)."""

    vertex_ids: jnp.ndarray        # (T, S) int
    vertex_valid: jnp.ndarray      # (T, S) bool
    interior_ids: jnp.ndarray      # (T, S) int
    interior_valid: jnp.ndarray    # (T, S) bool
    interior_points: jnp.ndarray   # (T, S, 3)
    interior_centers: jnp.ndarray  # (T, S) nearest REAL vertex per point


@partial(jax.jit, static_argnames=("capacity",))
def compact_detected(mesh: TriMesh, field: SingularityField,
                     capacity: int = 16) -> CompactDetections:
    """Compact the detection masks to fixed-capacity id lists ON DEVICE.

    The full field carries (T, M, 3) interior points (~14 MB at reference
    scale) of which only the masked entries matter (~10^2); compacting on
    device before the host fetch turns a ~14 MB transfer into a ~40 KB
    one. Ids stay in ascending order per frame (stable argsort of
    the mask), matching np.where on the host.

    `interior_centers` snaps each compacted interior point to its nearest
    real vertex INSIDE this same program: downstream winding analysis
    needs the snapped center per singularity (S7:130), and computing it
    here makes it free (a host-side snap would serialize host work
    against the device pipeline per movie). Vertex candidates snap to
    themselves
    (vertex_ids)."""
    from manifold_flow_tpu.geometry.topology import closest_vertex

    order_v = jnp.argsort(~field.vertex_mask, axis=1, stable=True)
    idx_v = order_v[:, :capacity]
    valid_v = jnp.take_along_axis(field.vertex_mask, idx_v, axis=1)
    order_i = jnp.argsort(~field.interior_mask, axis=1, stable=True)
    idx_i = order_i[:, :capacity]
    valid_i = jnp.take_along_axis(field.interior_mask, idx_i, axis=1)
    pts_i = jnp.take_along_axis(field.interior_point, idx_i[..., None],
                                axis=1)
    centers_i = closest_vertex(mesh.points, pts_i,
                               n_valid=mesh.valid_vertices)
    return CompactDetections(
        vertex_ids=idx_v.astype(jnp.int32), vertex_valid=valid_v,
        interior_ids=idx_i.astype(jnp.int32), interior_valid=valid_i,
        interior_points=pts_i, interior_centers=centers_i)


def compact_capacity(field: SingularityField) -> int:
    """Fixed per-frame candidate capacity for the movie, rounded up to a
    bucket of 8 so cohort sweeps reuse one compiled compaction/classify
    program across trials with varying singularity counts."""
    vc, ic = detection_counts(field)
    cap = max(int(vc), int(ic), 1)
    return -(-cap // 8) * 8


def compact_all(mesh: TriMesh, field: SingularityField,
                capacity: int | None = None, with_centers: bool = False):
    """Host-side: every frame's masked arrays -> reference-style lists.

    Returns a list over frames of (points (S, 3), kinds (S,) str
    'vertex'/'interior', ids (S,)), vertices first then interiors, matching
    the ordering of find_singularity_points_for_all_Vk
    (utils/find_singularity_point.py:550-556). The masked arrays compact on
    device (`compact_detected`) so the fetch is ~capacity rows per frame,
    not the (T, M, 3) interior-point field — per-frame slicing of device
    arrays would cost an eager dispatch + transfer EACH.

    with_centers=True appends a 4th element per frame: the snapped center
    vertex id per singularity (device-computed, see compact_detected) —
    the winding stage's input, free here instead of a host-side snap."""
    import numpy as np

    if capacity is None:
        capacity = compact_capacity(field)
    det = compact_detected(mesh, field, capacity=capacity)
    from manifold_flow_tpu.utils.io import start_host_copy

    start_host_copy(*det)  # pipeline the six small fetches
    vid = np.asarray(det.vertex_ids)
    vok = np.asarray(det.vertex_valid)
    iid = np.asarray(det.interior_ids)
    iok = np.asarray(det.interior_valid)
    ipts = np.asarray(det.interior_points)
    icent = np.asarray(det.interior_centers)
    pts = np.asarray(mesh.points)
    out = []
    for k in range(vid.shape[0]):
        vsel = vid[k][vok[k]]
        isel = iid[k][iok[k]]
        rows = np.concatenate([pts[vsel], ipts[k][iok[k]]], axis=0)
        kinds = ["vertex"] * len(vsel) + ["interior"] * len(isel)
        ids = list(vsel) + list(isel)
        if with_centers:
            centers = np.concatenate([vsel, icent[k][iok[k]]]).astype(
                np.int32)
            out.append((rows, kinds, ids, centers))
        else:
            out.append((rows, kinds, ids))
    return out


def compact_frame(mesh: TriMesh, field: SingularityField, frame: int):
    """Host-side: one frame's masked arrays -> reference-style lists (see
    compact_all; prefer it when processing whole movies)."""
    import numpy as np

    vm = np.asarray(field.vertex_mask[frame])
    im = np.asarray(field.interior_mask[frame])
    pts = np.asarray(mesh.points)
    ipts = np.asarray(field.interior_point[frame])
    out_pts = [pts[i] for i in np.where(vm)[0]]
    kinds = ["vertex"] * len(out_pts)
    ids = list(np.where(vm)[0])
    for m in np.where(im)[0]:
        out_pts.append(ipts[m])
        kinds.append("interior")
        ids.append(m)
    if out_pts:
        return np.stack(out_pts), kinds, ids
    return np.zeros((0, 3)), kinds, ids
