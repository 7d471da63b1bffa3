"""Winding-number ("winding line") analysis around singularities.

Batched redesign of S7_winding_line.py: concentric vertex rings come from the
masked BFS (`geometry.topology.bfs_levels` — replacing PyVista
`point_neighbors_levels`, S7:131); each ring's winding number is computed
with masked sorts and gathers at fixed capacity N, vmapped over rings and
query points.

Per ring (calculate_winding_numbers, S7:120-165):
  * project ring-vertex positions and velocities into the center vertex's
    tangent basis;
  * sort by polar angle atan2(y, x) (sort_by_polar_angle_anticlockwise,
    S7:93-102 — the reference sorts about the origin; its cx, cy arguments
    are unused);
  * winding number = sum of signed angles between consecutive velocity
    vectors / 2 pi (winding_number + angle_between_vectors, S7:59-87).

Ring 1 fixes the expected type: +1 (node/focus) if w in [0.99, 1.01], -1
(saddle) if w in [-1.01, -0.99] (S7:150-158); subsequent rings count while
|w -/+ 1| <= 0.001 (check_property, S7:104-118 — note the tighter tolerance)
and the count stops at the first failure.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from manifold_flow_tpu.geometry.mesh import TriMesh
from manifold_flow_tpu.geometry.tangent import (
    express_on_basis,
    position_diff_on_basis,
    project_to_plane,
)
from manifold_flow_tpu.geometry import topology


class WindingResult(NamedTuple):
    counts: jnp.ndarray        # (..., S) rings with persistent winding number
    types: jnp.ndarray         # (..., S) +1 node/focus, -1 saddle, 0 unmatched
    winding_numbers: jnp.ndarray  # (..., S, L) per-ring winding numbers


def ring_winding_number(uv: jnp.ndarray, vxy: jnp.ndarray,
                        mask: jnp.ndarray) -> jnp.ndarray:
    """Winding number of the 2-D field `vxy` (N, 2) over the masked ring.

    `uv` (N, 2) are in-plane positions (sort key), `mask` (N,) selects ring
    members. Masked entries sort to the end; the circular pairing wraps at
    the valid count.
    """
    big = jnp.asarray(1e30, dtype=uv.dtype)
    key = jnp.where(mask, jnp.arctan2(uv[:, 1], uv[:, 0]), big)
    order = jnp.argsort(key)
    vs = vxy[order]                        # (N, 2) sorted, invalid at end
    k = jnp.sum(mask)
    idx = jnp.arange(mask.shape[0])
    nxt = jnp.where(idx + 1 < k, idx + 1, 0)
    v1 = vs
    v2 = vs[nxt]

    def unit(v):
        nrm = jnp.linalg.norm(v, axis=-1, keepdims=True)
        return v / jnp.where(nrm > 0, nrm, 1.0)

    u1, u2 = unit(v1), unit(v2)
    dot = jnp.clip(jnp.sum(u1 * u2, axis=-1), -1.0, 1.0)
    ang = jnp.arccos(dot)
    cross = u1[:, 0] * u2[:, 1] - u1[:, 1] * u2[:, 0]
    ang = jnp.where(cross < 0, -ang, ang)
    ang = jnp.where(idx < k, ang, 0.0)
    return jnp.sum(ang) / (2.0 * jnp.pi)


def _signed_angle(u1: jnp.ndarray, u2: jnp.ndarray) -> jnp.ndarray:
    """Signed angle u1 -> u2 for unit 2-vectors (..., 2), sign from the cross
    product (angle_between_vectors, S7:59-74)."""
    dot = jnp.clip(jnp.sum(u1 * u2, axis=-1), -1.0, 1.0)
    ang = jnp.arccos(dot)
    cross = u1[..., 0] * u2[..., 1] - u1[..., 1] * u2[..., 0]
    return jnp.where(cross < 0, -ang, ang)


class _RingTables(NamedTuple):
    """Frame-INDEPENDENT per-center tables: the ring structure and the polar
    sort order depend only on (mesh, center), so they are computed once per
    distinct center and reused by every frame that queries it
    (analyze_singularities_movie)."""

    order: jnp.ndarray   # (N,) permutation: rings 1..L anticlockwise, rest last
    same: jnp.ndarray    # (N-1,) sorted pair (i, i+1) lies within one ring
    bounds: jnp.ndarray  # (L+1,) ring r occupies sorted slice [b[r-1], b[r])
    e1: jnp.ndarray      # (3,) center tangent basis
    e2: jnp.ndarray      # (3,)


def _ring_tables(mesh: TriMesh, center: jnp.ndarray, max_level: int,
                 dtype) -> _RingTables:
    """ONE argsort serves every ring: vertices sort by the composite key
    (ring level, polar angle), which groups each ring contiguously in
    anticlockwise order (the naive formulation — a full masked sort per
    ring, 25 sorts per singularity — made winding the slowest stage). Ring
    boundaries in the sorted order come from one vectorized searchsorted."""
    levels = topology.bfs_levels(mesh.vertex_neighbors, center, max_level)
    e1 = mesh.basis[center, 0].astype(dtype)
    e2 = mesh.basis[center, 1].astype(dtype)
    uv = position_diff_on_basis(mesh.points[center].astype(dtype),
                                mesh.points.astype(dtype), e1, e2)
    theta = jnp.arctan2(uv[:, 1], uv[:, 0])                   # (-pi, pi]
    in_ring = (levels >= 1) & (levels <= max_level)
    frac = (theta + jnp.pi) / (2.0 * jnp.pi + 1e-6)           # [0, 1)
    key = jnp.where(in_ring, levels.astype(dtype) + frac,
                    jnp.asarray(jnp.inf, dtype))
    order = jnp.argsort(key)
    lvl_s = jnp.where(in_ring, levels, -1)[order]             # (N,)
    same = (lvl_s[:-1] == lvl_s[1:]) & (lvl_s[:-1] >= 1)
    # Sorted levels with the non-ring tail mapped past max_level: ascending,
    # so every ring's [start, end) slice is a pair of searchsorted bounds.
    ls2 = jnp.where(lvl_s < 0, max_level + 1, lvl_s)
    bounds = jnp.searchsorted(ls2, jnp.arange(1, max_level + 2))
    return _RingTables(order=order, same=same, bounds=bounds, e1=e1, e2=e2)


def _profile_from_tables(v_world_frame: jnp.ndarray,
                         tabs: _RingTables) -> jnp.ndarray:
    """Winding numbers (L,) of one frame over precomputed ring tables.

    Rings are contiguous in the sorted order, so the per-ring sum of
    consecutive signed velocity-angle differences is a difference of two
    prefix-sum samples (one (N,) cumsum replaces the previous (L, N)
    one-hot contraction and (L, N) masked min/max reductions), and the
    circular closure
    term pairs each ring's last sorted member with its first.
    """
    n = v_world_frame.shape[0]
    vproj = project_to_plane(v_world_frame, tabs.e1, tabs.e2)
    vxy = express_on_basis(vproj, tabs.e1, tabs.e2)
    vs = vxy[tabs.order]
    nrm = jnp.linalg.norm(vs, axis=-1, keepdims=True)
    us = vs / jnp.where(nrm > 0, nrm, 1.0)

    pair_ang = _signed_angle(us[:-1], us[1:])                 # (N-1,)
    pair_ang = jnp.where(tabs.same, pair_ang, 0.0)
    prefix = jnp.concatenate(
        [jnp.zeros((1,), pair_ang.dtype), jnp.cumsum(pair_ang)])  # (N,)

    first = tabs.bounds[:-1]                                  # (L,)
    end = tabs.bounds[1:]
    count = end - first
    sums = jnp.where(count >= 1,
                     prefix[jnp.maximum(end - 1, 0)] - prefix[first], 0.0)
    f = jnp.clip(first, 0, n - 1)
    l = jnp.clip(end - 1, 0, n - 1)
    closure = jnp.where(count >= 2, _signed_angle(us[l], us[f]), 0.0)
    return (sums + closure) / (2.0 * jnp.pi)


@partial(jax.jit, static_argnames=("max_level",))
def winding_profile(mesh: TriMesh, v_world_frame: jnp.ndarray,
                    center: jnp.ndarray, max_level: int = 25) -> jnp.ndarray:
    """Winding numbers (max_level,) for rings 1..max_level around `center`.

    `v_world_frame` is one frame's (N, 3) field; `center` a vertex index.
    Ring tables (_ring_tables) + prefix-sum profile (_profile_from_tables).
    """
    tabs = _ring_tables(mesh, center, max_level, v_world_frame.dtype)
    return _profile_from_tables(v_world_frame, tabs)


def _count_and_type(w: jnp.ndarray):
    """Ring-persistence count + type from a (L,) winding profile."""
    w0 = w[0]
    is_pos = (w0 >= 0.99) & (w0 <= 1.01)
    is_neg = (w0 >= -1.01) & (w0 <= -0.99)
    typ = jnp.where(is_pos, 1, jnp.where(is_neg, -1, 0))
    target = typ.astype(w.dtype)
    ok = (w[1:] >= target - 0.001) & (w[1:] <= target + 0.001) & (typ != 0)
    # Count consecutive successes from ring 2 onward.
    consec = jnp.cumprod(ok.astype(jnp.int32))
    count = jnp.where(typ != 0, 1 + jnp.sum(consec), 0)
    return count.astype(jnp.int32), typ.astype(jnp.int32)


def scale_map(mesh: TriMesh, singularity_points, counts) -> jnp.ndarray:
    """Per-vertex winding-line 'scale' field for visualization (N,).

    Reference calculate_scale_values (S7_winding_line.py:167-183): the
    snapped center vertex of singularity i gets counts[i] + 1; its k-th
    neighbor ring (k = 1..counts[i]) gets counts[i] - (k - 1). Later
    singularities overwrite earlier ones on overlap, as in the reference's
    sequential assignment.

    One device program for the whole list: the BFS vmaps over centers, each
    singularity's candidate values form one row of a (S, N) array, and the
    sequential-overwrite rule becomes a per-vertex "last nonzero row wins"
    select (per-singularity dispatch would pay the call latency S times
    over).
    """
    pts = jnp.asarray(singularity_points)
    counts = jnp.asarray(counts)
    if pts.shape[0] == 0:
        return jnp.zeros((mesh.n_vertices,), dtype=jnp.float32)
    max_count = max(int(jnp.max(counts)), 1)  # one host sync, sizes the BFS
    return _scale_values(mesh, pts, counts, max_count)


# Module-level jit (mesh is a pytree argument): a per-call closure would
# retrace on every scale_map invocation.
@partial(jax.jit, static_argnames=("max_level",))
def _scale_values(mesh, points_q, cnts, max_level):
    centers = topology.closest_vertex(mesh.points, points_q,
                                      n_valid=mesh.valid_vertices)
    levels = jax.vmap(
        lambda c: topology.bfs_levels(mesh.vertex_neighbors, c,
                                      max_level))(centers)   # (S, N)
    c = cnts[:, None].astype(jnp.float32)
    ring = jnp.where((levels >= 1) & (levels <= cnts[:, None]),
                     c - (levels.astype(jnp.float32) - 1.0), 0.0)
    vals = jax.vmap(lambda row, ctr, cc: row.at[ctr].set(cc + 1.0))(
        ring, centers, cnts.astype(jnp.float32))             # (S, N)
    # Last singularity whose value is nonzero wins (the reference's
    # sequential overwrite); argmax of the row index among nonzero rows.
    s = vals.shape[0]
    written = vals != 0.0
    last = jnp.argmax(
        jnp.where(written, jnp.arange(s)[:, None], -1), axis=0)  # (N,)
    out = jnp.take_along_axis(vals, last[None, :], axis=0)[0]
    return jnp.where(jnp.any(written, axis=0), out, 0.0)


@partial(jax.jit, static_argnames=("max_level",))
def analyze_singularities(mesh: TriMesh, v_world_frame: jnp.ndarray,
                          points: jnp.ndarray, valid: jnp.ndarray,
                          max_level: int = 25) -> WindingResult:
    """Winding analysis for one frame's singularity list.

    points: (S, 3) fixed-capacity singularity coordinates; valid: (S,) mask.
    Each point is snapped to its closest REAL vertex (S7:130; padding
    vertices are excluded) before ring construction. Invalid slots return
    count 0 / type 0.
    """
    centers = topology.closest_vertex(mesh.points, points,
                                      n_valid=mesh.valid_vertices)

    def one(center):
        tabs = _ring_tables(mesh, center, max_level, v_world_frame.dtype)
        w = _profile_from_tables(v_world_frame, tabs)
        count, typ = _count_and_type(w)
        return count, typ, w

    counts, types, ws = jax.vmap(one)(centers)
    zero = jnp.int32(0)
    return WindingResult(
        counts=jnp.where(valid, counts, zero),
        types=jnp.where(valid, types, zero),
        winding_numbers=jnp.where(valid[:, None], ws, 0.0),
    )


def snap_and_dedup_centers(mesh: TriMesh, points, valid, centers=None):
    """Host-side center snap + dedup shared by the single-device and the
    frames-sharded winding movie paths.

    points: (T, S, 3) fixed-capacity singularity coordinates; valid: (T, S).
    `centers` (T, S) optionally supplies precomputed snapped center vertex
    ids (singularity.compact_detected). Returns (uniq_padded (Ucap,) int32 —
    distinct snapped centers padded to a bucket of 8, and u_idx (T, S) int32
    mapping each slot to its unique-center row; invalid slots map
    arbitrarily and must stay masked by the caller)."""
    import numpy as np

    q = np.asarray(points, dtype=np.float64)
    t, s = q.shape[0], q.shape[1]
    vmask = np.asarray(valid, dtype=bool)
    if centers is not None:
        centers = np.asarray(centers, dtype=np.int32).reshape(t, s)
    else:
        # Host-side snap fallback (resume paths whose singularity points
        # come from a pickle without centers) via the GEMM distance
        # expansion: argmin_p |q - p|^2 = argmin_p (|p|^2 - 2 q.p), the
        # |q|^2 row constant dropped, in float32 (one GEMM instead of the
        # naive (T*S, N, 3) broadcast). f32 scoring resolves the argmin
        # safely: competing vertices
        # differ by O(edge length^2) while the f32 error is
        # ~eps * |coords|^2, orders of magnitude smaller.
        pts32 = np.asarray(mesh.points, dtype=np.float64).astype(np.float32)
        q32 = q.reshape(-1, 3).astype(np.float32)
        pn = (pts32 * pts32).sum(-1)
        pn[int(mesh.valid_vertices):] = np.inf
        score = pn[None, :] - 2.0 * (q32 @ pts32.T)
        centers = score.argmin(axis=1).astype(np.int32).reshape(t, s)

    uniq = np.unique(centers[vmask])
    u_cap = max(-(-len(uniq) // 8) * 8, 8)
    uniq_p = np.concatenate(
        [uniq, np.full(u_cap - len(uniq), uniq[0], np.int32)]).astype(
            np.int32)
    u_idx = np.searchsorted(uniq, centers.reshape(-1)).clip(0, len(uniq) - 1)
    u_idx = u_idx.astype(np.int32).reshape(t, s)  # invalid slots are masked
    return uniq_p, u_idx


def select_slots_host(cu, tu, wu, u_idx, vmask) -> WindingResult:
    """Host-side slot selection over per-center movie results: map each
    (frame, slot) to its unique center's row, masking invalid slots to
    zero. Shared by the memory-capped chunked grid path here and the
    frames-sharded path (parallel.analysis.sharded_winding_movie)."""
    import numpy as np

    t = u_idx.shape[0]
    ti = np.arange(t)[:, None]
    counts = np.where(vmask, cu[u_idx, ti], 0).astype(np.int32)
    types = np.where(vmask, tu[u_idx, ti], 0).astype(np.int32)
    ws = np.where(vmask[..., None], wu[u_idx, ti], 0.0)
    return WindingResult(counts=jnp.asarray(counts),
                         types=jnp.asarray(types),
                         winding_numbers=jnp.asarray(ws))


def analyze_singularities_movie(mesh: TriMesh, v_world, points, valid,
                                max_level: int = 25,
                                centers=None) -> WindingResult:
    """Winding analysis of the whole movie in one device program.

    points: (T, S, 3) fixed-capacity singularity coordinates per frame;
    valid: (T, S); returns a WindingResult with (T, S) leading dims.
    `centers` (T, S) optionally supplies the snapped center vertex per
    slot (the detection stage computes them on device for free,
    singularity.compact_detected) — the host GEMM snap below is then
    skipped entirely.

    Singularities persist across frames (the same source/saddle drifts
    slowly), so the T*S queries snap to only a handful of DISTINCT center
    vertices — and the expensive per-center work (25-level BFS + the
    composite-key argsort) is frame-independent (_ring_tables). The host
    deduplicates the snapped centers, the device builds one table set per
    unique center (padded to a bucket of 8 so cohort sweeps reuse the
    compiled program), and every (frame, singularity) slot just gathers its
    center's tables and runs the cheap prefix-sum profile (the naive
    formulation rebuilt rings and re-sorted for all T*S slots).
    """
    import numpy as np

    t, s = np.shape(points)[0], np.shape(points)[1]
    vmask = np.asarray(valid, dtype=bool)
    if t * s == 0 or not vmask.any():
        shape = (t, s)
        return WindingResult(
            counts=jnp.zeros(shape, jnp.int32),
            types=jnp.zeros(shape, jnp.int32),
            winding_numbers=jnp.zeros(shape + (max_level,), jnp.float32))
    uniq_p, u_idx = snap_and_dedup_centers(mesh, points, vmask,
                                           centers=centers)
    u_cap = len(uniq_p)
    # Two device formulations (identical results):
    #  * grid — profile every (unique center, frame) pair. The sorted-order
    #    gather becomes index-shared across frames (streaming access), at
    #    the cost of computing U*T profiles instead of the <= T*S valid
    #    slots.
    #  * slot — profile only the (frame, slot) pairs; every slot pays a
    #    private N-element gather at pointer-chase throughput.
    # Grid wins while U*T's streaming passes undercut T*S chase gathers,
    # i.e. while U stays below _GRID_CHASE_RATIO x S — but its vmapped
    # (U, T, N, 2) intermediates must also fit in device memory (a few live
    # at once), so huge unique-center counts fall back to slots.
    v = jnp.asarray(v_world)
    n = mesh.n_vertices
    chunk = (_GRID_MAX_ELEMS // (t * n)) // 8 * 8
    if u_cap <= _GRID_CHASE_RATIO * s and chunk >= 8:
        if u_cap <= chunk:
            return _analyze_movie_grid(
                mesh, v, jnp.asarray(uniq_p), jnp.asarray(u_idx),
                jnp.asarray(vmask), max_level=max_level)
        # Memory-capped grid: CHUNK the unique centers so each device call's
        # (Uc, T, N) intermediates fit, instead of falling all the way to
        # the per-slot chase-gather path (at 12.5k vertices the unique
        # centers trip the cap). When even an 8-center chunk would exceed
        # the cap (huge T*N), the memory-safe slots path below takes over.
        # All chunks dispatch first; the fetches start async and
        # materialize after (a blocking fetch would serialize the next
        # chunk's dispatch behind a device->host round trip). Selection to
        # (T, S) slots happens on host over the concatenated per-center
        # results.
        from manifold_flow_tpu.utils.io import start_host_copy

        parts = []
        for lo in range(0, u_cap, chunk):
            hi = min(lo + chunk, u_cap)
            pad_to = max(8, -(-(hi - lo) // 8) * 8)
            ids = np.full(pad_to, uniq_p[0], np.int32)
            ids[: hi - lo] = uniq_p[lo:hi]
            out = _grid_centers_program(mesh, v, jnp.asarray(ids),
                                        max_level=max_level)
            parts.append((hi - lo, out))
        for _, out in parts:
            start_host_copy(*out)
        cu = np.concatenate([np.asarray(o[0])[:k] for k, o in parts])
        tu = np.concatenate([np.asarray(o[1])[:k] for k, o in parts])
        wu = np.concatenate([np.asarray(o[2])[:k] for k, o in parts])
        return select_slots_host(cu, tu, wu, u_idx, vmask)
    return _analyze_movie_slots(
        mesh, v, jnp.asarray(uniq_p), jnp.asarray(u_idx),
        jnp.asarray(vmask), max_level=max_level)


# Grid-vs-slots crossover: the ratio of a chase-class gather's per-element
# cost to a streaming pass's. The value was chosen on an earlier
# accelerator and awaits re-tuning on the GPU (ROADMAP C7).
_GRID_CHASE_RATIO = 20
# Grid memory ceiling: a (U, T, N) float32 cell grid with 2-3 component
# channels and a few live intermediates costs ~10 * 4 bytes per element;
# 2^26 elements keeps the peak well under a 16 GB device.
_GRID_MAX_ELEMS = 1 << 26


@partial(jax.jit, static_argnames=("max_level",))
def _analyze_movie_slots(mesh, v_world, centers_u, u_idx, valid, max_level):
    dtype = v_world.dtype
    tabs = jax.vmap(
        lambda c: _ring_tables(mesh, c, max_level, dtype))(centers_u)

    def frame(vf, u_row, ok_row):
        def one(u, ok):
            t1 = _RingTables(*(a[u] for a in tabs))
            w = _profile_from_tables(vf, t1)
            count, typ = _count_and_type(w)
            zero = jnp.int32(0)
            return (jnp.where(ok, count, zero), jnp.where(ok, typ, zero),
                    jnp.where(ok, w, 0.0))

        return jax.vmap(one)(u_row, ok_row)

    counts, types, ws = jax.vmap(frame)(v_world, u_idx, valid)
    return WindingResult(counts=counts, types=types, winding_numbers=ws)


@partial(jax.jit, static_argnames=("max_level",))
def _grid_centers_program(mesh, v_world, centers_u, max_level):
    """Per-center winding results over the whole movie: (U, T) counts and
    types plus (U, T, L) profiles — the grid formulation WITHOUT the
    slot selection, so memory-capped callers can chunk the center axis
    (analyze_singularities_movie) and select on host."""
    dtype = v_world.dtype
    t = v_world.shape[0]
    n = v_world.shape[1]
    tabs = jax.vmap(
        lambda c: _ring_tables(mesh, c, max_level, dtype))(centers_u)

    def per_center(tab):
        vproj = project_to_plane(v_world, tab.e1, tab.e2)      # (T, N, 3)
        vxy = express_on_basis(vproj, tab.e1, tab.e2)          # (T, N, 2)
        vs = vxy[:, tab.order]           # one index vector for all T frames
        nrm = jnp.linalg.norm(vs, axis=-1, keepdims=True)
        us = vs / jnp.where(nrm > 0, nrm, 1.0)
        pair_ang = _signed_angle(us[:, :-1], us[:, 1:])        # (T, N-1)
        pair_ang = jnp.where(tab.same[None], pair_ang, 0.0)
        prefix = jnp.concatenate(
            [jnp.zeros((t, 1), pair_ang.dtype),
             jnp.cumsum(pair_ang, axis=1)], axis=1)            # (T, N)
        first = tab.bounds[:-1]
        end = tab.bounds[1:]
        count = end - first
        sums = jnp.where(count[None] >= 1,
                         prefix[:, jnp.maximum(end - 1, 0)]
                         - prefix[:, first], 0.0)              # (T, L)
        f = jnp.clip(first, 0, n - 1)
        l = jnp.clip(end - 1, 0, n - 1)
        closure = jnp.where(count[None] >= 2,
                            _signed_angle(us[:, l], us[:, f]), 0.0)
        w = (sums + closure) / (2.0 * jnp.pi)                  # (T, L)
        cnt, typ = jax.vmap(_count_and_type)(w)
        return cnt, typ, w

    return jax.vmap(per_center)(tabs)           # (U, T), (U, T), (U, T, L)


@partial(jax.jit, static_argnames=("max_level",))
def _analyze_movie_grid(mesh, v_world, centers_u, u_idx, valid, max_level):
    t = v_world.shape[0]
    cu, tu, wu = _grid_centers_program(mesh, v_world, centers_u,
                                       max_level=max_level)
    ti = jnp.arange(t)[:, None]
    counts = cu[u_idx, ti]                      # (T, S)
    types = tu[u_idx, ti]
    ws = wu[u_idx, ti]
    zero = jnp.int32(0)
    return WindingResult(
        counts=jnp.where(valid, counts, zero),
        types=jnp.where(valid, types, zero),
        winding_numbers=jnp.where(valid[..., None], ws, 0.0))
