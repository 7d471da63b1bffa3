"""Frames-sharded analysis stages (S3 detection, S5 wave speeds, S7 winding).

The distributed story used to cover only the solve; a multi-device trial would
have serialized every analysis stage on one device. These wrappers shard the
FRAME axis of the analysis ops over the ('frames', ...) device mesh with
jax.shard_map — the same layout the sharded solve uses, so a trial's velocity
movie can stay frame-sharded from solve through analysis:

  * detection (ops.singularity.detect) is a pure per-frame map — zero
    communication, each shard detects its frame block; the pipeline entry
    (sharded_detect_with_counts) fuses the capacity-sizing counts reduction
    into the SAME program, mirroring detect_with_counts' one-dispatch
    design;
  * wave speeds split into a cheap temporal-stencil part (needs +-2
    neighbor frames at shard boundaries — computed on the replicated movie,
    ~3 elementwise passes) and the expensive spatial-gradient part
    (~(6 cells x 3 corners + basis algebra) passes per frame), which shards
    cleanly per frame;
  * the winding profile grid shards its FRAME axis; the frame-independent
    ring tables (BFS + composite-key argsort per unique center) are
    rebuilt per shard — replicated compute, but it is the part that does
    NOT grow with T, while the sharded profile passes are the part that
    does. The center axis CHUNKS under the same per-device memory ceiling
    as the single-device op (ops.winding._GRID_MAX_ELEMS, applied to the
    LOCAL frame count).

Compiled programs cache per (mesh identity, device mesh, static params) —
a fresh jit(shard_map(...)) per call would re-trace every trial of a
cohort sweep.

The reference parallelized only the solve (multiprocessing.Pool,
utils/compute_optical_flow.py:152-194); these stages ran serial loops
(S5_compute_wave_v.py:264-300, S7_winding_line.py:205-261), so sharding
them is framework scope beyond reference parity (SURVEY.md §5.7/§5.8).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from manifold_flow_tpu.geometry.mesh import TriMesh
from manifold_flow_tpu.ops import singularity as sing_ops
from manifold_flow_tpu.ops import winding as wind_ops
from manifold_flow_tpu.ops.phase import (
    temporal_gradient_amplitude,
    temporal_gradient_phase,
)
from manifold_flow_tpu.ops.wavespeed import tangential_gradient_magnitude

# (key, mesh-pin) -> compiled callable. Pinned on a mesh leaf (id() keys
# can collide after garbage collection — same pattern as
# ops.streamline._BOUNDARY_CACHE); jax.jit's own cache handles shape
# variance once the callable object persists.
_PROGRAM_CACHE: dict = {}


def _cached_program(mesh: TriMesh, extra_key, builder):
    pin = mesh.vertex_neighbors
    key = (id(pin),) + tuple(extra_key)
    hit = _PROGRAM_CACHE.get(key)
    if hit is not None and hit[0] is pin:
        return hit[1]
    fn = builder()
    _PROGRAM_CACHE[key] = (pin, fn)
    while len(_PROGRAM_CACHE) > 32:
        _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
    return fn


def _pad_frames(x: jnp.ndarray, multiple: int) -> jnp.ndarray:
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths)


def _detect_program(mesh: TriMesh, device_mesh, eps: float, with_counts):
    def build():
        spec = P("frames")

        def local(v_l):
            return sing_ops.detect(mesh, v_l, eps=eps)

        sharded = jax.shard_map(
            local, mesh=device_mesh, in_specs=(spec,),
            out_specs=sing_ops.SingularityField(spec, spec, spec, spec,
                                                spec),
            check_vma=False)

        @partial(jax.jit, static_argnums=(1,))
        def prog(v_pad, t: int):
            # ONE program: sharded per-frame detection, padding-frame
            # slice-off, and (optionally) the capacity-sizing counts
            # reduction — eager composition would pay the dispatch latency
            # per op (detect_with_counts' rationale).
            field = sharded(v_pad)
            field = sing_ops.SingularityField(
                *(leaf[:t] for leaf in field))
            if not with_counts:
                return field
            vc, ic = sing_ops.detection_counts(field)
            return field, jnp.stack([vc, ic])

        return prog

    return _cached_program(
        mesh, ("detect", device_mesh, float(eps), bool(with_counts)), build)


def sharded_detect(mesh: TriMesh, v_world, device_mesh,
                   eps: float = 1e-4) -> sing_ops.SingularityField:
    """Frames-sharded singularity detection: each shard runs detect() on
    its frame block (per-frame normalization makes it a pure map — no
    collective at all). Padding frames are zero-velocity (their outputs are
    NaN-masked garbage) and slice off inside the same program."""
    nf = device_mesh.shape["frames"]
    v = jnp.asarray(v_world)
    t = v.shape[0]
    prog = _detect_program(mesh, device_mesh, eps, with_counts=False)
    return prog(_pad_frames(v, nf), t)


def sharded_detect_with_counts(mesh: TriMesh, v_world, device_mesh,
                               eps: float = 1e-4):
    """Frames-sharded equivalent of ops.singularity.detect_with_counts:
    (field, (2,) counts) from ONE device program."""
    nf = device_mesh.shape["frames"]
    v = jnp.asarray(v_world)
    t = v.shape[0]
    prog = _detect_program(mesh, device_mesh, eps, with_counts=True)
    return prog(_pad_frames(v, nf), t)


def sharded_wave_velocity(mesh: TriMesh, movie, dt: float, device_mesh,
                          method: str = "phase") -> jnp.ndarray:
    """Frames-sharded wave speeds (T, N), matching the single-device
    pipeline stage: method='phase' returns |v|/1000 (the S5 driver's
    mm/ms step, S5_compute_wave_v.py:311-313), method='amplitude' the raw
    amplitude speeds.

    The temporal stencil couples +-2 frames across shard boundaries; it is
    ~3 elementwise passes over the movie, so it runs on the REPLICATED
    movie in every shard (in_specs=P()) and each shard then slices its
    own frame block for the expensive per-frame spatial-gradient part.
    Communication: none beyond the initial replication — the right trade
    at (T, N) movie sizes where the gradient part dominates ~20x."""
    if method not in ("phase", "amplitude"):
        raise ValueError(f"unknown wavespeed method {method!r}")
    nf = device_mesh.shape["frames"]
    mv = jnp.asarray(movie)
    t = mv.shape[0]
    if t < 3:
        raise ValueError("wave speeds need at least 3 frames")
    tl = (t + ((-t) % nf)) // nf

    def build():
        def local(mv_full, dt_s):
            i = jax.lax.axis_index("frames")
            if method == "phase":
                dtime = temporal_gradient_phase(mv_full, dt_s)
            else:
                dtime = temporal_gradient_amplitude(mv_full, dt_s)
            mv_p = _pad_frames(mv_full, nf)
            dt_p = _pad_frames(dtime, nf)
            lo = i * tl
            mv_l = jax.lax.dynamic_slice_in_dim(mv_p, lo, tl, 0)
            dt_l = jax.lax.dynamic_slice_in_dim(dt_p, lo, tl, 0)
            speed = dt_l / tangential_gradient_magnitude(mesh, mv_l)
            if method == "phase":
                speed = jnp.abs(speed) / 1000.0
            return speed

        return jax.jit(jax.shard_map(
            local, mesh=device_mesh, in_specs=(P(), P()),
            out_specs=P("frames"), check_vma=False))

    # dt rides as a traced scalar so one compiled program serves any
    # sampling frequency; t/tl are shape-derived and key the cache.
    prog = _cached_program(
        mesh, ("wave", device_mesh, method, t), build)
    out = prog(mv, jnp.asarray(dt, mv.dtype))
    return out[:t]


def sharded_winding_grid(mesh: TriMesh, v_world, centers_u, device_mesh,
                         max_level: int = 25):
    """Frames-sharded winding-profile grid: (U, T) counts/types + (U, T, L)
    profiles over the unique snapped centers (ops.winding's grid
    formulation with its frame axis sharded). Ring tables are frame-
    independent and rebuild per shard (replicated compute); the per-frame
    profile passes — the part that scales with T — shard.

    Callers must respect the per-device grid memory ceiling
    (ops.winding._GRID_MAX_ELEMS over the LOCAL frame count) — use
    sharded_winding_movie, which chunks the center axis."""
    nf = device_mesh.shape["frames"]
    v = jnp.asarray(v_world)
    t = v.shape[0]

    def build():
        def local(v_l, cu):
            return wind_ops._grid_centers_program(mesh, v_l, cu,
                                                  max_level=max_level)

        return jax.jit(jax.shard_map(
            local, mesh=device_mesh, in_specs=(P("frames"), P()),
            out_specs=(P(None, "frames"), P(None, "frames"),
                       P(None, "frames", None)), check_vma=False))

    prog = _cached_program(
        mesh, ("windgrid", device_mesh, int(max_level)), build)
    out = prog(_pad_frames(v, nf), jnp.asarray(centers_u, jnp.int32))
    return tuple(leaf[:, :t] for leaf in out)


def sharded_winding_movie(mesh: TriMesh, v_world, points, valid,
                          device_mesh, max_level: int = 25,
                          centers=None) -> wind_ops.WindingResult:
    """Frames-sharded equivalent of ops.winding.analyze_singularities_movie
    (grid formulation): host center snap/dedup, sharded profile grid with
    the center axis chunked under the per-device memory ceiling, shared
    host slot selection. Results match the single-device op exactly.

    When even an 8-center chunk would exceed the ceiling at the LOCAL
    frame count (huge T/nf * N), falls back to the single-device op's
    memory-safe dispatch (its slots path) rather than OOMing the shards.
    """
    import numpy as np

    from manifold_flow_tpu.utils.io import start_host_copy

    t, s = np.shape(points)[0], np.shape(points)[1]
    vmask = np.asarray(valid, dtype=bool)
    if t * s == 0 or not vmask.any():
        return wind_ops.WindingResult(
            counts=jnp.zeros((t, s), jnp.int32),
            types=jnp.zeros((t, s), jnp.int32),
            winding_numbers=jnp.zeros((t, s, max_level), jnp.float32))
    nf = device_mesh.shape["frames"]
    n = mesh.n_vertices
    t_local = (t + ((-t) % nf)) // nf
    chunk = (wind_ops._GRID_MAX_ELEMS // max(t_local * n, 1)) // 8 * 8
    if chunk < 8:
        return wind_ops.analyze_singularities_movie(
            mesh, v_world, points, valid, max_level=max_level,
            centers=centers)
    uniq_p, u_idx = wind_ops.snap_and_dedup_centers(mesh, points, vmask,
                                                    centers=centers)
    v = jnp.asarray(v_world)
    u_cap = len(uniq_p)
    parts = []
    for lo in range(0, u_cap, chunk):
        hi = min(lo + chunk, u_cap)
        pad_to = max(8, -(-(hi - lo) // 8) * 8)
        ids = np.full(pad_to, uniq_p[0], np.int32)
        ids[: hi - lo] = uniq_p[lo:hi]
        out = sharded_winding_grid(mesh, v, ids, device_mesh,
                                   max_level=max_level)
        parts.append((hi - lo, out))
    for _, out in parts:
        start_host_copy(*out)
    cu = np.concatenate([np.asarray(o[0])[:k] for k, o in parts])
    tu = np.concatenate([np.asarray(o[1])[:k] for k, o in parts])
    wu = np.concatenate([np.asarray(o[2])[:k] for k, o in parts])
    return wind_ops.select_slots_host(cu, tu, wu, u_idx, vmask)
