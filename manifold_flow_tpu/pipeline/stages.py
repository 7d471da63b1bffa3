"""Composable pipeline stages mirroring the reference's S0-S7 scripts.

Each stage is a function over in-memory arrays plus a thin artifact wrapper
that reads/writes the reference's file formats (utils.io), so outputs
interoperate with the original pipeline. Device compute goes through the
framework's ops; host-only steps (MNE preprocessing) are gated on their
optional dependencies.

Stage map (SURVEY.md §2):
  S0 preprocess            -> preprocess_subject (requires mne; gated)
  S1 reconstruct surface   -> reconstruct_stage (VTK-free, geometry.reconstruct)
  S2 interpolate           -> interpolate_stage (+ phases variant)
  S3 velocity + detection  -> velocity_stage, singularity_stage
  S4 SVD decomposition     -> decompose_stage
  S5 wave speeds           -> wavespeed_stage
  S6 streamlines           -> streamline_stage
  S7 winding lines         -> winding_stage
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np

from manifold_flow_tpu.geometry import reconstruct
from manifold_flow_tpu.geometry.mesh import (
    TriMesh,
    build_mesh,
    pad_mesh,
    pad_vertex_field,
    unpad_vertex_field,
)
from manifold_flow_tpu.ops import (
    interpolate as rbf_ops,
    phase as phase_ops,
    singularity as sing_ops,
    streamline as stream_ops,
    svd as svd_ops,
    wavespeed as wave_ops,
    winding as wind_ops,
)
from manifold_flow_tpu.ops.recombine import velocity_to_world, world_speed
from manifold_flow_tpu.pipeline.config import PipelineConfig
from manifold_flow_tpu.solve.api import compute_velocity_fields
from manifold_flow_tpu.utils import io


# ------------------------------------------------------------------- S0 ----
def preprocess_subject(subject_dir, results_dir, config: PipelineConfig):
    """S0: BrainVision -> filtered, re-referenced epochs + per-site evokeds.

    Requires MNE-Python (host-side, runs once per subject). Mirrors
    process_subject (S0_preprocess.py:133-172): band-pass low_freq..high_freq,
    notch at the recording's PowerLineFrequency, ECOG/good/included channel
    pick, average reference, epochs on electrical_stimulation events with
    baseline correction, per-stimulation-site evoked averages.
    """
    try:
        import mne  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "preprocess_subject requires MNE-Python (not installed in this "
            "image); run this stage on a host with mne, or start from the "
            "interpolation stage with precomputed evokeds") from e
    from manifold_flow_tpu.pipeline import preprocess as _pre

    return _pre.process_subject(subject_dir, results_dir, config.preprocess)


# ------------------------------------------------------------------- S1 ----
class ReconstructionResult(NamedTuple):
    mesh: TriMesh
    points: np.ndarray
    triangles: np.ndarray


def reconstruct_stage(electrode_coords, config: PipelineConfig,
                      save_path=None) -> ReconstructionResult:
    """S1: electrode point cloud -> smoothed, subdivided triangle surface."""
    pts, tris = reconstruct.reconstruct_surface(
        electrode_coords,
        smooth_iters=config.reconstruction.smooth_iters,
        subdivisions=config.reconstruction.subdivisions,
    )
    if save_path is not None:
        io.ensure_dir(save_path)
        io.write_ply(save_path, pts, tris)
    return ReconstructionResult(build_mesh(pts, tris), pts, tris)


def load_surface(path, cache_dir=None, pad: bool = False) -> TriMesh:
    """Load a (reference-produced or own) PLY surface into a TriMesh.

    `cache_dir` enables the geometry-precompute cache keyed by mesh content
    (utils.cache) — the realized version of the reference's commented-out
    processed_surface_path (config.yaml:18,27).

    `pad` rounds the mesh into a shape bucket (geometry.pad_mesh) so
    different surfaces reuse one set of compiled programs — the cohort-sweep
    default in pipeline.batch. Stages mask padding out of device compute and
    strip it from artifacts (outputs stay unpadded)."""
    pts, tris = io.read_ply(path)
    if cache_dir is not None:
        from manifold_flow_tpu.utils.cache import build_mesh_cached

        mesh = build_mesh_cached(pts, tris, cache_dir=cache_dir)
    else:
        mesh = build_mesh(pts, tris)
    return pad_mesh(mesh) if pad else mesh


# ------------------------------------------------------------------- S2 ----
def interpolate_stage(mesh: TriMesh, electrode_coords, electrode_data,
                      config: PipelineConfig, sfreq: float | None = None,
                      phases: bool = False, save_path=None) -> np.ndarray:
    """S2: electrode movie (T, E) -> vertex movie (T, N) via on-device RBF.

    With phases=True follows S2_interpolate_phases: Hilbert phase per
    electrode, interpolate e^{i phi}, return the angle of the interpolant.
    When `sfreq` is given, the movie is windowed to
    [start_time, end_time) seconds (S2_interpolate.py:19-20,109-110).

    Hilbert axis: the default transforms along TIME (axis=0, the standard
    instantaneous-phase construction). The reference calls scipy's hilbert
    with its default axis=-1 — across ELECTRODES (S2_interpolate_phases.py:66);
    config.reference_quirks reproduces that for artifact parity.
    """
    import jax.numpy as jnp

    def window(movie):
        """ONE windowing site for both branches (phases must window AFTER
        the Hilbert transform — truncating the time series first would
        change every frame's analytic signal)."""
        if sfreq is None:
            return movie
        s = int(config.interpolation.start_time * sfreq)
        e = int(config.interpolation.end_time * sfreq)
        return movie[s:e]

    data = np.asarray(electrode_data)
    if phases:
        # Both device programs here are real-in/real-out: the complex
        # analytic signal and the complex unit-circle RBF values exist only
        # inside compiled programs.
        hilbert_axis = -1 if config.reference_quirks else 0
        phi = window(np.asarray(phase_ops.instantaneous_phase(
            jnp.asarray(data), axis=hilbert_axis)))
        out = np.asarray(rbf_ops.rbf_interpolate_phases(
            jnp.asarray(np.asarray(electrode_coords)), jnp.asarray(phi),
            mesh.points, smooth=config.interpolation.smooth,
            kind=config.interpolation.kind))
    else:
        out = np.asarray(rbf_ops.rbf_interpolate(
            jnp.asarray(np.asarray(electrode_coords)),
            jnp.asarray(window(data)),
            mesh.points, smooth=config.interpolation.smooth,
            kind=config.interpolation.kind))
    if save_path is not None:
        io.ensure_dir(save_path)
        io.save_indexed_csv(save_path, unpad_vertex_field(mesh, out))
    return out


class ConvergenceWarning(UserWarning):
    """A velocity-solve frame failed its residual tolerance."""


_FUSED_FLOW_CACHE: dict = {}


def _fused_flow_program(mesh: TriMesh, method: str, config: PipelineConfig):
    """ONE jitted program for the single-device flow stage: solve ->
    world recombination -> speed map -> device-side artifact unpads.

    Composed eagerly, these are ~6 separate dispatches, each paying the
    call latency. The mesh and solver
    parameters fold in as closure constants — cached per (mesh identity,
    solver params) with the mesh object pinned in the cache entry, so
    cohort sweeps (whose shape-bucketed meshes are shared via
    batch.run_trial's mesh_cache) compile once per bucket."""
    import jax

    inner = config.solver.inner_tol
    key = (id(mesh), method, config.solver.lambda_, config.solver.tol,
           config.solver.max_iter,
           tuple(inner) if isinstance(inner, (list, tuple)) else inner)
    hit = _FUSED_FLOW_CACHE.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    from manifold_flow_tpu.geometry.mesh import (
        unpad_dof_field_device, unpad_vertex_field_device)

    lam = config.solver.lambda_
    tol = config.solver.tol
    max_iter = config.solver.max_iter

    @jax.jit
    def prog(potentials, times):
        res = compute_velocity_fields(
            mesh, potentials, times, lambda_=lam, method=method, tol=tol,
            inner_tol=inner, max_iter=max_iter)
        v_world = velocity_to_world(res.v_k, mesh.basis)
        speed = world_speed(v_world)
        return (res, v_world, speed,
                unpad_dof_field_device(mesh, res.v_k),
                unpad_vertex_field_device(mesh, speed))

    _FUSED_FLOW_CACHE[key] = (mesh, prog)
    while len(_FUSED_FLOW_CACHE) > 16:
        _FUSED_FLOW_CACHE.pop(next(iter(_FUSED_FLOW_CACHE)))
    return prog


# The transfer overlaps subsequent device compute, and a later np.asarray
# (e.g. in an ArtifactWriter worker) completes without issuing a fetch
# that would contend with new dispatches.
_start_host_copy = io.start_host_copy


def _save_pickle_np(path, arr):
    """save_pickle with the array materialized to host numpy first (a raw
    jax.Array must not be pickled into reference-format artifacts)."""
    io.save_pickle(path, np.asarray(arr))


# ------------------------------------------------------------------- S3 ----
class VelocityStage(NamedTuple):
    """v_k / v_world / speed are returned as DEVICE arrays (np.asarray
    fetches on first use and jax caches the host copy): downstream stages
    consume them on device, and a movie-sized device->host fetch should be
    made only where host data is actually needed."""

    v_k: "np.ndarray | object"      # (T-1, 2N)
    e: np.ndarray                   # (N, 2, 3)
    v_world: "np.ndarray | object"  # (T-1, N, 3)
    speed: "np.ndarray | object"    # (T-1, N) optical-flow speed map (C12)
    iterations: int
    converged: bool


def velocity_stage(mesh: TriMesh, potentials, times, config: PipelineConfig,
                   e_path=None, v_k_path=None, speed_path=None,
                   device_mesh=None, writer=None,
                   timings: dict | None = None) -> VelocityStage:
    """S3 core: velocity fields + recombination + speed map (+ artifacts).

    Non-convergence is loud: any frame still above `tol` at `max_iter` is
    reported by index and residual via warnings.warn, and (solver.escalate,
    default on) the movie is re-solved with the refined method —
    one bad frame would otherwise quietly corrupt every downstream artifact.

    `timings`, when given, receives sub-wall seconds: 'dispatch' (building
    + launching the device programs), 'artifact_starts' (the artifact
    unpad dispatches + async device->host copy starts), 'solve_wait'
    (blocking on the converged flags — the device solve + in-flight
    transfers), 'artifact_submits' (queueing the writes), plus the
    solver's 'solve_iterations' and 'solve_outer_steps' counts.
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    def run(method):
        """(res, v_world, speed, vk_art, sp_art) for `method` — the
        single-device cg/refined path runs as ONE fused program
        (_fused_flow_program); the sharded and direct-solver paths compose
        the recombination/unpads as device ops."""
        if device_mesh is None and method in ("cg", "refined"):
            return _fused_flow_program(mesh, method, config)(
                jnp.asarray(potentials), jnp.asarray(times))
        if device_mesh is not None:
            from manifold_flow_tpu.parallel import (
                sharded_compute_velocity_fields)

            res = sharded_compute_velocity_fields(
                mesh, jnp.asarray(potentials), jnp.asarray(times),
                device_mesh, lambda_=config.solver.lambda_,
                tol=config.solver.tol, max_iter=config.solver.max_iter,
                inner_tol=config.solver.inner_tol,
                method=("refined" if method == "refined" else "cg"))
        else:
            res = compute_velocity_fields(
                mesh, jnp.asarray(potentials), jnp.asarray(times),
                lambda_=config.solver.lambda_, method=method,
                tol=config.solver.tol, inner_tol=config.solver.inner_tol,
                max_iter=config.solver.max_iter)
        from manifold_flow_tpu.geometry.mesh import (
            unpad_dof_field_device, unpad_vertex_field_device)

        v_world = velocity_to_world(res.v_k, mesh.basis)
        speed = world_speed(v_world)
        # Unpads are device slices, dispatched only when an artifact needs
        # them (they're no-ops on unpadded meshes, but on padded ones each
        # is an eager dispatch — wasted when no path was requested). The
        # fused path gets them for free inside its one program.
        vk_art = (unpad_dof_field_device(mesh, res.v_k)
                  if v_k_path is not None else None)
        sp_art = (unpad_vertex_field_device(mesh, speed)
                  if speed_path is not None else None)
        return res, v_world, speed, vk_art, sp_art

    # Resolve 'auto' up front (mirrors solve.api): the escalation guard must
    # compare against the method that actually RAN, or an auto->refined run
    # would be "escalated" by repeating the identical refined solve.
    method = config.solver.method
    if method == "auto":
        on_accelerator = jax.devices()[0].platform != "cpu"
        method = ("refined" if on_accelerator
                  and jnp.asarray(potentials).dtype == jnp.float64 else "cg")

    def prep_artifacts(vk_art, sp_art):
        """Collect the artifact device views and START their device->host
        copies.

        The unpads are device slices computed inside the fused flow
        program (host-numpy unpads would each be a SYNCHRONOUS device->host
        fetch). Copies are
        async: the transfers ride the convergence fetch and the following
        stages' device time, and the writer worker's np.asarray just
        waits on the already-running copy. The writer submits stay AFTER
        the convergence check so an escalation can re-prepare first."""
        arts = {}
        if e_path is not None:
            arts["e"] = mesh.basis[: int(mesh.valid_vertices)]
        if v_k_path is not None:
            arts["v_k"] = vk_art
        if speed_path is not None:
            arts["speed"] = sp_art
        _start_host_copy(*arts.values())
        return arts

    t0 = _time.perf_counter()
    res, v_world, speed, vk_art, sp_art = run(method)
    tp = _time.perf_counter()
    arts = prep_artifacts(vk_art, sp_art)
    t1 = _time.perf_counter()
    conv = np.asarray(res.converged)
    t2 = _time.perf_counter()
    if timings is not None:
        timings["dispatch"] = tp - t0
        timings["artifact_starts"] = t1 - tp
        timings["solve_wait"] = t2 - t1
    if not conv.all():
        bad = np.where(~conv)[0]
        resid = np.asarray(res.residual)[bad]
        detail = ", ".join(
            f"frame {int(k)}: |r|={r:.3e}" for k, r in zip(bad[:8], resid[:8]))
        if len(bad) > 8:
            detail += f", ... ({len(bad)} frames total)"
        # Mesh-sharded runs escalate too: parallel.partition dispatches
        # method='refined' to the halo-exchange refined solver
        # (halo_refined_velocity_fields), so the safety net holds under any
        # ('frames', 'mesh') layout.
        can_escalate = (
            config.solver.escalate
            and method not in ("refined", "cholesky")
            and jnp.asarray(potentials).dtype == jnp.float64)
        if can_escalate:
            warnings.warn(
                f"velocity solve failed tol={config.solver.tol} on "
                f"{len(bad)} frame(s) [{detail}]; escalating to the refined "
                "solver", ConvergenceWarning, stacklevel=2)
            res, v_world, speed, vk_art, sp_art = run("refined")
            arts = prep_artifacts(vk_art, sp_art)  # supersedes the 1st pass
            conv = np.asarray(res.converged)
        if not conv.all():
            bad = np.where(~conv)[0]
            resid = np.asarray(res.residual)[bad]
            detail = ", ".join(
                f"frame {int(k)}: |r|={r:.3e}"
                for k, r in zip(bad[:8], resid[:8]))
            warnings.warn(
                f"velocity solve NOT converged to tol={config.solver.tol} on "
                f"{len(bad)} frame(s) [{detail}]; downstream singularity/"
                "streamline/winding artifacts may be unreliable — raise "
                "max_iter or loosen tol", ConvergenceWarning, stacklevel=2)
    # Artifacts stay unpadded (reference shapes) even when the in-memory
    # mesh is shape-bucketed; downstream in-memory stages keep the padded
    # arrays so their shapes match the mesh. Only the artifact arrays
    # cross to the host, and their device->host copies start ASYNC here —
    # the transfer rides the next stage's device compute, and the writer
    # worker's np.asarray just waits on the already-running copy instead
    # of issuing one that contends with new dispatches.
    t3 = _time.perf_counter()
    if e_path is not None:
        io.submit_write(writer, io.save_e_csv, e_path, arts["e"])
    if v_k_path is not None:
        io.submit_write(writer, io.save_indexed_csv, v_k_path, arts["v_k"])
    if speed_path is not None:
        io.submit_write(writer, _save_pickle_np, speed_path, arts["speed"])
    if timings is not None:
        timings["artifact_submits"] = _time.perf_counter() - t3
        # Solver counters ride along with the walls (they are fetched with
        # the converged flags' program anyway).
        timings["solve_iterations"] = int(res.iterations)
        timings["solve_outer_steps"] = int(res.outer_steps)
    return VelocityStage(
        v_k=res.v_k, e=np.asarray(mesh.basis),
        v_world=v_world, speed=speed,
        iterations=int(res.iterations),
        converged=bool(np.all(conv)))


def singularity_stage(mesh: TriMesh, v_world, config: PipelineConfig,
                      classify: bool = False, save_path=None,
                      classification_path=None, writer=None,
                      return_centers: bool = False, device_mesh=None):
    """S3 detection: per-frame singularity lists (+ classification).

    Returns (points_per_frame, labels_per_frame) where labels are
    reference-style strings; saves the reference's pickle format
    (find_singularity_point.py:760-761). `classification_path` writes the
    per-frame label lists — the artifact the reference's config names
    (singularity_points_classification_path, config.yaml) whose write the
    original left commented out (S3:145-156), realized here.

    return_centers=True appends a third return: per-frame snapped center
    vertex ids (device-computed inside the compaction program) that the
    winding stage consumes directly instead of re-snapping on the host."""
    import jax.numpy as jnp

    v = jnp.asarray(v_world)
    # One fused device program + one two-int fetch (instead of fetching the
    # whole mask): the capacity sizing is shared by the device compaction
    # and the classify program. With a device_mesh the detection map shards
    # over 'frames' (parallel.analysis), its counts reduced inside the same
    # program.
    if device_mesh is not None:
        from manifold_flow_tpu.parallel.analysis import (
            sharded_detect_with_counts)

        field, counts = sharded_detect_with_counts(
            mesh, v, device_mesh, eps=config.solver.eps)
    else:
        field, counts = sing_ops.detect_with_counts(mesh, v,
                                                    eps=config.solver.eps)
    counts = np.asarray(counts)
    cap = -(-max(int(counts[0]), int(counts[1]), 1) // 8) * 8
    if classify:
        # Classify only the detected candidates instead of computing
        # Jacobians at every vertex/triangle of every frame.
        det = sing_ops.classify_detected(mesh, v, field, capacity=cap,
                                         quirks=config.reference_quirks)
        # ONE fetch per array: per-frame slices of device arrays would each
        # pay an eager dispatch + transfer.
        io.start_host_copy(*det)
        cols = [(np.asarray(ids), np.asarray(valid), np.asarray(codes), kind)
                for ids, valid, codes, kind in (
                    (det.vertex_ids, det.vertex_valid, det.vertex_codes,
                     "vertex"),
                    (det.interior_ids, det.interior_valid,
                     det.interior_codes, "interior"))]
        code_maps = []
        for k in range(v.shape[0]):
            cm = {}
            for row_ids, row_ok, row_codes, kind in cols:
                for i in np.flatnonzero(row_ok[k]):
                    cm[(kind, int(row_ids[k, i]))] = int(row_codes[k, i])
            code_maps.append(cm)
    points_per_frame = []
    labels_per_frame = []
    centers_per_frame = []
    compacted = sing_ops.compact_all(mesh, field, capacity=cap,
                                     with_centers=True)
    for k in range(v.shape[0]):
        pts, kinds, ids, centers = compacted[k]
        points_per_frame.append(pts)
        centers_per_frame.append(centers)
        if classify:
            lab = [sing_ops.CLASS_NAMES[code_maps[k][(kind, int(idx))]]
                   for kind, idx in zip(kinds, ids)]
            labels_per_frame.append(lab)
    if save_path is not None:
        io.submit_write(writer, io.save_pickle, save_path,
                        [list(p) for p in points_per_frame])
    if classification_path is not None and classify:
        io.submit_write(writer, io.save_pickle, classification_path,
                        labels_per_frame)
    labels = labels_per_frame if classify else None
    if return_centers:
        return points_per_frame, labels, centers_per_frame
    return points_per_frame, labels


# ------------------------------------------------------------------- S4 ----
def decompose_stage(v_k, config: PipelineConfig, mode: str = "concat",
                    npz_path=None, writer=None):
    """S4: spatiotemporal SVD (complex or concatenated-real form)."""
    import jax.numpy as jnp

    v = jnp.asarray(v_k)
    if mode == "complex":
        modes = svd_ops.decompose_complex(v, n_modes=config.analysis.n_modes)
    elif mode == "concat":
        modes = svd_ops.decompose_concat(v, n_modes=config.analysis.n_modes)
    else:
        raise ValueError(f"unknown SVD mode {mode!r}")
    if npz_path is not None:
        io.submit_write(writer, np.savez, npz_path, U=np.asarray(modes.u),
                        Sigma=np.asarray(modes.sigma),
                        VT=np.asarray(modes.vt),
                        point_num=v.shape[-1] // 2)
    return modes


# ------------------------------------------------------------------- S5 ----
def wavespeed_stage(mesh: TriMesh, movie, dt: float, method: str = "phase",
                    save_path=None, writer=None, device_mesh=None):
    """S5: wave speeds from an amplitude or phase movie (T, N).

    On a padded mesh, an unpadded movie is zero-extended for the device
    compute and the result (incl. the artifact) is returned unpadded, as a
    device array whose host copy is already in flight (np.asarray to
    materialize)."""
    import jax.numpy as jnp

    from manifold_flow_tpu.geometry.mesh import unpad_vertex_field_device

    m = jnp.asarray(pad_vertex_field(mesh, movie))
    if device_mesh is not None:
        # Frames-sharded variant (parallel.analysis): same outputs, frame
        # axis distributed; the method check happens inside.
        from manifold_flow_tpu.parallel import sharded_wave_velocity

        ws = sharded_wave_velocity(mesh, m, dt, device_mesh, method=method)
    elif method == "phase":
        ws = wave_ops.wave_velocity_phase_mm_per_ms(mesh, m, dt)
    elif method == "amplitude":
        ws = wave_ops.wave_velocity_amplitude(mesh, m, dt)
    else:
        raise ValueError(f"unknown wavespeed method {method!r}")
    # Device-side unpad: the numpy unpad helper would synchronously fetch
    # the whole (T, N) field over the link; the async copy starts instead
    # and the writer worker materializes it.
    ws = unpad_vertex_field_device(mesh, ws)
    _start_host_copy(ws)
    if save_path is not None:
        io.submit_write(writer, _save_pickle_np, save_path, ws)
    return ws


# ------------------------------------------------------------------- S6 ----
def streamline_stage(mesh: TriMesh, v_world, config: PipelineConfig,
                     frames=None, save_path_fmt=None, writer=None,
                     timings: dict | None = None):
    """S6: per-frame streamline sets {frame: [polyline, ...]}.

    `timings`, when given, receives sub-wall seconds: 'trace' (the adaptive
    device tracer incl. its escalation retrace), 'compact' (qualifying-row
    device fetch + host polyline assembly), 'submit' (queueing the
    per-frame pickle writes — the bz2 compression itself runs on the
    writer's workers, landing in the trial's drain/overlap accounting)."""
    import time as _time

    import jax.numpy as jnp

    # Device arrays stay on device; frame selection is a device slice.
    v = jnp.asarray(v_world)
    all_frames = frames is None
    frames = list(range(v.shape[0])) if frames is None else list(frames)
    vsel = v if all_frames else v[jnp.asarray(np.asarray(frames))]
    # One device program traces every requested frame (per-frame dispatch
    # would pay the call latency per frame); the adaptive
    # window keeps the gather volume proportional to the longest actual walk
    # rather than the configured cap.
    t0 = _time.perf_counter()
    batched = stream_ops.trace_frames_adaptive(
        mesh, vsel,
        max_steps=config.analysis.max_streamline_steps,
        quirks=config.reference_quirks)
    t1 = _time.perf_counter()
    # compact_frames fetches only the rows that reach min_length (~13% at
    # reference scale) — the walk arrays stay on device otherwise. Polyline
    # coordinates ship as float32 (halving the per-frame pkl.bz2 artifact
    # compression that dominates the trial's writer-drain tail) unless
    # reference_quirks pins the reference's f64 bytes. Frames are EMITTED
    # incrementally (callback) so each frame's pickle write queues while
    # later frames are still assembling — the compression rides the
    # assembly instead of landing in one end-of-stage burst.
    out = {}

    def emit(i, lines):
        k = frames[i]
        out[str(k)] = lines
        if save_path_fmt is not None:
            path = save_path_fmt.format(frame=k)
            io.submit_write(writer, io.save_pickle, path, {str(k): lines})

    stream_ops.compact_frames(
        mesh, batched, min_length=config.analysis.min_streamline_length,
        coord_dtype=None if config.reference_quirks else np.float32,
        emit=emit)
    t2 = _time.perf_counter()
    if timings is not None:
        timings["trace"] = t1 - t0
        timings["compact"] = t2 - t1
        timings["submit"] = _time.perf_counter() - t2
    return out


# ------------------------------------------------------------------- S7 ----
def winding_stage(mesh: TriMesh, v_world, singularity_points,
                  config: PipelineConfig, save_path=None, writer=None,
                  centers=None, device_mesh=None):
    """S7: winding-line extents {frame: [[coord, ring_count, type], ...]}.

    `centers` optionally carries the detection stage's per-frame snapped
    center vertex ids (singularity_stage(return_centers=True)); without
    them the op re-snaps points on the host (the resume-from-pickle path).
    """
    import jax.numpy as jnp

    # Device arrays stay on device (the movie would otherwise cross to the
    # host here just to be re-uploaded by the op).
    v = jnp.asarray(v_world)
    n_frames = min(len(singularity_points), v.shape[0])
    caps = [len(singularity_points[t]) for t in range(n_frames)]
    smax = max(caps, default=0)
    # Round the capacity to a bucket (like classification's round-to-8) so
    # cohort sweeps with varying singularity counts reuse one compiled
    # program instead of retracing per trial/frame-count.
    smax = -(-smax // 8) * 8
    if smax == 0:
        winding_lines = {}
    else:
        # One device program analyzes every frame at a common capacity
        # (per-frame dispatch would both pay the call latency per frame and
        # recompile for each distinct singularity count).
        # float64 buffer: these coordinates go into the winding artifact
        # verbatim, at whatever precision the detection stage emitted them.
        pts_arr = np.zeros((n_frames, smax, 3), dtype=np.float64)
        valid = np.zeros((n_frames, smax), dtype=bool)
        centers_arr = None
        if centers is not None:
            centers_arr = np.zeros((n_frames, smax), dtype=np.int32)
        for t in range(n_frames):
            if caps[t]:
                pts_arr[t, : caps[t]] = np.asarray(singularity_points[t])
                valid[t, : caps[t]] = True
                if centers_arr is not None:
                    centers_arr[t, : caps[t]] = np.asarray(centers[t])
        # Unique-center dedup: ring tables (BFS + polar sort) are built once
        # per distinct snapped center, not once per (frame, singularity).
        # With a device_mesh the profile grid shards its frame axis.
        if device_mesh is not None:
            from manifold_flow_tpu.parallel import sharded_winding_movie

            res = sharded_winding_movie(
                mesh, jnp.asarray(v[:n_frames]), pts_arr, valid,
                device_mesh, max_level=config.analysis.max_winding_level,
                centers=centers_arr)
        else:
            res = wind_ops.analyze_singularities_movie(
                mesh, jnp.asarray(v[:n_frames]), pts_arr, valid,
                max_level=config.analysis.max_winding_level,
                centers=centers_arr)
        io.start_host_copy(res.counts, res.types)
        counts = np.asarray(res.counts)
        types = np.asarray(res.types)
        winding_lines = {}
        for t in range(n_frames):
            if caps[t] == 0:
                continue
            rows = []
            for i in range(caps[t]):
                if counts[t, i] == 0:
                    continue
                rows.append([pts_arr[t, i], int(counts[t, i]),
                             int(types[t, i])])
            winding_lines[str(t)] = rows
    if save_path is not None:
        io.submit_write(writer, io.save_pickle, save_path, winding_lines)
    return winding_lines
