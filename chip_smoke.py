"""GPU smoke run of the trial pipeline: the main path on one card, checked.

Everything runs in ONE process (a JAX process reserves most of a card's
memory, so a second process on the same card would fail):

  1. device gate: refuses any backend but a GPU and prints the card;
  2. the reference trial cohort (one subject, 3,136-vertex curved patch,
     8x8 ECoG grid, three trials, 98 frames) from generated evokeds + BIDS
     sidecars through `pipeline.cli batch` with every stage, then a second
     invocation that must skip every stage (resume by artifact);
  3. one 12,544-vertex trial through `pipeline.batch.run_trial` (the
     two-level preconditioner path);
  4. a 3,136-vertex x 392-frame solve (the chunked long-window path);
  5. correctness against the plain references: SciPy SuperLU for the
     solve, scipy.interpolate.Rbf for the interpolation, and the CPU
     backend of this process for every analysis stage;
  6. numerics particular to the GPU: TF32 in f32 contractions, and the
     refined solve's f64 residual against the plain reference's;
  7. timings of the plain-JAX workarounds against their plain forms
     (smoke timings, not benchmark numbers);
  8. costs: compile seconds per phase, compiled memory of the flow program,
     peak device memory, stage wall times.

    python chip_smoke.py                 # one card, all phases
    python chip_smoke.py --four-cards    # the multi-card path only

Inputs are generated from --seed under --workdir (default: .smoke_work in
the checkout, removed at the end). Any failed check raises, so the process
exits non-zero before the last line; the last line of standard output is
the JSON verdict {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io as _stdio
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Solve gate of the repo (BASELINE.md): RMSE / max|V_ref| against SuperLU.
SOLVE_RMSE_GATE = 1e-5
# RBF interpolation vs scipy.interpolate.Rbf, max|diff| / max|ref|.
RBF_GATE = 1e-9
# f64 analysis values, card vs CPU backend, as max|diff| / max|ref| per
# array: both backends run the same f64 program and differ only in
# reduction order (~1e-16 per op; prefix sums over a frame's N vertices,
# as in the winding profile, accumulate ~N times that).
ANALYSIS_RTOL = 1e-9
# f32 operator matvec vs f64: f32 rounding gives ~1e-7, TF32 would ~1e-3.
TF32_GATE = 1e-5
# Refined-solve residual f - A x on the card vs the SciPy-assembled one,
# max|diff| / max|f|: both are f64 (~1e-16 per op, summed over a row).
RESIDUAL_GATE = 1e-12


class SmokeFailure(AssertionError):
    """A smoke check failed."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes; the defaults are the deployment the smoke stands for."""

    nx: int = 56              # 56 x 56 = 3,136 vertices (bench.build_problem)
    nx_large: int = 112       # 112 x 112 = 12,544 vertices
    frames: int = 98          # PipelineConfig().solver.time_steps
    long_frames: int = 392    # > FRAME_CHUNK_AUTO_MIN: chunked solve
    n_trials: int = 3
    grid: int = 8             # 8 x 8 ECoG electrodes
    sfreq: float = 2048.0
    check_frames: int = 6     # frames compared against SuperLU per phase


# ------------------------------------------------------------- helpers ----
def surface(nx: int, dtype=np.float64):
    """The curved 60 x 60 mm patch of bench.build_problem at nx x nx."""
    from manifold_flow_tpu.geometry import synthetic

    return synthetic.plane_patch(
        nx=nx, ny=nx, lx=60.0, ly=60.0,
        height=lambda x, y: 6.0 * np.sin(x / 12.0) * np.cos(y / 15.0),
        dtype=dtype)


def wave_field(points, t, sources, speed=120.0, wavelength=24.0):
    """Two radially expanding waves sampled at `points` (P, 3) and times
    `t` (T,): (T, P) potentials."""
    pot = np.zeros((len(t), len(points)))
    for src in sources:
        r = np.linalg.norm(points - src, axis=-1)
        pot += np.cos(2 * np.pi * (r[None] - speed * t[:, None]) / wavelength)
    return pot


_COMPILE = {"seconds": 0.0}


def _on_duration(event, duration, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _COMPILE["seconds"] += duration


@contextlib.contextmanager
def phase(name: str, costs: dict):
    """Print the phase's wall and compile seconds; record them in costs."""
    print(f"[{name}] start", flush=True)
    t0, c0 = time.perf_counter(), _COMPILE["seconds"]
    yield
    wall = time.perf_counter() - t0
    comp = _COMPILE["seconds"] - c0
    costs[name] = {"wall_s": wall, "compile_s": comp}
    print(f"[{name}] done: wall {wall:.1f} s, compile {comp:.1f} s",
          flush=True)


def device_gate() -> dict:
    """The card this run measures. Anything but a GPU backend is refused:
    there is no CPU fallback."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: refusing to run on platform {d.platform!r}; "
            "it needs a GPU backend")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def card_info() -> str:
    """name, power limit of every card, from nvidia-smi (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def run_cli(argv) -> tuple[int, dict]:
    """pipeline.cli.main in this process; returns (exit code, report)."""
    from manifold_flow_tpu.pipeline import cli

    buf = _stdio.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    return rc, json.loads(lines[-1])


def rel_rmse(v, ref) -> float:
    return float(np.sqrt(np.mean((np.asarray(v) - ref) ** 2))
                 / max(np.abs(ref).max(), 1e-300))


def superlu_frames(mesh, movie, times, frames, lambda_=0.01):
    """SciPy SuperLU velocity DOFs (len(frames), 2N) on the plain oracle."""
    from tests.oracle.reference_impl import velocity_fields_np

    nv = int(mesh.valid_vertices)
    pts = np.asarray(mesh.points)[:nv]
    tris = np.asarray(mesh.triangles)
    nrm = np.asarray(mesh.normals)[:nv]
    out = []
    for k in frames:
        v, _ = velocity_fields_np(pts, tris, nrm, movie[k:k + 2, :nv],
                                  times[k:k + 2], lambda_=lambda_)
        out.append(v[0])
    return np.stack(out)


def check_solve(label, mesh, movie, times, v_k, n_check, lambda_=0.01,
                iterations=None, outer_steps=None) -> float:
    frames = np.unique(np.linspace(0, v_k.shape[0] - 1, n_check).astype(int))
    ref = superlu_frames(mesh, movie, times, frames, lambda_=lambda_)
    err = rel_rmse(np.asarray(v_k)[frames], ref)
    print(f"  solve {label}: RMSE/max|V| vs SuperLU = {err:.3e} on frames "
          f"{frames.tolist()} (gate {SOLVE_RMSE_GATE:g}: the repo's solve "
          f"gate, BASELINE.md); CG iterations {iterations}, outer "
          f"refinement steps {outer_steps}")
    check(np.isfinite(err) and err < SOLVE_RMSE_GATE,
          f"{label}: solve RMSE {err:.3e} >= {SOLVE_RMSE_GATE:g}")
    return err


# ------------------------------------------------------------- inputs ----
def electrode_grid(mesh, grid: int):
    """Vertex ids of a grid x grid electrode array on an nx x nx patch."""
    nx = int(round(np.sqrt(int(mesh.valid_vertices))))
    ij = np.round(np.linspace(0.06, 0.94, grid) * (nx - 1)).astype(int)
    return (ij[:, None] * nx + ij[None, :]).ravel()


def write_cohort(root: Path, sizes: Sizes, seed: int):
    """Subject tree with per-trial evoked CSVs + BIDS sidecars, built like
    tests/test_batch.py's _write_interp_inputs, at the deployment's size."""
    from manifold_flow_tpu.pipeline.config import PipelineConfig
    from manifold_flow_tpu.utils import io

    cfg = PipelineConfig()
    mesh = surface(sizes.nx)
    pts = np.asarray(mesh.points)
    subj = root / "sub-01"
    subj.mkdir(parents=True, exist_ok=True)
    io.write_ply(subj / "sub-01_reconstructed_surface.ply", pts,
                 np.asarray(mesh.triangles))
    (subj / "sub-01_task-SPESclin_run-001_ieeg.json").write_text(
        json.dumps({"SamplingFrequency": sizes.sfreq}))
    sel = electrode_grid(mesh, sizes.grid)
    names = [f"G{i + 1}" for i in range(len(sel))]
    rows = ["name\tx\ty\tz\tgroup"] + [
        f"{n}\t{float(pts[v, 0])!r}\t{float(pts[v, 1])!r}\t"
        f"{float(pts[v, 2])!r}\tgrid"
        for n, v in zip(names, sel)]
    # Two strip contacts the channel predicate must drop.
    rows += ["S1\t0.0\t0.0\t0.0\tstrip", "S2\tn/a\tn/a\tn/a\tstrip"]
    (subj / "sub-01_electrodes.tsv").write_text("\n".join(rows) + "\n")
    ch = ["name\ttype\tstatus\tstatus_description\tgroup"] + [
        f"{n}\tECOG\tgood\tincluded\tgrid" for n in names] + [
        "S1\tECOG\tgood\tincluded\tstrip", "S2\tECOG\tgood\tincluded\tstrip"]
    (subj / "sub-01_run-001_channels.tsv").write_text("\n".join(ch) + "\n")

    rng = np.random.default_rng(seed)
    n_samples = int(np.ceil(cfg.interpolation.end_time * sizes.sfreq)) + 64
    t = np.arange(n_samples) / sizes.sfreq
    elec = pts[sel]
    trials = []
    for i in range(sizes.n_trials):
        a = 1 + 9 * i
        trial = f"G{a}-G{a + 1}"
        srcs = np.concatenate(
            [rng.uniform(10.0, 50.0, size=(2, 2)), np.zeros((2, 1))], axis=1)
        data = wave_field(elec, t, srcs)
        data += 1e-3 * rng.normal(size=data.shape)
        data = np.concatenate([data, rng.normal(size=(n_samples, 2))], axis=1)
        td = subj / "run-001" / trial
        td.mkdir(parents=True, exist_ok=True)
        io.save_evoked_csv(
            td / f"sub-01_ses-1_task-SPESclin_run-001-{trial}-ave.csv",
            data, names + ["S1", "S2"])
        trials.append(trial)
    return trials


def write_movie_trial(root: Path, nx: int, n_frames: int, sfreq: float,
                      seed: int):
    """Subject tree with one trial holding interpolated potentials and
    phases movies (the device stages' inputs) on an nx x nx patch."""
    from manifold_flow_tpu.utils import io

    mesh = surface(nx)
    pts = np.asarray(mesh.points)
    subj = root / "sub-01"
    td = subj / "run-001" / "L1"
    td.mkdir(parents=True, exist_ok=True)
    io.write_ply(subj / "sub-01_reconstructed_surface.ply", pts,
                 np.asarray(mesh.triangles))
    (subj / "sub-01_task-SPESclin_run-001_ieeg.json").write_text(
        json.dumps({"SamplingFrequency": sfreq}))
    rng = np.random.default_rng(seed)
    srcs = np.concatenate(
        [rng.uniform(10.0, 50.0, size=(2, 2)), np.zeros((2, 1))], axis=1)
    t = np.arange(n_frames) / sfreq
    pot = wave_field(pts, t, srcs)
    stem = "sub-01_ses-1_task-SPESclin_run-001-L1-ave"
    io.save_indexed_csv(td / f"{stem}-interpolation_data.csv", pot)
    phases = np.angle(np.exp(1j * 2 * np.pi * pot / 4.0))
    io.save_indexed_csv(td / f"{stem}-interpolation_phases_data.csv", phases)
    return pot, t


# ------------------------------------------------------ phase 2: cohort ----
STAGES = ["interpolate", "flow", "streamline", "decompose", "wavespeed",
          "winding"]


def phase_cohort(root: Path, sizes: Sizes, seed: int) -> dict:
    """The cohort through `cli batch`, then a resume that skips it all."""
    from manifold_flow_tpu.pipeline import batch
    from manifold_flow_tpu.pipeline.config import PipelineConfig

    trials = write_cohort(root, sizes, seed)
    argv = ["batch", "--root", str(root), "--stages", *STAGES]
    rc, report = run_cli(argv)
    check(rc == 0 and not report["errors"],
          f"cohort batch failed: rc={rc} errors={report['errors']}")
    keys = [f"sub-01/run-001/{t}" for t in trials]
    check(sorted(report["interpolation"]) == sorted(keys),
          f"interpolation ran on {sorted(report['interpolation'])}")
    check(all(report["interpolation"][k]["status"] == "done" for k in keys),
          f"interpolation statuses {report['interpolation']}")
    for k in keys:
        check(all(v == "done" for v in report["trials"][k].values())
              and set(report["trials"][k]) == set(batch.DEVICE_STAGES),
              f"{k}: stage statuses {report['trials'][k]}")
    cfg = PipelineConfig()
    found = batch.discover_trials(root)
    n_files = 0
    for tr in found:
        for s in batch.DEVICE_STAGES:
            arts = batch.stage_artifacts(tr, s, cfg)
            check(arts and all(a.exists() for a in arts),
                  f"{tr.key}: {s} artifacts missing")
            n_files += len(arts)
    print(f"  cohort: {len(found)} trials, {n_files} stage artifacts "
          f"written, every stage 'done'")

    rc2, report2 = run_cli(argv)
    check(rc2 == 0 and not report2["errors"], f"resume failed: {report2}")
    check(all(v["status"] == "skipped"
              for v in report2["interpolation"].values()),
          f"resume re-ran interpolation: {report2['interpolation']}")
    check(all(v == "skipped" for k in keys
              for v in report2["trials"][k].values()),
          f"resume re-ran stages: {report2['trials']}")
    print("  resume: second invocation skipped every stage")
    return {"trials": found}


# ------------------------------------------------ phase 3: large trial ----
def phase_large_trial(root: Path, sizes: Sizes, seed: int) -> dict:
    from manifold_flow_tpu.pipeline import batch
    from manifold_flow_tpu.pipeline.config import PipelineConfig
    from manifold_flow_tpu.solve.api import TWO_LEVEL_MIN_VERTICES

    pot, t = write_movie_trial(root, sizes.nx_large, sizes.frames,
                               sizes.sfreq, seed + 100)
    cfg = PipelineConfig()
    trial = batch.discover_trials(root)[0]
    timings: dict = {}
    mesh_cache: dict = {}
    res = batch.run_trial(trial, cfg, mesh_cache=mesh_cache, timings=timings)
    check(all(v == "done" for v in res.values()),
          f"large trial statuses {res}")
    mesh = mesh_cache[trial.surface_path]
    two_level = int(mesh.valid_vertices) >= TWO_LEVEL_MIN_VERTICES
    print(f"  large trial: {int(mesh.valid_vertices)} vertices x "
          f"{pot.shape[0]} frames, precond='auto' -> "
          f"{'two_level' if two_level else 'jacobi'}; stages {res}")
    return {"trial": trial, "pot": pot, "times": t, "timings": timings,
            "mesh": mesh}


# ------------------------------------------------ phase 4: long window ----
def phase_long_window(sizes: Sizes, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.pipeline.config import PipelineConfig
    from manifold_flow_tpu.solve.api import (FRAME_CHUNK_AUTO_MIN,
                                             compute_velocity_fields)

    cfg = PipelineConfig().solver
    mesh = surface(sizes.nx)
    rng = np.random.default_rng(seed + 200)
    srcs = np.concatenate(
        [rng.uniform(10.0, 50.0, size=(2, 2)), np.zeros((2, 1))], axis=1)
    t = np.arange(sizes.long_frames) / sizes.sfreq
    pot = wave_field(np.asarray(mesh.points), t, srcs)
    check(pot.shape[0] - 1 > FRAME_CHUNK_AUTO_MIN,
          "long window does not reach the chunked path")

    @jax.jit
    def solve(p, tt):
        return compute_velocity_fields(
            mesh, p, tt, lambda_=cfg.lambda_, method="auto", tol=cfg.tol,
            inner_tol=cfg.inner_tol, max_iter=cfg.max_iter)

    res = solve(jnp.asarray(pot), jnp.asarray(t))
    conv = np.asarray(res.converged)
    check(conv.all(), f"long window: {int((~conv).sum())} frames unconverged")
    print(f"  long window: {pot.shape[1]} vertices x {pot.shape[0] - 1} "
          f"velocity frames, chunked, all converged")
    return {"mesh": mesh, "pot": pot, "times": t, "res": res,
            "program": solve}


# ------------------------------------------ phase 5: analysis vs the CPU ----
def compare_equal(label, a, b):
    a, b = np.asarray(a), np.asarray(b)
    check(a.shape == b.shape, f"{label}: shapes {a.shape} vs {b.shape}")
    bad = int(np.sum(a != b))
    check(bad == 0, f"{label}: {bad} of {a.size} entries differ")


def compare_close(label, a, b, rtol=ANALYSIS_RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    check(a.shape == b.shape, f"{label}: shapes {a.shape} vs {b.shape}")
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    err = float(np.abs(a - b).max(initial=0.0)) / scale
    check(err <= rtol, f"{label}: max|diff|/max|ref| {err:.3e} beyond "
                       f"{rtol:g} (scale {scale:.3e})")
    return err


def analysis_outputs(mesh, v_k, phases, dt, cfg, device) -> dict:
    """Every analysis stage on `device`, from the same V_k and phases."""
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.ops import singularity as sing_ops
    from manifold_flow_tpu.ops import streamline as stream_ops
    from manifold_flow_tpu.ops import svd as svd_ops
    from manifold_flow_tpu.ops import wavespeed as wave_ops
    from manifold_flow_tpu.ops.recombine import velocity_to_world

    out = {}
    with jax.default_device(device):
        m = jax.device_put(mesh, device)
        vk = jax.device_put(jnp.asarray(v_k), device)
        v = velocity_to_world(vk, m.basis)
        field, counts = sing_ops.detect_with_counts(m, v, eps=cfg.solver.eps)
        out["field"] = jax.tree.map(np.asarray, field)
        counts = np.asarray(counts)
        cap = -(-max(int(counts[0]), int(counts[1]), 1) // 8) * 8
        det = sing_ops.classify_detected(m, v, field, capacity=cap,
                                         quirks=cfg.reference_quirks)
        out["classes"] = jax.tree.map(np.asarray, det)
        out["compact"] = sing_ops.compact_all(m, field, capacity=cap,
                                              with_centers=True)
        sl = stream_ops.trace_frames_adaptive(
            m, v, max_steps=cfg.analysis.max_streamline_steps,
            quirks=cfg.reference_quirks)
        out["lengths"] = np.asarray(sl.lengths)
        out["lines"] = stream_ops.compact_frames(
            m, sl, min_length=cfg.analysis.min_streamline_length)
        modes = svd_ops.decompose_concat(vk, n_modes=cfg.analysis.n_modes)
        out["svd"] = jax.tree.map(np.asarray, modes)
        out["wave"] = np.asarray(wave_ops.wave_velocity_phase_mm_per_ms(
            m, jax.device_put(jnp.asarray(phases), device), dt))
        out["v"] = v
        out["mesh"] = m
    return out


def winding_outputs(out, points_src, cfg, device) -> dict:
    """Winding on `device` from the same compacted detections."""
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.ops import winding as wind_ops

    compacted = points_src["compact"]
    t = len(compacted)
    smax = max(8, -(-max(len(c[0]) for c in compacted) // 8) * 8)
    pts = np.zeros((t, smax, 3))
    valid = np.zeros((t, smax), bool)
    centers = np.zeros((t, smax), np.int32)
    for k, (p, _, _, c) in enumerate(compacted):
        pts[k, : len(p)] = p
        valid[k, : len(p)] = True
        centers[k, : len(p)] = c
    with jax.default_device(device):
        res = wind_ops.analyze_singularities_movie(
            out["mesh"], jnp.asarray(out["v"]), pts, valid,
            max_level=cfg.analysis.max_winding_level, centers=centers)
        return jax.tree.map(np.asarray, res)


def vertex_flip_margins(mesh, v_k, field_a, field_b, eps):
    """Margins |v|/vmax - eps of vertex-mask flips (printed, not hidden)."""
    from manifold_flow_tpu.ops.recombine import velocity_to_world

    v = np.asarray(velocity_to_world(np.asarray(v_k),
                                     np.asarray(mesh.basis)))
    sp = np.linalg.norm(v, axis=-1)
    ratio = sp / np.maximum(sp.max(axis=1, keepdims=True), 1e-300)
    flips = np.argwhere(field_a.vertex_mask != field_b.vertex_mask)
    return [(int(k), int(i), float(ratio[k, i] - eps)) for k, i in flips]


def compare_analysis(mesh, v_k, phases, dt, cfg, gpu, cpu) -> None:
    """Card vs CPU backend on every analysis stage, same inputs."""
    a = analysis_outputs(mesh, v_k, phases, dt, cfg, gpu)
    b = analysis_outputs(mesh, v_k, phases, dt, cfg, cpu)
    flips = vertex_flip_margins(mesh, v_k, a["field"], b["field"],
                                cfg.solver.eps)
    for k, i, margin in flips[:20]:
        print(f"  detect flip: frame {k} vertex {i}, |v|/vmax - eps = "
              f"{margin:.3e}")
    compare_equal("detect vertex_mask", a["field"].vertex_mask,
                  b["field"].vertex_mask)
    compare_equal("detect interior_mask", a["field"].interior_mask,
                  b["field"].interior_mask)
    m = a["field"].interior_mask
    d_pt = compare_close("detect interior points",
                         a["field"].interior_point[m],
                         b["field"].interior_point[m])
    for name in a["classes"]._fields:
        compare_equal(f"classify {name}", getattr(a["classes"], name),
                      getattr(b["classes"], name))
    check(len(a["compact"]) == len(b["compact"]), "detect frame counts")
    for k, (ca, cb) in enumerate(zip(a["compact"], b["compact"])):
        compare_equal(f"detect ids frame {k}", ca[2], cb[2])
        compare_equal(f"detect centers frame {k}", ca[3], cb[3])
    compare_equal("streamline lengths", a["lengths"], b["lengths"])
    n_lines = 0
    for k, (la, lb) in enumerate(zip(a["lines"], b["lines"])):
        check(len(la) == len(lb), f"streamline count frame {k}")
        for pa, pb in zip(la, lb):
            compare_equal(f"streamline frame {k}", pa, pb)
        n_lines += len(la)
    d_sig = compare_close("svd sigma", a["svd"].sigma, b["svd"].sigma)
    # Singular vectors are defined up to sign: align each mode first.
    su = np.sign(np.sum(a["svd"].u * b["svd"].u, axis=0))
    d_u = compare_close("svd u (up to sign)", a["svd"].u * su, b["svd"].u)
    d_vt = compare_close("svd vt (up to sign)", a["svd"].vt * su[:, None],
                         b["svd"].vt)
    d_wave = compare_close("wave speeds", a["wave"], b["wave"])
    wa = winding_outputs(a, a, cfg, gpu)
    wb = winding_outputs(b, a, cfg, cpu)
    compare_equal("winding ring counts", wa.counts, wb.counts)
    compare_equal("winding types", wa.types, wb.types)
    d_wn = compare_close("winding numbers", wa.winding_numbers,
                         wb.winding_numbers)
    n_sing = int(a["field"].vertex_mask.sum() + m.sum())
    print(f"  analysis card vs CPU backend: masks, classes, {n_sing} "
          f"detections, {n_lines} streamlines, ring counts/types equal; "
          f"max rel diff points {d_pt:.1e}, sigma {d_sig:.1e}, u "
          f"{d_u:.1e}, vt {d_vt:.1e}, wave {d_wave:.1e}, winding numbers "
          f"{d_wn:.1e} (rtol {ANALYSIS_RTOL:g}: same f64 program on both "
          f"backends, reduction order only); {len(flips)} threshold flips")


def compare_rbf(trial, sizes, cfg) -> float:
    """The interpolated movie vs scipy.interpolate.Rbf, frame by frame."""
    import scipy.interpolate

    from manifold_flow_tpu.pipeline import batch
    from manifold_flow_tpu.utils import io

    task = next(t for t in batch.discover_interpolation_tasks(
        trial.trial_dir.parents[2]) if t.trial_dir == trial.trial_dir)
    names, _ = batch.selected_channel_names(task.channels_path,
                                            tuple(trial.trial.split("-")))
    coords, kept = io.load_grid_electrodes(task.electrodes_path, group=None,
                                           names=names, with_names=True)
    data, ch = io.load_evoked_csv(task.evoked_path)
    s = int(cfg.interpolation.start_time * sizes.sfreq)
    e = int(cfg.interpolation.end_time * sizes.sfreq)
    movie = data[s:e][:, [ch.index(n) for n in kept]]
    pts, _ = io.read_ply(trial.surface_path)
    got = io.load_indexed_csv(trial.movie_path)
    want = np.stack([
        scipy.interpolate.Rbf(*coords.T, movie[k])(*pts.T)
        for k in range(movie.shape[0])])
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"  RBF: {len(kept)} electrodes -> {pts.shape[0]} vertices x "
          f"{movie.shape[0]} frames, max|diff|/max|ref| vs "
          f"scipy.interpolate.Rbf = {err:.3e} (gate {RBF_GATE:g}: both solve "
          f"the same f64 kernel system exactly)")
    check(err < RBF_GATE, f"RBF differs from scipy by {err:.3e}")
    return err


# ------------------------------------------------ phase 6: GPU numerics ----
def check_numerics(mesh, pot, times, v_k, lambda_=0.01, n_check=3) -> dict:
    """TF32 check (f32 operator vs f64) and the refined solve's residual
    (native f64 through fem/operator.py) against the plain reference's
    SciPy sparse assembly."""
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.fem.operator import make_operator
    from manifold_flow_tpu.solve.api import build_rhs
    from tests.oracle import reference_impl as ref

    def to32(tree):
        return jax.tree.map(
            lambda a: a.astype(jnp.float32)
            if hasattr(a, "dtype") and a.dtype == jnp.float64 else a, tree)

    pot = jnp.asarray(pot)
    times = jnp.asarray(times)
    op64 = make_operator(mesh, pot, lambda_)
    op32 = make_operator(to32(mesh), pot.astype(jnp.float32), lambda_)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(pot.shape[0] - 1,
                                                          mesh.n_dof)))
    y64 = jax.jit(lambda o, v: o.matvec(v))(op64, x)
    y32 = jax.jit(lambda o, v: o.matvec(v))(op32, x.astype(jnp.float32))
    tf32 = float(jnp.max(jnp.abs(y32 - y64)) / jnp.max(jnp.abs(y64)))
    print(f"  TF32 check: f32 operator (assembly + matvec) vs f64, max rel "
          f"err {tf32:.3e} (gate {TF32_GATE:g}: f32 gives ~1e-7, TF32 "
          f"~1e-3)")
    check(tf32 < TF32_GATE, f"f32 contractions lose precision: {tf32:.3e}")

    @jax.jit
    def residual(p, tt, v):
        op = make_operator(mesh, p, lambda_)
        f = build_rhs(mesh, op, p, tt)
        return f - op.matvec(v), f

    r, f = (np.asarray(a) for a in residual(pot, times, jnp.asarray(v_k)))
    nv = int(mesh.valid_vertices)
    pts = np.asarray(mesh.points)[:nv]
    tris = np.asarray(mesh.triangles)
    e = ref.orthonormal_basis_np(np.asarray(mesh.normals)[:nv])
    grad_w = ref.hat_gradients_np(pts, tris)
    areas = ref.triangle_areas_np(pts, tris)
    a2 = ref.assemble_a2_np(tris, areas, e, grad_w)
    p_np, t_np, v_np = np.asarray(pot), np.asarray(times), np.asarray(v_k)
    frames = np.unique(np.linspace(0, v_np.shape[0] - 1, n_check).astype(int))
    err = 0.0
    for k in frames:
        a1, fk = ref.assemble_frame_np(p_np[k], p_np[k + 1],
                                       t_np[k + 1] - t_np[k], tris, grad_w,
                                       e, areas)
        r_ref = fk - (a1 + lambda_ * a2) @ v_np[k]
        err = max(err, float(np.abs(r[k] - r_ref).max()
                             / np.abs(f[k]).max()))
    print(f"  residual check: refined-solve residual f - A x (f64, "
          f"fem/operator.py) vs SciPy assembly at the solution, frames "
          f"{frames.tolist()}: max|diff| / max|f| = {err:.3e} (gate "
          f"{RESIDUAL_GATE:g}: both f64)")
    check(err <= RESIDUAL_GATE, f"f64 residual differs: {err:.3e}")
    return {"tf32_rel_err": tf32, "residual_rel_err": err}


# ------------------------------------------------- phase 7: timings ----
def best_time(fn, *args, repeats=5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def workaround_timings(mesh3, pot3, mesh12, pot12, lambda_=0.01):
    """Each workaround against its plain form (smoke timings, not benchmark
    numbers), plus the dispatch latency and chase-gather rate that price
    the streamline planner."""
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.fem.operator import make_operator
    from manifold_flow_tpu.geometry import mesh as mesh_mod
    from manifold_flow_tpu.kernels import reduce as kreduce
    from manifold_flow_tpu.solve import coarse

    out = {}
    rng = np.random.default_rng(1)
    print("  smoke timings, not benchmark numbers (best of 5, after "
          "warm-up, block_until_ready):")

    # Matvec reduction: gather-mode table vs .at[].add (f32, as in PCG).
    for label, mesh, pot in (("3k", mesh3, pot3), ("12k", mesh12, pot12)):
        p32 = jnp.asarray(pot, jnp.float32)
        m32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                           if hasattr(a, "dtype") and a.dtype == jnp.float64
                           else a, mesh)
        op = make_operator(m32, p32, lambda_)
        op_sc = dataclasses.replace(op, gather_base=None)
        x = jnp.asarray(rng.normal(size=(pot.shape[0] - 1, mesh.n_dof)),
                        jnp.float32)
        mv = jax.jit(lambda o, v: o.matvec(v))
        y_g, y_s = mv(op, x), mv(op_sc, x)
        check(bool(jnp.allclose(y_g, y_s, rtol=1e-4, atol=1e-4 * float(
            jnp.max(jnp.abs(y_s))))), "matvec gather vs scatter disagree")
        tg, ts = best_time(mv, op, x), best_time(mv, op_sc, x)
        out[f"matvec_gather_ms_{label}"] = tg * 1e3
        out[f"matvec_scatter_ms_{label}"] = ts * 1e3
        print(f"    matvec {label} x {x.shape[0]} (f32): gather-table "
              f"{tg * 1e3:.3f} ms, .at[].add {ts * 1e3:.3f} ms")

        # The refined solve's per-outer-step residual (native f64).
        op64 = make_operator(mesh, jnp.asarray(pot), lambda_)
        x64 = jnp.asarray(rng.normal(size=(pot.shape[0] - 1, mesh.n_dof)))
        f64 = jnp.asarray(rng.normal(size=x64.shape))
        r_64 = jax.jit(lambda o, f, v: f - o.matvec(v))
        tn = best_time(r_64, op64, f64, x64)
        out[f"residual_f64_ms_{label}"] = tn * 1e3
        print(f"    residual {label} x {x.shape[0]} (f64): {tn * 1e3:.3f} ms")

    # Coarse assembly at 12.5k: ReducePlan vs segment_sum.
    tables = coarse.build_tables(mesh12)
    agg = np.asarray(tables.agg)
    tris = np.asarray(mesh12.triangles)
    nc2 = 2 * tables.n_coarse
    cdof = 2 * agg[tris][:, :, None] + np.arange(2)
    flat = (cdof[:, :, :, None, None] * nc2
            + cdof[:, None, None, :, :]).reshape(-1)
    vals = jnp.asarray(rng.normal(size=(pot12.shape[0] - 1, flat.size)),
                       jnp.float32)
    seg = jnp.asarray(flat.astype(np.int32))
    red = jax.jit(lambda v: kreduce.apply_reduce(tables.asm_plan, v))
    segsum = jax.jit(jax.vmap(
        lambda v: jax.ops.segment_sum(v, seg, num_segments=nc2 * nc2)))
    a_r, a_s = red(vals), segsum(vals)
    check(bool(jnp.allclose(a_r, a_s, rtol=1e-4, atol=1e-3)),
          "coarse assembly: ReducePlan vs segment_sum disagree")
    tr, tsg = best_time(red, vals), best_time(segsum, vals)
    out["coarse_reduceplan_ms_12k"] = tr * 1e3
    out["coarse_segment_sum_ms_12k"] = tsg * 1e3
    print(f"    coarse assembly 12k x {vals.shape[0]} ({flat.size} "
          f"contributions -> {nc2}^2): ReducePlan {tr * 1e3:.3f} ms, "
          f"segment_sum {tsg * 1e3:.3f} ms")

    # Dispatch latency and chase-gather rate (streamline planner pricing).
    tiny = jax.jit(lambda v: v + 1)
    z = jnp.zeros((), jnp.int32)
    jax.block_until_ready(tiny(z))
    lat = []
    for _ in range(200):
        t0 = time.perf_counter()
        jax.block_until_ready(tiny(z))
        lat.append(time.perf_counter() - t0)
    dispatch = float(np.median(lat))
    size = (pot3.shape[0] - 1) * int(mesh3.n_vertices)
    table = jnp.asarray(rng.permutation(size).astype(np.int32))
    hops = 32

    @jax.jit
    def chase(tab, idx):
        return jax.lax.fori_loop(0, hops, lambda _, i: tab[i], idx)

    tc = best_time(chase, table, jnp.arange(size, dtype=jnp.int32))
    rate = hops * size / tc
    out["dispatch_s"] = dispatch
    out["chase_gather_per_s"] = rate
    out["dispatch_gather_equiv"] = dispatch * rate
    print(f"    dispatch latency {dispatch * 1e6:.1f} us (median of 200); "
          f"chase gather {rate / 1e9:.2f} Ge/s ({hops} dependent rounds of "
          f"{size} elements); one dispatch = {dispatch * rate:.3g} gathered "
          f"elements")

    # Geometry precompute at 12.5k: default device vs pinned to the CPU.
    pts = np.asarray(mesh12.points)
    tri = np.asarray(mesh12.triangles)
    nv = int(mesh12.n_vertices)
    cpu = jax.devices("cpu")[0]

    def on_default():
        return mesh_mod._precompute_jit(pts, tri, None, nv)

    def on_cpu():
        with jax.default_device(cpu):
            res = mesh_mod._precompute_jit(pts, tri, None, nv)
        return tuple(jnp.asarray(np.asarray(a)) for a in res)

    tdef, tcpu = best_time(on_default), best_time(on_cpu)
    out["geometry_default_ms_12k"] = tdef * 1e3
    out["geometry_cpu_ms_12k"] = tcpu * 1e3
    print(f"    geometry precompute 12k: default device {tdef * 1e3:.3f} ms,"
          f" CPU-pinned + upload {tcpu * 1e3:.3f} ms")
    return out


# --------------------------------------------------------------- costs ----
def memory_report(label, compiled) -> None:
    ma = compiled.memory_analysis()
    keys = ("argument", "output", "temp", "generated_code")
    print(f"  memory_analysis {label}: " + ", ".join(
        f"{k} {int(getattr(ma, f'{k}_size_in_bytes', 0) or 0) / 2**20:.1f} "
        f"MiB" for k in keys))


def print_walls(label, timings) -> None:
    walls = {k: v for k, v in timings.items() if isinstance(v, float)}
    print(f"  stage walls {label} (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()))
    for sub in ("flow_detail", "streamline_detail"):
        if sub in timings:
            print(f"    {sub}: " + ", ".join(
                f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in timings[sub].items()))


# ---------------------------------------------------------------- main ----
def run_one_card(sizes: Sizes, workdir: Path, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.pipeline import batch
    from manifold_flow_tpu.pipeline import stages as S
    from manifold_flow_tpu.pipeline.config import PipelineConfig
    from manifold_flow_tpu.utils import io

    cfg = PipelineConfig()
    costs: dict = {}
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]

    with phase("phase 2: cohort through cli batch", costs):
        cohort = phase_cohort(workdir / "cohort", sizes, seed)
    with phase("phase 3: 12,544-vertex trial", costs):
        large = phase_large_trial(workdir / "large", sizes, seed)
    with phase("phase 4: long window", costs):
        long = phase_long_window(sizes, seed)

    with phase("phase 5: correctness", costs):
        t3 = cohort["trials"][0]
        mesh3 = S.load_surface(t3.surface_path)
        movie3 = io.load_indexed_csv(t3.movie_path)[: cfg.solver.time_steps]
        times3 = np.arange(movie3.shape[0]) / sizes.sfreq
        names3 = batch.artifact_names(batch.trial_prefix(t3))
        vk3 = io.load_indexed_csv(t3.trial_dir / names3["v_k"])
        # A re-run of this trial (fresh mesh cache: re-trace, persistent
        # compile cache) records stage walls and solver counters.
        walls3: dict = {}
        mc3: dict = {}
        batch.run_trial(t3, cfg, overwrite=True, mesh_cache=mc3,
                        timings=walls3)
        fd3 = walls3["flow_detail"]
        for i, tr in enumerate(cohort["trials"]):
            mv = io.load_indexed_csv(tr.movie_path)[: cfg.solver.time_steps]
            vk = io.load_indexed_csv(
                tr.trial_dir / batch.artifact_names(
                    batch.trial_prefix(tr))["v_k"])
            # Solver counters come from the recorded re-run of trial 0;
            # `cli batch` reports statuses only.
            check_solve(f"3k trial {tr.trial}", mesh3, mv, times3, vk,
                        sizes.check_frames,
                        iterations=fd3["solve_iterations"] if i == 0
                        else "not recorded",
                        outer_steps=fd3["solve_outer_steps"] if i == 0
                        else "not recorded")
        lt = large["trial"]
        mesh12 = S.load_surface(lt.surface_path)
        vk12 = io.load_indexed_csv(
            lt.trial_dir / batch.artifact_names(
                batch.trial_prefix(lt))["v_k"])
        fd12 = large["timings"]["flow_detail"]
        check_solve("12k trial", mesh12, io.load_indexed_csv(lt.movie_path),
                    large["times"], vk12, sizes.check_frames,
                    iterations=fd12["solve_iterations"],
                    outer_steps=fd12["solve_outer_steps"])
        lr = long["res"]
        check_solve("3k x 391 chunked", long["mesh"], long["pot"],
                    long["times"], np.asarray(lr.v_k), sizes.check_frames,
                    iterations=int(lr.iterations),
                    outer_steps=int(lr.outer_steps))
        compare_rbf(t3, sizes, cfg)
        phases3 = io.load_indexed_csv(t3.phases_path)
        compare_analysis(mesh3, vk3, phases3, 1.0 / sizes.sfreq, cfg, gpu,
                         cpu)

    with phase("phase 6: GPU numerics", costs):
        check_numerics(mesh3, movie3, times3, vk3)

    with phase("phase 7: workaround timings", costs):
        workaround_timings(long["mesh"], long["pot"][: sizes.frames],
                           mesh12, large["pot"])

    with phase("phase 8: costs", costs):
        from manifold_flow_tpu.geometry.mesh import pad_vertex_field

        for mesh, movie, tt in ((mc3[t3.surface_path], movie3, times3),
                                (large["mesh"], large["pot"],
                                 large["times"])):
            prog = S._fused_flow_program(mesh, "refined", cfg)
            p = jnp.asarray(pad_vertex_field(mesh, np.asarray(movie)))
            memory_report(
                f"flow program {int(mesh.valid_vertices)} x {p.shape[0]}",
                prog.lower(p, jnp.asarray(tt)).compile())
        memory_report(
            f"flow program {long['pot'].shape[1]} x {long['pot'].shape[0]}",
            long["program"].lower(jnp.asarray(long["pot"]),
                                  jnp.asarray(long["times"])).compile())
        peak = (gpu.memory_stats() or {}).get("peak_bytes_in_use")
        print(f"  peak_bytes_in_use: {peak / 2**30:.2f} GiB" if peak else
              "  peak_bytes_in_use: not reported by this backend")
        print_walls("3k trial (re-run, fresh mesh cache)", walls3)
        print_walls("12k trial", large["timings"])
        for name, c in costs.items():
            print(f"  {name}: wall {c['wall_s']:.1f} s, compile "
                  f"{c['compile_s']:.1f} s")


def run_four_cards(sizes: Sizes, workdir: Path, seed: int) -> None:
    """The multi-card path and the single-card result it is compared
    with: a frames-sharded trial on a (4, 1) mesh, and the halo-sharded
    12,544-vertex refined solve on (1, 4) and (2, 2) meshes."""
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.parallel import (make_device_mesh,
                                            sharded_compute_velocity_fields)
    from manifold_flow_tpu.pipeline import batch
    from manifold_flow_tpu.pipeline.config import PipelineConfig
    from manifold_flow_tpu.solve.api import compute_velocity_fields
    from manifold_flow_tpu.utils import io

    check(len(jax.devices()) >= 4, f"--four-cards needs 4 devices, have "
                                   f"{len(jax.devices())}")
    cfg = PipelineConfig()
    costs: dict = {}
    with phase("four cards: frames-sharded trial", costs):
        root = workdir / "four"
        write_cohort(root, dataclasses.replace(sizes, n_trials=1), seed)
        rep = batch.run_batch(root, cfg, stages=("interpolate",))
        check(not rep["errors"], f"interpolation failed: {rep['errors']}")
        trial = batch.discover_trials(root)[0]
        names = batch.artifact_names(batch.trial_prefix(trial))
        res1 = batch.run_trial(trial, cfg)
        check(all(v == "done" for v in res1.values()), f"single {res1}")
        single = {k: (io.load_indexed_csv(trial.trial_dir / names[k])
                      if k == "v_k" else
                      io.load_pickle(trial.trial_dir / names[k]))
                  for k in ("v_k", "singularity", "wavespeed", "winding")}
        res4 = batch.run_trial(trial, cfg, overwrite=True,
                               device_mesh=make_device_mesh(4, 1))
        check(all(v == "done" for v in res4.values()), f"sharded {res4}")
        vk4 = io.load_indexed_csv(trial.trial_dir / names["v_k"])
        err = rel_rmse(vk4, single["v_k"])
        print(f"  trial (4, 1) vs one card: V_k RMSE/max {err:.3e} (gate "
              f"{SOLVE_RMSE_GATE:g}: both converge to tol "
              f"{cfg.solver.tol:g})")
        check(err < SOLVE_RMSE_GATE, f"sharded trial V_k differs: {err:.3e}")
        wave4 = np.asarray(io.load_pickle(trial.trial_dir / names[
            "wavespeed"]))
        compare_close("sharded wave speeds", wave4,
                      np.asarray(single["wavespeed"]), rtol=1e-10)
        sing4 = io.load_pickle(trial.trial_dir / names["singularity"])
        check([len(a) for a in sing4] == [len(b) for b in
                                          single["singularity"]],
              "sharded trial: singularity counts per frame differ")
        wind4 = io.load_pickle(trial.trial_dir / names["winding"])
        check(set(wind4) == set(single["winding"]), "winding frames differ")
        for k in wind4:
            check([tuple(r[1:]) for r in wind4[k]]
                  == [tuple(r[1:]) for r in single["winding"][k]],
                  f"winding ring counts/types differ in frame {k}")
        print("  trial (4, 1): singularity counts, wave speeds, winding "
              "ring counts/types equal to one card")

    with phase("four cards: halo-sharded 12k refined solve", costs):
        mesh = surface(sizes.nx_large)
        rng = np.random.default_rng(seed + 300)
        srcs = np.concatenate(
            [rng.uniform(10.0, 50.0, size=(2, 2)), np.zeros((2, 1))], axis=1)
        t = np.arange(sizes.frames) / sizes.sfreq
        pot = jnp.asarray(wave_field(np.asarray(mesh.points), t, srcs))
        tt = jnp.asarray(t)
        kw = dict(lambda_=cfg.solver.lambda_, tol=cfg.solver.tol,
                  max_iter=cfg.solver.max_iter, inner_tol=cfg.solver.inner_tol)
        one = compute_velocity_fields(mesh, pot, tt, method="refined",
                                      precond="two_level", **kw)
        v1 = np.asarray(one.v_k)
        for shape in ((1, 4), (2, 2)):
            dm = make_device_mesh(*shape)
            res = sharded_compute_velocity_fields(
                mesh, pot, tt, dm, method="refined", precond="two_level",
                **kw)
            conv = np.asarray(res.converged)
            err = rel_rmse(np.asarray(res.v_k), v1)
            print(f"  halo solve {shape}: {int(mesh.n_vertices)} vertices x "
                  f"{v1.shape[0]} frames, iterations {int(res.iterations)} "
                  f"(one card {int(one.iterations)}), V_k RMSE/max vs one "
                  f"card {err:.3e} (gate {SOLVE_RMSE_GATE:g})")
            check(conv.all(), f"halo {shape}: unconverged frames")
            check(err < SOLVE_RMSE_GATE, f"halo {shape} differs: {err:.3e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default=str(ROOT / ".smoke_work"))
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-card path and its one-card "
                        "comparison (needs 4 GPUs)")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    from manifold_flow_tpu.utils.compile_cache import configure_compile_cache

    dev = device_gate()
    configure_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    import jaxlib

    print(f"device: {dev['kind']} x {dev['count']} ({dev['platform']}); "
          f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"card: {card_info()}", flush=True)

    workdir = Path(args.workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    sizes = Sizes()
    try:
        if args.four_cards:
            run_four_cards(sizes, workdir, args.seed)
        else:
            run_one_card(sizes, workdir, args.seed)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
