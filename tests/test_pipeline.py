"""Pipeline stages, artifact IO roundtrips, CLI, and config interop."""

import json
import subprocess
import sys

import numpy as np
import pytest

from manifold_flow_tpu.geometry import synthetic
from manifold_flow_tpu.pipeline import stages
from manifold_flow_tpu.pipeline.config import PipelineConfig
from manifold_flow_tpu.utils import io


# ------------------------------------------------------------------ io ----
def test_ply_roundtrip(tmp_path, small_mesh):
    pts = np.asarray(small_mesh.points)
    tris = np.asarray(small_mesh.triangles)
    for binary in (True, False):
        p = tmp_path / f"m_{binary}.ply"
        io.write_ply(p, pts, tris, binary=binary)
        pts2, tris2 = io.read_ply(p)
        np.testing.assert_allclose(pts2, pts, atol=1e-6)
        np.testing.assert_array_equal(tris2, tris)


def test_indexed_csv_roundtrip(tmp_path):
    data = np.random.default_rng(0).normal(size=(5, 7))
    p = tmp_path / "d.csv"
    io.save_indexed_csv(p, data)
    # pandas reads it the way the reference does (index_col=0).
    import pandas as pd

    df = pd.read_csv(p, index_col=0)
    np.testing.assert_allclose(df.values, data)
    np.testing.assert_allclose(io.load_indexed_csv(p), data)


def test_e_csv_roundtrip(tmp_path, small_mesh):
    e = np.asarray(small_mesh.basis)
    p = tmp_path / "e.csv"
    io.save_e_csv(p, e)
    np.testing.assert_allclose(io.load_e_csv(p), e)


def test_pickle_bz2_roundtrip(tmp_path):
    obj = {"0": [np.arange(3), np.arange(2)]}
    for name in ("x.pkl", "x.pkl.bz2"):
        p = tmp_path / name
        io.save_pickle(p, obj)
        back = io.load_pickle(p)
        assert list(back) == ["0"]
        np.testing.assert_array_equal(back["0"][0], obj["0"][0])


def test_load_grid_electrodes(tmp_path):
    tsv = tmp_path / "electrodes.tsv"
    tsv.write_text(
        "name\tx\ty\tz\tgroup\n"
        "G1\t0.0\t0.0\t1.0\tgrid\n"
        "G2\t1.0\t0.0\t1.0\tgrid\n"
        "S1\t5.0\t5.0\t5.0\tstrip\n"
        "G3\tn/a\tn/a\tn/a\tgrid\n")
    coords = io.load_grid_electrodes(tsv)
    assert coords.shape == (2, 3)
    coords, names = io.load_grid_electrodes(tsv, exclude=["G2"],
                                            with_names=True)
    assert names == ["G1"]


# -------------------------------------------------------------- config ----
def test_config_reads_reference_yaml(tmp_path):
    y = tmp_path / "config.yaml"
    y.write_text(
        "general:\n  lambda_: 0.02\n  eps: 1e-3\n  time_steps: 50\n"
        "  processes_num: 32\n"
        "sub_01:\n  surface_path: /a/s.ply\n  threshold: 7.5\n")
    cfg = PipelineConfig.from_yaml(y)
    assert cfg.solver.lambda_ == 0.02
    assert cfg.solver.eps == 1e-3
    assert cfg.solver.time_steps == 50
    assert cfg.subjects["sub_01"].surface_path == "/a/s.ply"
    assert cfg.analysis.threshold == 7.5


def test_config_roundtrip(tmp_path):
    cfg = PipelineConfig()
    cfg.solver.lambda_ = 0.5
    path = tmp_path / "out.yaml"
    cfg.to_yaml(path)
    cfg2 = PipelineConfig.from_yaml(path)
    assert cfg2.solver.lambda_ == 0.5
    # The tuple-valued inner_tol schedule survives YAML (list form).
    assert tuple(cfg2.solver.inner_tol) == tuple(cfg.solver.inner_tol)


def test_config_solver_defaults_match_api():
    """Production (pipeline config) must run the measured-best solver
    configuration the bench measures — the tight-first inner_tol schedule —
    not a stale scalar."""
    import inspect

    from manifold_flow_tpu.pipeline.config import SolverConfig
    from manifold_flow_tpu.solve.api import compute_velocity_fields
    from manifold_flow_tpu.solve.refine import DEFAULT_INNER_TOL

    assert tuple(SolverConfig().inner_tol) == tuple(DEFAULT_INNER_TOL)
    api_default = inspect.signature(
        compute_velocity_fields).parameters["inner_tol"].default
    assert tuple(api_default) == tuple(DEFAULT_INNER_TOL)


def test_config_inner_tol_schedule_from_yaml(tmp_path):
    """YAML can express both scalar and schedule inner_tol, including the
    reference's string-exponent quirk ('1e-4'-style literals)."""
    y = tmp_path / "config.yaml"
    y.write_text("general:\n  inner_tol: [1e-3, '1e-2']\n")
    cfg = PipelineConfig.from_yaml(y)
    assert cfg.solver.inner_tol == (1e-3, 1e-2)
    y.write_text("general:\n  inner_tol: '3e-3'\n")
    assert PipelineConfig.from_yaml(y).solver.inner_tol == 3e-3


def test_inner_tol_schedule_normalization():
    """Arrays of tolerances normalize like tuples instead of silently
    becoming a vector step_tol that broadcasts per frame."""
    import jax.numpy as jnp

    from manifold_flow_tpu.solve.refine import as_inner_schedule

    assert as_inner_schedule(1e-3) == (1e-3,)
    assert as_inner_schedule((1e-3, 1e-2)) == (1e-3, 1e-2)
    assert as_inner_schedule(np.asarray([1e-3, 1e-2])) == (1e-3, 1e-2)
    assert len(as_inner_schedule(jnp.asarray(1e-3))) == 1
    with pytest.raises(ValueError):
        as_inner_schedule(np.ones((2, 2)))
    with pytest.raises(ValueError):
        as_inner_schedule(())


# -------------------------------------------------------------- stages ----
@pytest.fixture(scope="module")
def demo_problem():
    mesh = synthetic.plane_patch(
        nx=14, ny=14, lx=8.0, ly=8.0,
        height=lambda x, y: 0.4 * np.sin(x) * np.cos(y))
    pot, times, truth = synthetic.two_source_movie(
        mesh, sources=((2.0, 2.0), (6.0, 6.0)), n_frames=6)
    return mesh, pot, times, truth


def test_velocity_stage_artifacts(tmp_path, demo_problem):
    mesh, pot, times, _ = demo_problem
    cfg = PipelineConfig()
    cfg.solver.tol = 1e-8
    res = stages.velocity_stage(
        mesh, pot, times, cfg,
        e_path=tmp_path / "e.csv", v_k_path=tmp_path / "V_k.csv",
        speed_path=tmp_path / "speed.pkl.bz2")
    assert res.converged
    assert res.v_k.shape == (pot.shape[0] - 1, mesh.n_dof)
    # Artifacts reload to the same values (the reference's file contract).
    np.testing.assert_allclose(io.load_e_csv(tmp_path / "e.csv"), res.e)
    np.testing.assert_allclose(
        io.load_indexed_csv(tmp_path / "V_k.csv"), res.v_k, atol=1e-12)
    speed = io.load_pickle(tmp_path / "speed.pkl.bz2")
    np.testing.assert_allclose(speed, res.speed, atol=1e-12)
    # Speed is the norm of the recombined world field (S3:127-137).
    np.testing.assert_allclose(
        speed, np.linalg.norm(res.v_world, axis=-1), atol=1e-10)


def test_velocity_stage_nonconvergence_warns_and_escalates(demo_problem):
    """max_iter=1 cannot converge: the stage must warn with frame indices
    and, with solver.escalate, retry via the refined solver."""
    mesh, pot, times, _ = demo_problem
    cfg = PipelineConfig()
    cfg.solver.method = "cg"
    cfg.solver.max_iter = 1
    cfg.solver.tol = 1e-10
    with pytest.warns(stages.ConvergenceWarning, match="escalating"):
        res = stages.velocity_stage(mesh, np.float64(1.0) * pot, times, cfg)
    assert res.v_k.shape == (pot.shape[0] - 1, mesh.n_dof)

    cfg.solver.escalate = False
    with pytest.warns(stages.ConvergenceWarning, match="NOT converged"):
        res2 = stages.velocity_stage(mesh, pot, times, cfg)
    assert not res2.converged


def test_velocity_stage_auto_refined_does_not_self_escalate(
        demo_problem, monkeypatch):
    """method='auto' resolving to 'refined' (accelerator + f64) must not
    'escalate' a failed refined solve by re-running the identical solver —
    the guard compares against the RESOLVED method."""
    import types

    import jax

    from manifold_flow_tpu.pipeline import stages as stages_mod

    mesh, pot, times, _ = demo_problem
    cfg = PipelineConfig()
    assert cfg.solver.method == "auto"
    cfg.solver.max_iter = 1
    cfg.solver.tol = 1e-14
    monkeypatch.setattr(
        jax, "devices",
        lambda *a, **k: [types.SimpleNamespace(platform="gpu")])
    with pytest.warns(stages.ConvergenceWarning) as rec:
        stages_mod.velocity_stage(mesh, np.float64(1.0) * pot, times, cfg)
    msgs = [str(w.message) for w in rec]
    assert any("NOT converged" in m for m in msgs)
    assert not any("escalating" in m for m in msgs)


def test_velocity_stage_escalates_under_mesh_sharding(demo_problem):
    """Mesh-sharded runs keep the refined safety net: the halo partition
    supports method='refined', so the escalation guard must not refuse
    device meshes with mesh > 1."""
    from manifold_flow_tpu.parallel import make_device_mesh

    mesh, pot, times, _ = demo_problem
    cfg = PipelineConfig()
    cfg.solver.method = "cg"
    cfg.solver.max_iter = 8
    cfg.solver.tol = 1e-9
    dm = make_device_mesh(2, 4)
    with pytest.warns(stages.ConvergenceWarning, match="escalating"):
        res = stages.velocity_stage(mesh, np.float64(1.0) * pot, times, cfg,
                                    device_mesh=dm)
    assert res.converged


def test_velocity_stage_escalation_recovers(demo_problem):
    """A starved-but-not-hopeless cg solve escalates to refined and the
    escalated result actually converges."""
    mesh, pot, times, _ = demo_problem
    cfg = PipelineConfig()
    cfg.solver.method = "cg"
    cfg.solver.max_iter = 8    # refined's outer loop recovers; plain cg can't
    cfg.solver.tol = 1e-9
    with pytest.warns(stages.ConvergenceWarning, match="escalating"):
        res = stages.velocity_stage(mesh, np.float64(1.0) * pot, times, cfg)
    assert res.converged


def test_singularity_stage(tmp_path, demo_problem):
    mesh, pot, times, _ = demo_problem
    cfg = PipelineConfig()
    vel = stages.velocity_stage(mesh, pot, times, cfg)
    pts, labels = stages.singularity_stage(
        mesh, vel.v_world, cfg, classify=True,
        save_path=tmp_path / "sing.pkl",
        classification_path=tmp_path / "classification.pkl")
    assert len(pts) == vel.v_k.shape[0]
    assert labels is not None and len(labels) == len(pts)
    saved = io.load_pickle(tmp_path / "sing.pkl")
    assert len(saved) == len(pts)
    # The classification artifact the reference names in config.yaml but
    # never writes (S3:145-156) round-trips as per-frame label lists.
    cls = io.load_pickle(tmp_path / "classification.pkl")
    assert cls == labels


def test_decompose_stage(tmp_path, demo_problem):
    mesh, pot, times, _ = demo_problem
    cfg = PipelineConfig()
    vel = stages.velocity_stage(mesh, pot, times, cfg)
    modes = stages.decompose_stage(vel.v_k, cfg, mode="concat",
                                   npz_path=tmp_path / "data_01.npz")
    z = np.load(tmp_path / "data_01.npz")
    assert set(z.files) == {"U", "Sigma", "VT", "point_num"}
    assert int(z["point_num"]) == mesh.n_vertices
    assert np.all(np.diff(np.asarray(modes.sigma)) <= 1e-12)


def test_wavespeed_stage(demo_problem):
    mesh, pot, times, _ = demo_problem
    ws = stages.wavespeed_stage(mesh, pot, dt=float(times[1] - times[0]),
                                method="amplitude")
    assert ws.shape == (pot.shape[0], mesh.n_vertices)
    assert np.all(np.isfinite(ws))


def test_mesh_cache_roundtrip(tmp_path, small_mesh):
    from manifold_flow_tpu.utils import cache

    pts = np.asarray(small_mesh.points)
    tris = np.asarray(small_mesh.triangles)
    m1 = cache.build_mesh_cached(pts, tris, cache_dir=tmp_path)
    files = list(tmp_path.glob("mesh_*.npz"))
    assert len(files) == 1
    m2 = cache.build_mesh_cached(pts, tris, cache_dir=tmp_path)  # cache hit
    assert len(list(tmp_path.glob("mesh_*.npz"))) == 1
    np.testing.assert_allclose(np.asarray(m2.basis), np.asarray(m1.basis))
    np.testing.assert_array_equal(np.asarray(m2.vertex_cells),
                                  np.asarray(m1.vertex_cells))
    assert m2.n_vertices == m1.n_vertices
    # Different mesh -> different key.
    cache.build_mesh_cached(pts * 2.0, tris, cache_dir=tmp_path)
    assert len(list(tmp_path.glob("mesh_*.npz"))) == 2


# ----------------------------------------------------------------- cli ----
def test_cli_demo_end_to_end(tmp_path):
    """The demo subcommand runs the full flow on CPU and prints stats JSON."""
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"}
    import os

    env.update({k: v for k, v in os.environ.items()
                if k not in env and k != "JAX_PLATFORMS"})
    out = subprocess.run(
        [sys.executable, "-m", "manifold_flow_tpu.pipeline.cli", "demo",
         "--nx", "10", "--frames", "4", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=1500, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["stage"] == "demo"
    assert stats["converged"] is True
    assert (tmp_path / "V_k.csv").exists()
    assert (tmp_path / "singularity_points.pkl").exists()


def test_cli_visualize_and_render_modes(tmp_path, demo_problem):
    """In-process CLI: true-vs-detected PNG/GIF with a pial underlay, and
    decompose --render-modes spatial-mode glyph PNGs."""
    import matplotlib

    matplotlib.use("Agg")
    from manifold_flow_tpu.pipeline import cli

    mesh, pot, times, truth = demo_problem
    cfg = PipelineConfig()
    io.write_ply(tmp_path / "surface.ply", np.asarray(mesh.points),
                 np.asarray(mesh.triangles))
    vel = stages.velocity_stage(mesh, pot, times, cfg,
                                e_path=tmp_path / "e.csv",
                                v_k_path=tmp_path / "V_k.csv")
    pts, _ = stages.singularity_stage(mesh, vel.v_world, cfg,
                                      save_path=tmp_path / "sing.pkl")
    io.save_pickle(tmp_path / "true.pkl", [np.asarray(truth)] * len(pts))
    io.write_freesurfer_surface(
        tmp_path / "lh.pial", np.asarray(mesh.points) * 1.5,
        np.asarray(mesh.triangles))

    base = ["visualize", "--surface", str(tmp_path / "surface.ply"),
            "--e", str(tmp_path / "e.csv"), "--v-k", str(tmp_path / "V_k.csv"),
            "--singularities", str(tmp_path / "sing.pkl"),
            "--true-singularities", str(tmp_path / "true.pkl"),
            "--out-dir", str(tmp_path), "--stride", "4"]
    cli.main(base + ["--frame", "1", "--pial", str(tmp_path / "lh.pial")])
    assert (tmp_path / "velocity_frame_1.png").stat().st_size > 0
    cli.main(base + ["--gif"])
    assert (tmp_path / "true_vs_detected.gif").stat().st_size > 0

    cli.main(["decompose", "--v-k", str(tmp_path / "V_k.csv"),
              "--surface", str(tmp_path / "surface.ply"),
              "--render-modes", "2", "--pial", str(tmp_path / "lh.pial"),
              "--out-dir", str(tmp_path)])
    assert (tmp_path / "spatial_mode_1.png").stat().st_size > 0
    assert (tmp_path / "spatial_mode_2.png").stat().st_size > 0


def test_interpolate_stage_phases_quirk_axis(demo_problem):
    """config.reference_quirks switches the Hilbert transform to scipy's
    default axis=-1 — the ELECTRODE axis the reference actually uses
    (S2_interpolate_phases.py:66) — and the stage output then matches the
    reference path (scipy hilbert -> e^{i phi} -> complex RBF -> angle)."""
    import scipy.signal

    mesh, _, _, _ = demo_problem
    rng = np.random.default_rng(3)
    sel = rng.choice(mesh.n_vertices, 12, replace=False)
    coords = np.asarray(mesh.points)[sel]
    t = np.linspace(0.0, 1.0, 24)
    data = (np.sin(2 * np.pi * 3 * t)[:, None]
            + 0.3 * rng.normal(size=(24, 12)))

    from manifold_flow_tpu.ops import interpolate as rbf_ops
    import jax.numpy as jnp

    outs = {}
    for quirk in (False, True):
        cfg = PipelineConfig()
        cfg.reference_quirks = quirk
        outs[quirk] = stages.interpolate_stage(
            mesh, coords, data, cfg, phases=True)
        phi = np.angle(scipy.signal.hilbert(data, axis=-1 if quirk else 0))
        want = np.angle(np.asarray(rbf_ops.rbf_interpolate(
            jnp.asarray(coords), jnp.asarray(np.exp(1j * phi)),
            mesh.points)))
        np.testing.assert_allclose(outs[quirk], want, rtol=1e-7, atol=1e-9)
    assert not np.allclose(outs[False], outs[True])


def test_interpolate_stage_windows_agree(demo_problem):
    """With sfreq set, potentials and phases branches apply ONE window
    [start_time, end_time) to the same frames — and the phases window cuts
    the Hilbert OUTPUT, not its input (the analytic signal sees the whole
    recording, as in S2_interpolate_phases.py)."""
    import jax.numpy as jnp
    import scipy.signal

    from manifold_flow_tpu.ops import interpolate as rbf_ops

    mesh, _, _, _ = demo_problem
    rng = np.random.default_rng(7)
    sel = rng.choice(mesh.n_vertices, 10, replace=False)
    coords = np.asarray(mesh.points)[sel]
    t = np.linspace(0.0, 1.0, 32)
    data = (np.sin(2 * np.pi * 4 * t)[:, None]
            + 0.2 * rng.normal(size=(32, 10)))

    cfg = PipelineConfig()
    sfreq = 16.0
    cfg.interpolation.start_time = 0.25
    cfg.interpolation.end_time = 1.0
    s = int(cfg.interpolation.start_time * sfreq)
    e = int(cfg.interpolation.end_time * sfreq)

    pot = stages.interpolate_stage(mesh, coords, data, cfg, sfreq=sfreq)
    pha = stages.interpolate_stage(mesh, coords, data, cfg, sfreq=sfreq,
                                   phases=True)
    assert pot.shape[0] == pha.shape[0] == e - s
    pot_full = stages.interpolate_stage(mesh, coords, data, cfg)
    np.testing.assert_allclose(pot, pot_full[s:e], rtol=1e-12)
    # Hilbert over the FULL series, then the same [s:e) window.
    phi = np.angle(scipy.signal.hilbert(data, axis=0))[s:e]
    want = np.angle(np.asarray(rbf_ops.rbf_interpolate(
        jnp.asarray(coords), jnp.asarray(np.exp(1j * phi)), mesh.points)))
    np.testing.assert_allclose(pha, want, rtol=1e-7, atol=1e-9)
