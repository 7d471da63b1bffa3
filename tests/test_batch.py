"""Batch driver over a synthetic two-subject results tree.

The tree mirrors the reference's results layout
(<root>/<subject>/run-*/<trial>/, S2_interpolate.py:79-102); the tests cover
discovery, full runs, resume-by-artifact-presence, deterministic host
sharding, per-trial failure isolation, and the jax.distributed-derived shard.
"""

import json

import numpy as np
import pytest

from manifold_flow_tpu.geometry import synthetic
from manifold_flow_tpu.pipeline import batch
from manifold_flow_tpu.pipeline.config import PipelineConfig
from manifold_flow_tpu.utils import io


def _write_trial(trial_dir, mesh, phases=False, n_frames=5, seed=0):
    trial_dir.mkdir(parents=True, exist_ok=True)
    pot, times, _ = synthetic.two_source_movie(
        mesh, sources=((2.0, 2.0), (6.0, 6.0)), n_frames=n_frames)
    io.save_indexed_csv(
        trial_dir / "sub_task-interpolation_data.csv", np.asarray(pot))
    if phases:
        rng = np.random.default_rng(seed)
        io.save_indexed_csv(
            trial_dir / "sub_task-interpolation_phases_data.csv",
            rng.uniform(-np.pi, np.pi, size=np.asarray(pot).shape))
    return times


@pytest.fixture(scope="module")
def results_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("results")
    meshes = {}
    for subject, trials in (("sub-01", [("run-001", "E1-E2"),
                                        ("run-001", "E3-E4")]),
                            ("sub-02", [("run-002", "F1-F2")])):
        mesh = synthetic.plane_patch(
            nx=12, ny=12, lx=8.0, ly=8.0,
            height=lambda x, y: 0.3 * np.sin(x) * np.cos(y))
        meshes[subject] = mesh
        subj_dir = root / subject
        subj_dir.mkdir()
        io.write_ply(subj_dir / f"{subject}_reconstructed_surface.ply",
                     np.asarray(mesh.points), np.asarray(mesh.triangles))
        for i, (run, trial) in enumerate(trials):
            _write_trial(root / subject / run / trial, mesh,
                         phases=(subject == "sub-01" and i == 0), seed=i)
        # BIDS sidecar at the subject level provides SamplingFrequency
        # (the reference reads it per run, S5_compute_wave_v.py:301-305).
        (subj_dir / f"{subject}_ieeg.json").write_text(
            json.dumps({"SamplingFrequency": 512}))
    return root, meshes


def test_discover_and_shard(results_tree):
    root, _ = results_tree
    trials = batch.discover_trials(root)
    assert [t.key for t in trials] == [
        "sub-01/run-001/E1-E2", "sub-01/run-001/E3-E4",
        "sub-02/run-002/F1-F2"]
    assert trials[0].phases_path is not None
    assert trials[1].phases_path is None
    # Round-robin shards are disjoint and cover everything.
    s0 = batch.shard_trials(trials, 2, 0)
    s1 = batch.shard_trials(trials, 2, 1)
    assert {t.key for t in s0} | {t.key for t in s1} == {
        t.key for t in trials}
    assert not {t.key for t in s0} & {t.key for t in s1}
    with pytest.raises(ValueError):
        batch.shard_trials(trials, 2, 2)
    # Subject filter.
    only = batch.discover_trials(root, subjects=["sub-02"])
    assert [t.key for t in only] == ["sub-02/run-002/F1-F2"]


def test_run_batch_full_then_resume(results_tree):
    root, _ = results_tree
    cfg = PipelineConfig()
    report = batch.run_batch(root, cfg)
    assert report["errors"] == {}
    assert report["discovered"] == 3
    assert set(report["trials"]) == {
        "sub-01/run-001/E1-E2", "sub-01/run-001/E3-E4",
        "sub-02/run-002/F1-F2"}
    t1 = report["trials"]["sub-01/run-001/E1-E2"]
    assert t1 == {s: "done" for s in batch.DEVICE_STAGES}
    # No phases movie -> wavespeed skipped for the second trial.
    assert report["trials"]["sub-01/run-001/E3-E4"]["wavespeed"] == "skipped"
    assert report["trials"]["sub-01/run-001/E3-E4"]["winding"] == "done"
    # Artifacts landed in the reference's formats AND names: every per-trial
    # file carries the movie's stem prefix (here 'sub_task'), streamlines are
    # per-frame files (S6:258-262), and e is per subject (S3:46).
    tdir = root / "sub-01/run-001/E1-E2"
    for name in ("sub_task-V_k.csv", "sub_task-singularity_points.pkl",
                 "sub_task-wave_velocity_opticalflow.pkl.bz2", "data_01.npz",
                 "sub_task-wave_velocity.pkl.bz2",
                 "sub_task-winding_lines.pkl.bz2"):
        assert (tdir / name).exists(), name
    # 5 movie frames -> 4 velocity frames -> 4 per-frame streamline files.
    sl = sorted(tdir.glob("t_velocityfields_streamlines_*.pkl.bz2"))
    assert [p.name for p in sl] == [
        f"t_velocityfields_streamlines_{k}.pkl.bz2" for k in range(4)]
    # Each holds a single-frame dict keyed by the frame index (S6 format).
    assert list(io.load_pickle(sl[2])) == ["2"]
    assert (root / "sub-01" / "sub-01_e.csv").exists()

    # Resume: a second sweep skips every stage of every trial.
    report2 = batch.run_batch(root, cfg)
    assert report2["errors"] == {}
    for key, st in report2["trials"].items():
        assert set(st.values()) == {"skipped"}, (key, st)


def test_interpolate_batch_stage(tmp_path):
    """S2 as a batch stage: a trial holding an evoked +
    BIDS TSVs but no interpolated movie gets one — stim pair G1-G2 parsed
    from the trial name and excluded, the reference's channel predicate
    applied, artifact named `{stem}-ave-interpolation_data.csv` (S2:157)
    plus the phases movie — and the device stages then flow from it, all
    through ONE run_batch call. A second sweep skips the interpolation."""
    root = tmp_path / "results"
    subj = root / "sub-01"
    trial_dir = subj / "run-001" / "G1-G2"
    trial_dir.mkdir(parents=True)
    mesh = synthetic.plane_patch(
        nx=12, ny=12, lx=8.0, ly=8.0,
        height=lambda x, y: 0.3 * np.sin(x) * np.cos(y))
    io.write_ply(subj / "sub-01_reconstructed_surface.ply",
                 np.asarray(mesh.points), np.asarray(mesh.triangles))
    (subj / "sub-01_ieeg.json").write_text(
        json.dumps({"SamplingFrequency": 16}))

    # 8 grid electrodes on mesh vertices + one bad channel + one n/a row.
    pts = np.asarray(mesh.points)
    sel = np.linspace(0, mesh.n_vertices - 1, 9).astype(int)
    names = [f"G{i + 1}" for i in range(8)] + ["B1"]
    lines = ["name\tx\ty\tz\tgroup"]
    for n, vid in zip(names, sel):
        lines.append(f"{n}\t{pts[vid, 0]}\t{pts[vid, 1]}\t{pts[vid, 2]}"
                     "\tgrid")
    lines.append("G9\tn/a\tn/a\tn/a\tgrid")
    (subj / "sub-01_electrodes.tsv").write_text("\n".join(lines) + "\n")
    ch = ["name\ttype\tstatus\tstatus_description\tgroup"]
    for n in names[:8]:
        ch.append(f"{n}\tECOG\tgood\tincluded\tgrid")
    ch.append("B1\tECOG\tbad\texcluded\tgrid")
    (subj / "sub-01_run-001_channels.tsv").write_text("\n".join(ch) + "\n")

    # Portable evoked: 16 samples x 9 channels (stim pair included, as the
    # recording would have it).
    t = np.linspace(0.0, 1.0, 16)
    rng = np.random.default_rng(0)
    data = np.sin(2 * np.pi * 3 * t)[:, None] + 0.1 * rng.normal(
        size=(16, 9))
    stem = "sub-01_ses-1_task-SPESclin_run-001-G1-G2"
    io.save_evoked_csv(trial_dir / f"{stem}-ave.csv", data, names)

    cfg = PipelineConfig()
    cfg.interpolation.start_time = 0.25
    cfg.interpolation.end_time = 0.75
    cfg.analysis.min_streamline_length = 3
    report = batch.run_batch(root, cfg, stages=("interpolate", "flow"))
    assert report["errors"] == {}
    interp = report["interpolation"]["sub-01/run-001/G1-G2"]
    assert interp["status"] == "done"
    assert interp["excluded"] == ["G1", "G2"]
    assert interp["n_electrodes"] == 6  # 8 grid-good minus the stim pair
    art = trial_dir / f"{stem}-ave-interpolation_data.csv"
    assert interp["artifact"] == str(art) and art.exists()
    art_ph = trial_dir / f"{stem}-ave-interpolation_phases_data.csv"
    assert art_ph.exists()
    movie = io.load_indexed_csv(art)
    # Windowed to [0.25, 0.75) s at 16 Hz -> 8 frames, over all vertices.
    assert movie.shape == (8, mesh.n_vertices)
    # The movie equals a direct interpolation from the 6 non-stim
    # electrodes (coordinates in TSV order) on the PLY-loaded surface
    # (write_ply stores f32 points, so the on-disk mesh is the reference).
    from manifold_flow_tpu.pipeline import stages as S

    mesh_disk = S.load_surface(subj / "sub-01_reconstructed_surface.ply")
    want = S.interpolate_stage(
        mesh_disk, pts[sel[2:8]], data[4:12, 2:8], cfg)
    np.testing.assert_allclose(movie, want, rtol=1e-10, atol=1e-12)
    # Flow ran off the fresh movie.
    assert report["trials"]["sub-01/run-001/G1-G2"]["flow"] == "done"

    report2 = batch.run_batch(root, cfg, stages=("interpolate", "flow"))
    assert report2["interpolation"]["sub-01/run-001/G1-G2"][
        "status"] == "skipped"
    assert report2["trials"]["sub-01/run-001/G1-G2"]["flow"] == "skipped"


def _write_interp_inputs(root, trial_names, nx=10):
    """Subject tree with evoked-only trials (no movies yet) + TSVs."""
    subj = root / "sub-01"
    mesh = synthetic.plane_patch(
        nx=nx, ny=nx, lx=8.0, ly=8.0,
        height=lambda x, y: 0.3 * np.sin(x) * np.cos(y))
    subj.mkdir(parents=True, exist_ok=True)
    io.write_ply(subj / "sub-01_reconstructed_surface.ply",
                 np.asarray(mesh.points), np.asarray(mesh.triangles))
    (subj / "sub-01_ieeg.json").write_text(
        json.dumps({"SamplingFrequency": 16}))
    pts = np.asarray(mesh.points)
    sel = np.linspace(0, mesh.n_vertices - 1, 6).astype(int)
    names = [f"G{i + 1}" for i in range(6)]
    lines = ["name\tx\ty\tz\tgroup"] + [
        f"{n}\t{pts[v, 0]}\t{pts[v, 1]}\t{pts[v, 2]}\tgrid"
        for n, v in zip(names, sel)]
    (subj / "sub-01_electrodes.tsv").write_text("\n".join(lines) + "\n")
    ch = ["name\ttype\tstatus\tstatus_description\tgroup"] + [
        f"{n}\tECOG\tgood\tincluded\tgrid" for n in names]
    (subj / "sub-01_run-001_channels.tsv").write_text("\n".join(ch) + "\n")
    rng = np.random.default_rng(1)
    t = np.linspace(0.0, 1.0, 16)
    for trial in trial_names:
        td = subj / "run-001" / trial
        td.mkdir(parents=True, exist_ok=True)
        data = (np.sin(2 * np.pi * 3 * t)[:, None]
                + 0.1 * rng.normal(size=(16, 6)))
        io.save_evoked_csv(
            td / f"sub-01_ses-1_task-SPESclin_run-001-{trial}-ave.csv",
            data, names)
    return mesh


def test_interpolate_sharded_trial_list_consistent(tmp_path):
    """With sharded interpolation, every shard must agree on the post-S2
    trial list even while other shards' movies don't exist yet: the merged
    (discovered + expected-from-tasks) list keeps index-based assignment
    consistent, so no trial is silently orphaned."""
    root = tmp_path / "results"
    _write_interp_inputs(root, ["G1-G2", "G3-G4"])
    cfg = PipelineConfig()
    cfg.interpolation.start_time = 0.0
    cfg.interpolation.end_time = 1.0
    # Shard 0 interpolates task 0 only; trial G3-G4's movie does NOT exist
    # at its discovery time — it must still be counted and assigned.
    r0 = batch.run_batch(root, cfg, stages=("interpolate", "flow"),
                         num_shards=2, shard_index=0)
    assert r0["discovered"] == 2
    assert list(r0["interpolation"]) == ["sub-01/run-001/G1-G2"]
    assert list(r0["trials"]) == ["sub-01/run-001/G1-G2"]
    assert r0["errors"] == {}
    r1 = batch.run_batch(root, cfg, stages=("interpolate", "flow"),
                         num_shards=2, shard_index=1)
    assert list(r1["interpolation"]) == ["sub-01/run-001/G3-G4"]
    assert list(r1["trials"]) == ["sub-01/run-001/G3-G4"]
    assert r1["errors"] == {}
    for trial in ("G1-G2", "G3-G4"):
        td = root / "sub-01" / "run-001" / trial
        assert (td / f"sub-01_ses-1_task-SPESclin_run-001-{trial}"
                "-V_k.csv").exists()


def test_run_trial_records_timings(results_tree):
    """run_trial fills the caller's timings dict directly (one wall per
    executed stage + a flow sub-breakdown) — the bench consumes this
    instead of scraping log lines."""
    root, _ = results_tree
    cfg = PipelineConfig()
    trial = batch.discover_trials(root)[0]
    timings: dict = {}
    res = batch.run_trial(trial, cfg, overwrite=True, timings=timings)
    assert all(v == "done" for v in res.values())
    for s in batch.DEVICE_STAGES:
        assert timings[s] >= 0.0, s
    detail = timings["flow_detail"]
    for k in ("movie_load", "dispatch", "artifact_starts", "solve_wait",
              "artifact_submits", "detect"):
        assert detail[k] >= 0.0, k
    # Skipped stages record nothing.
    t2: dict = {}
    res2 = batch.run_trial(trial, cfg, timings=t2)
    assert all(v == "skipped" for v in res2.values())
    assert t2 == {}


def test_run_batch_sharded_and_stage_subset(results_tree, tmp_path):
    root, _ = results_tree
    cfg = PipelineConfig()
    # Shard 1 of 2 owns exactly the middle trial (round-robin).
    report = batch.run_batch(root, cfg, stages=("flow",), num_shards=2,
                             shard_index=1)
    assert list(report["trials"]) == ["sub-01/run-001/E3-E4"]
    assert report["shard"] == [1, 2]


def test_downstream_stage_resumes_from_artifacts(results_tree):
    """streamline/winding on a trial whose flow artifacts exist on disk but
    not in memory (fresh process resume)."""
    root, _ = results_tree
    cfg = PipelineConfig()
    trials = batch.discover_trials(root)
    res = batch.run_trial(trials[2], cfg, stages=("streamline", "winding"),
                          overwrite=True)
    assert res == {"streamline": "done", "winding": "done"}


def _reference_style_tree(tmp_path, n_frames=5, phases=True):
    """One trial named exactly like the reference's S2 output."""
    mesh = synthetic.plane_patch(
        nx=12, ny=12, lx=8.0, ly=8.0,
        height=lambda x, y: 0.3 * np.sin(x) * np.cos(y))
    root = tmp_path / "results"
    subj = root / "sub-01"
    subj.mkdir(parents=True)
    io.write_ply(subj / "sub-01_reconstructed_surface.ply",
                 np.asarray(mesh.points), np.asarray(mesh.triangles))
    stem = "sub-01_ses-1_task-SPESclin_run-021-E1-E2"
    tdir = subj / "run-021" / "E1-E2"
    tdir.mkdir(parents=True)
    pot, _, _ = synthetic.two_source_movie(
        mesh, sources=((2.0, 2.0), (6.0, 6.0)), n_frames=n_frames)
    io.save_indexed_csv(tdir / f"{stem}-ave-interpolation_data.csv",
                        np.asarray(pot))
    if phases:
        rng = np.random.default_rng(0)
        io.save_indexed_csv(
            tdir / f"{stem}-ave-interpolation_phases_data.csv",
            rng.uniform(-np.pi, np.pi, size=np.asarray(pot).shape))
    (subj / "sub-01_ieeg.json").write_text(
        json.dumps({"SamplingFrequency": 512}))
    return root, tdir, stem


@pytest.mark.parametrize("quirks", [False, True])
def test_reference_artifact_layout_parity(tmp_path, quirks):
    """run_trial on a reference-named tree leaves
    EXACTLY the file set a reference consumer would glob (S3:44-53,
    S5:316-318, S6:258-262, S7:259-261, S4_...ConcatMatrices .py:166), in
    both quirk modes."""
    root, tdir, stem = _reference_style_tree(tmp_path, n_frames=5)
    cfg = PipelineConfig()
    cfg.reference_quirks = quirks
    trials = batch.discover_trials(root)
    assert len(trials) == 1 and batch.trial_prefix(trials[0]) == stem
    report = batch.run_trial(
        trials[0], cfg, stages=batch.ALL_STAGES)
    assert report == {s: "done" for s in batch.ALL_STAGES}
    produced = {p.name for p in tdir.iterdir()}
    inputs = {f"{stem}-ave-interpolation_data.csv",
              f"{stem}-ave-interpolation_phases_data.csv"}
    want = {
        f"{stem}-V_k.csv",
        f"{stem}-singularity_points.pkl",
        f"{stem}-wave_velocity_opticalflow.pkl.bz2",
        f"{stem}-wave_velocity.pkl.bz2",
        f"{stem}-wave_velocity_amplitude.pkl.bz2",
        f"{stem}-winding_lines.pkl.bz2",
        "data_01.npz",
    } | {f"t_velocityfields_streamlines_{k}.pkl.bz2" for k in range(4)}
    assert produced - inputs == want
    assert (root / "sub-01" / "sub-01_e.csv").exists()
    # The wave-speed artifacts load as (T, N) arrays (S5's format).
    ws = io.load_pickle(tdir / f"{stem}-wave_velocity.pkl.bz2")
    assert ws.shape == (5, 144)
    wsa = io.load_pickle(tdir / f"{stem}-wave_velocity_amplitude.pkl.bz2")
    assert wsa.shape == (5, 144)
    assert np.all(np.isfinite(wsa))


def test_pad_meshes_shares_compiled_programs(tmp_path):
    """two subjects with different vertex counts
    in the same shape bucket share one padded shape, so the second trial
    hits the jit caches (no retrace of solve or analysis programs), and
    artifacts equal the unpadded run's. The valid counts ride along as data
    leaves (not static fields), so they cannot key the cache."""
    from manifold_flow_tpu.ops import singularity as sing_ops
    from manifold_flow_tpu.ops import streamline as stream_ops
    from manifold_flow_tpu.ops import winding as wind_ops
    from manifold_flow_tpu.solve import cg as cg_mod

    def make_tree(root, specs):
        for subject, nx in specs:
            mesh = synthetic.plane_patch(
                nx=nx, ny=nx, lx=8.0, ly=8.0,
                height=lambda x, y: 0.3 * np.sin(x) * np.cos(y))
            subj = root / subject
            subj.mkdir(parents=True)
            io.write_ply(subj / f"{subject}_reconstructed_surface.ply",
                         np.asarray(mesh.points), np.asarray(mesh.triangles))
            _write_trial(subj / "run-001" / "T1", mesh)
            (subj / f"{subject}_ieeg.json").write_text(
                json.dumps({"SamplingFrequency": 512}))

    # 169 vs 196 vertices / 288 vs 338 triangles: different sizes, same
    # shape bucket (256 vertices, 512 triangles).
    specs = [("sub-a", 13), ("sub-b", 14)]
    root_pad = tmp_path / "padded"
    root_raw = tmp_path / "unpadded"
    make_tree(root_pad, specs)
    make_tree(root_raw, specs)

    cfg = PipelineConfig()
    assert cfg.pad_meshes
    trials = batch.discover_trials(root_pad)
    assert len(trials) == 2

    jits = [cg_mod.solve_cg, sing_ops.detect, sing_ops.classify_detected,
            stream_ops.trace_frames, wind_ops.analyze_singularities]
    jits = [f for f in jits if hasattr(f, "_cache_size")]
    batch.run_trial(trials[0], cfg, stages=batch.DEVICE_STAGES)
    sizes = [f._cache_size() for f in jits]
    batch.run_trial(trials[1], cfg, stages=batch.DEVICE_STAGES)
    sizes2 = [f._cache_size() for f in jits]
    assert sizes2 == sizes, (
        "second subject retraced despite shape bucketing: "
        f"{[(getattr(f, '__name__', f), a, b) for f, a, b in zip(jits, sizes, sizes2)]}")

    # Padded artifacts equal the unpadded run's, in unpadded shapes.
    cfg_raw = PipelineConfig()
    cfg_raw.pad_meshes = False
    for t in batch.discover_trials(root_raw):
        batch.run_trial(t, cfg_raw, stages=batch.DEVICE_STAGES)
    for subject, nx in specs:
        tp = root_pad / subject / "run-001" / "T1"
        tr = root_raw / subject / "run-001" / "T1"
        n = nx * nx
        vk_p = io.load_indexed_csv(tp / "sub_task-V_k.csv")
        vk_r = io.load_indexed_csv(tr / "sub_task-V_k.csv")
        assert vk_p.shape == (4, 2 * n)
        np.testing.assert_allclose(vk_p, vk_r, rtol=1e-7, atol=1e-9)
        sp = io.load_pickle(tp / "sub_task-singularity_points.pkl")
        sr = io.load_pickle(tr / "sub_task-singularity_points.pkl")
        assert len(sp) == len(sr)
        for a, b in zip(sp, sr):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-8)
        wp = io.load_pickle(tp / "sub_task-wave_velocity_opticalflow.pkl.bz2")
        wr = io.load_pickle(tr / "sub_task-wave_velocity_opticalflow.pkl.bz2")
        assert wp.shape == (4, n)
        np.testing.assert_allclose(wp, wr, rtol=1e-7, atol=1e-9)
        ep = io.load_e_csv(root_pad / subject / f"{subject}_e.csv")
        er = io.load_e_csv(root_raw / subject / f"{subject}_e.csv")
        np.testing.assert_allclose(ep, er, rtol=1e-12)


def test_streamline_artifacts_single_frame_movie(tmp_path):
    """A <= 1-frame movie yields zero velocity frames, hence zero per-frame
    streamline files: the stage must count as trivially done (empty artifact
    list), not wait forever on streamlines_0 and crash on resume."""
    trial_dir = tmp_path / "sub-01" / "run-001" / "T1"
    trial_dir.mkdir(parents=True)
    io.save_indexed_csv(trial_dir / "one-interpolation_data.csv",
                        np.zeros((1, 9)))
    trial = batch.TrialRef(
        subject="sub-01", run="run-001", trial="T1", trial_dir=trial_dir,
        surface_path=trial_dir / "unused.ply",
        movie_path=trial_dir / "one-interpolation_data.csv",
        phases_path=None)
    assert batch.stage_artifacts(trial, "streamline") == []
    assert batch.stage_done(trial, "streamline")


def test_movie_frames_cached_by_stat(results_tree):
    root, _ = results_tree
    trials = batch.discover_trials(root)
    batch._FRAMES_CACHE.clear()
    n1 = batch._movie_frames(trials[0])
    assert len(batch._FRAMES_CACHE) == 1
    assert batch._movie_frames(trials[0]) == n1
    assert len(batch._FRAMES_CACHE) == 1  # second call hit the cache


def test_unit_dt_fallback_warns(tmp_path, caplog):
    """Missing SamplingFrequency must warn (naming the trial) before times
    silently degrade to frame indices."""
    import logging

    root, tdir, stem = _reference_style_tree(tmp_path, phases=False)
    (root / "sub-01" / "sub-01_ieeg.json").unlink()
    trials = batch.discover_trials(root)
    with caplog.at_level(logging.WARNING, logger="manifold_flow_tpu"):
        batch.run_trial(trials[0], PipelineConfig(), stages=("flow",))
    msgs = [r.getMessage() for r in caplog.records]
    assert any("SamplingFrequency" in m and trials[0].key in m
               for m in msgs), msgs


def test_per_trial_isolation(tmp_path):
    """A corrupt trial is recorded in errors; the sweep continues."""
    mesh = synthetic.plane_patch(nx=10, ny=10, lx=6.0, ly=6.0)
    root = tmp_path / "results"
    subj = root / "sub-03"
    subj.mkdir(parents=True)
    io.write_ply(subj / "sub-03_reconstructed_surface.ply",
                 np.asarray(mesh.points), np.asarray(mesh.triangles))
    _write_trial(subj / "run-001" / "good", mesh)
    bad = subj / "run-001" / "bad"
    bad.mkdir(parents=True)
    (bad / "x-interpolation_data.csv").write_text("not,a,movie\n1,2,oops\n")
    report = batch.run_batch(root, PipelineConfig(), stages=("flow",))
    assert list(report["errors"]) == ["sub-03/run-001/bad"]
    assert report["trials"]["sub-03/run-001/good"]["flow"] == "done"


def test_distributed_shard_derivation(results_tree):
    """distributed=True derives the shard from jax.distributed; exercised
    single-process (process_count == 1 owns every trial). Runs in a
    subprocess because jax.distributed.initialize must precede any backend
    initialization."""
    import os
    import subprocess
    import sys
    import textwrap

    root, _ = results_tree
    script = textwrap.dedent(f"""
        import socket
        from manifold_flow_tpu.parallel import multihost
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        multihost.initialize(coordinator_address=f"127.0.0.1:{{port}}",
                             num_processes=1, process_id=0)
        import jax
        jax.config.update("jax_platforms", "cpu")
        from manifold_flow_tpu.pipeline import batch
        from manifold_flow_tpu.pipeline.config import PipelineConfig
        report = batch.run_batch({str(root)!r}, PipelineConfig(),
                                 stages=("flow",), distributed=True)
        assert report["shard"] == [0, 1], report["shard"]
        assert len(report["trials"]) == 3, report
        assert multihost.is_primary()
        multihost.sync_hosts()
        print("DISTRIBUTED_OK")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DISTRIBUTED_OK" in out.stdout


# ------------------------------------------------------ background writer ----
def test_artifact_writer_matches_sync_bytes(tmp_path):
    """Writes routed through the background writer produce byte-identical
    artifacts to synchronous ones, in submission order."""
    import numpy as np

    from manifold_flow_tpu.utils import io

    data = np.arange(12.0).reshape(3, 4)
    obj = {"0": [np.ones(3), "x"]}
    io.save_indexed_csv(tmp_path / "sync.csv", data)
    io.save_pickle(tmp_path / "sync.pkl.bz2", obj)
    with io.ArtifactWriter() as w:
        io.submit_write(w, io.save_indexed_csv, tmp_path / "bg.csv", data)
        io.submit_write(w, io.save_pickle, tmp_path / "bg.pkl.bz2", obj)
    assert (tmp_path / "bg.csv").read_bytes() == \
        (tmp_path / "sync.csv").read_bytes()
    got = io.load_pickle(tmp_path / "bg.pkl.bz2")
    assert list(got) == ["0"] and got["0"][1] == "x"
    np.testing.assert_array_equal(got["0"][0], obj["0"][0])


def test_artifact_writer_raises_on_failed_write(tmp_path):
    """A failed background write surfaces on wait()/exit instead of being
    swallowed; independent LATER jobs still execute (a sweep-shared writer
    queues later trials' artifacts — skipping them would silently lose
    files for trials that report 'done')."""
    import pytest

    from manifold_flow_tpu.utils import io

    def boom(path):
        raise OSError("disk full")

    w = io.ArtifactWriter()
    w.submit(boom, tmp_path / "a")
    w.submit(io.save_pickle, tmp_path / "later.pkl", {"k": 1})
    with pytest.raises(OSError, match="disk full"):
        w.wait()
    assert io.load_pickle(tmp_path / "later.pkl") == {"k": 1}
    w.close()


def test_submit_write_sync_when_no_writer(tmp_path):
    from manifold_flow_tpu.utils import io

    io.submit_write(None, io.save_pickle, tmp_path / "d" / "x.pkl", [1, 2])
    assert io.load_pickle(tmp_path / "d" / "x.pkl") == [1, 2]


def test_winding_in_memory_handoff_matches_disk(tmp_path):
    """The winding stage fed this run's in-memory singularity points (the
    pickle may still be queued on the background writer) produces the same
    artifact as a resumed run that reads the pickle from disk."""
    mesh = synthetic.plane_patch(
        nx=12, ny=12, lx=8.0, ly=8.0,
        height=lambda x, y: 0.3 * np.sin(x) * np.cos(y))
    roots = []
    for name in ("same-run", "resumed"):
        root = tmp_path / name
        subj = root / "sub-01"
        subj.mkdir(parents=True)
        io.write_ply(subj / "sub-01_reconstructed_surface.ply",
                     np.asarray(mesh.points), np.asarray(mesh.triangles))
        (subj / "sub-01_ieeg.json").write_text(
            json.dumps({"SamplingFrequency": 512}))
        _write_trial(subj / "run-001" / "T1", mesh)
        roots.append(root)
    cfg = PipelineConfig()
    t0 = batch.discover_trials(roots[0])[0]
    batch.run_trial(t0, cfg, stages=("flow", "winding"))
    t1 = batch.discover_trials(roots[1])[0]
    batch.run_trial(t1, cfg, stages=("flow",))
    batch.run_trial(t1, cfg, stages=("winding",))  # resumes points from disk
    name = batch.artifact_names(batch.trial_prefix(t0))["winding"]
    a = io.load_pickle(t0.trial_dir / name)
    b = io.load_pickle(t1.trial_dir / name)
    assert list(a) == list(b)
    for k in a:
        assert len(a[k]) == len(b[k])
        for ra, rb in zip(a[k], b[k]):
            np.testing.assert_array_equal(ra[0], rb[0])
            assert ra[1:] == rb[1:]


def test_evoked_csv_roundtrip(tmp_path):
    """Portable evoked CSV (the MNE-free twin the preprocessing stage
    writes): exact data roundtrip, channel names preserved in order."""
    rng = np.random.default_rng(2)
    data = rng.normal(size=(7, 4))
    names = ["G1", "G2", "LT3", "B1"]
    p = tmp_path / "x-ave.csv"
    io.save_evoked_csv(p, data, names)
    back, names2 = io.load_evoked_csv(p)
    assert names2 == names
    np.testing.assert_array_equal(back, data)
    with pytest.raises(ValueError):
        io.save_evoked_csv(p, data, names[:3])


def test_interpolation_fif_without_mne_errors_clearly(tmp_path):
    """A .fif-only evoked (no portable CSV) needs MNE; in this MNE-free
    image run_interpolation must surface the ImportError through the batch
    report instead of crashing the sweep."""
    root = tmp_path / "results"
    _write_interp_inputs(root, ["G1-G2"])
    td = root / "sub-01" / "run-001" / "G1-G2"
    csvp = next(td.glob("*-ave.csv"))
    fifp = td / csvp.name.replace("-ave.csv", "-ave.fif")
    csvp.rename(fifp)  # leave only the .fif form (content irrelevant here)
    cfg = PipelineConfig()
    rep = batch.run_batch(root, cfg, stages=("interpolate",))
    try:
        import mne  # noqa: F401
        # Image unexpectedly has MNE: the bogus .fif must still fail loudly.
        assert rep["errors"], rep
    except ImportError:
        key = "interpolate:sub-01/run-001/G1-G2"
        assert key in rep["errors"], rep
        assert "mne" in rep["errors"][key].lower() or "Module" in \
            rep["errors"][key], rep["errors"][key]


def test_multichip_trial_matches_single_device(tmp_path):
    """run_trial(device_mesh=...) runs the solve + detection + wave speeds +
    winding frames-sharded over the virtual 8-device mesh and must produce
    the same artifact set with matching content: wave speeds exactly (they
    depend only on the phases CSV), V_k to solver tolerance, singularity
    and winding artifacts structurally equal."""
    from manifold_flow_tpu.parallel import make_device_mesh

    root, tdir, stem = _reference_style_tree(tmp_path, n_frames=9)
    trial = batch.discover_trials(root)[0]
    cfg = PipelineConfig()
    res1 = batch.run_trial(trial, cfg)
    assert all(v == "done" for v in res1.values())
    names = batch.artifact_names(batch.trial_prefix(trial))
    single = {
        "v_k": io.load_indexed_csv(tdir / names["v_k"]),
        "sing": io.load_pickle(tdir / names["singularity"]),
        "wave": io.load_pickle(tdir / names["wavespeed"]),
        "wind": io.load_pickle(tdir / names["winding"]),
    }

    dm = make_device_mesh(8, 1)
    res2 = batch.run_trial(trial, cfg, overwrite=True, device_mesh=dm)
    assert all(v == "done" for v in res2.values())
    # Sharded CG reductions associate differently: solutions agree to the
    # solver tolerance scaled by the system's conditioning, not to ulps.
    scale = np.abs(single["v_k"]).max()
    np.testing.assert_allclose(
        io.load_indexed_csv(tdir / names["v_k"]), single["v_k"],
        rtol=2e-3, atol=2e-4 * scale)
    np.testing.assert_allclose(
        np.asarray(io.load_pickle(tdir / names["wavespeed"])),
        np.asarray(single["wave"]), rtol=1e-10, atol=1e-12)
    sing2 = io.load_pickle(tdir / names["singularity"])
    assert len(sing2) == len(single["sing"])
    for a, b in zip(sing2, single["sing"]):
        assert len(a) == len(b)
        if len(a):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-3, atol=1e-4)
    wind2 = io.load_pickle(tdir / names["winding"])
    assert set(wind2) == set(single["wind"])
    for k in wind2:
        assert len(wind2[k]) == len(single["wind"][k])
        for r2, r1 in zip(wind2[k], single["wind"][k]):
            assert (r2[1], r2[2]) == (r1[1], r1[2])  # ring count, type


# ------------------------------------------------------------ BIDS TSVs ----
def test_grid_electrodes_tsv_na_rows_and_group_filter(tmp_path):
    """electrodes.tsv reader: 'n/a' coordinate rows are skipped, the group
    filter keeps only the grid (group=None keeps every group), names and
    exclude select channels, and TSV row order is kept."""
    p = tmp_path / "sub-01_electrodes.tsv"
    p.write_text("name\tx\ty\tz\tsize\tgroup\n"
                 "G1\t1.5\t2\t3\t4.2\tgrid\n"
                 "G2\tn/a\tn/a\tn/a\t4.2\tgrid\n"
                 "S1\t4\t5\t6\tn/a\tstrip\n"
                 "G3\t-7.25\t8\t9e-1\t4.2\tgrid\n")
    coords, names = io.load_grid_electrodes(p, with_names=True)
    assert names == ["G1", "G3"]
    np.testing.assert_array_equal(coords, [[1.5, 2.0, 3.0],
                                           [-7.25, 8.0, 0.9]])
    coords_all, names_all = io.load_grid_electrodes(p, group=None,
                                                    with_names=True)
    assert names_all == ["G1", "S1", "G3"]
    assert coords_all.shape == (3, 3)
    _, sel = io.load_grid_electrodes(p, group=None, names=["G3", "S1"],
                                     exclude=["S1"], with_names=True)
    assert sel == ["G3"]
    assert io.load_grid_electrodes(p, names=[]).shape == (0, 3)


def test_channels_tsv_predicate_with_na_rows(tmp_path):
    """channels.tsv predicate (type ECOG, status good, description
    included, group grid): 'n/a' cells fail it, a 'n/a' name is dropped,
    the stimulated pair is removed in order and reported, and a missing
    predicate column selects nothing."""
    p = tmp_path / "sub-01_run-001_channels.tsv"
    p.write_text("name\ttype\tstatus\tstatus_description\tgroup\n"
                 "G1\tECOG\tgood\tincluded\tgrid\n"
                 "G2\tECOG\tbad\tincluded\tgrid\n"
                 "G3\tECOG\tgood\tn/a\tgrid\n"
                 "n/a\tECOG\tgood\tincluded\tgrid\n"
                 "G5\tECOG\tgood\tincluded\tgrid\n"
                 "G6\tSEEG\tgood\tincluded\tgrid\n"
                 "S1\tECOG\tgood\tincluded\tstrip\n"
                 "G8\tECOG\tgood\tincluded\tgrid\n")
    names, excluded = batch.selected_channel_names(p, ("G5", "X9"))
    assert names == ["G1", "G8"]
    assert excluded == ["G5"]
    q = tmp_path / "no_group_channels.tsv"
    q.write_text("name\ttype\tstatus\tstatus_description\n"
                 "G1\tECOG\tgood\tincluded\n")
    assert batch.selected_channel_names(q) == ([], [])
