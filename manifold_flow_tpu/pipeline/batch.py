"""Batch orchestration over a subjects/runs/trials results tree.

The reference's de-facto cluster layer is argv-sharded loops over a shared
results tree: one Slurm task per subject walks run folders
(S2_interpolate.py:79-102), and one task per (subject, run, trial) runs each
analysis script (S5_compute_wave_v.py:264-300, S7_winding_line.py:205-261).
Resume is implicit: a re-run recreates whatever artifacts are missing.

This module is that layer as a real driver. It discovers trials under the
reference's tree layout

    <root>/<subject>/*reconstructed_surface.ply
    <root>/<subject>/run-<NNN>/<trial>/*interpolation_data.csv
    <root>/<subject>/run-<NNN>/<trial>/*interpolation_phases_data.csv  (opt.)

then, for each trial, runs the device stages S3 (flow + singularities),
S4 (SVD), S5 (wave speeds, when a phases movie exists), S6 (streamlines) and
S7 (winding lines), writing artifacts next to the inputs and SKIPPING any
stage whose artifacts already exist (resume-by-presence, matching the
reference's re-run behavior). Trials are sharded deterministically across
hosts — trial i belongs to shard (i % num_shards) — either from explicit
shard arguments (the reference's argv sharding) or from jax.distributed
process indices (parallel.multihost.initialize). Per-trial isolation: one
failing trial is recorded and the sweep continues (the reference's only
failure mechanism is per-run isolation in S0, S0_preprocess.py:169-172).

S0-S1 (MNE preprocessing, surface reconstruction) are host-side, per-subject
steps with their own CLI subcommands. S2 IS a batch stage ('interpolate'):
trials holding per-site evokeds (+ BIDS TSVs) get their stimulated pair
parsed from the trial name and excluded, the reference's channel predicate
applied, and both potentials and phases movies written — so one command runs
a cohort from S0 outputs to winding lines (discover_interpolation_tasks /
run_interpolation, mirroring S2_interpolate.py:79-160).
"""

from __future__ import annotations

import contextlib
import json
import logging
import re
import time
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np

logger = logging.getLogger(__name__)

# Stage order within a trial: streamline runs right after flow so its ~97
# per-frame pkl.bz2 artifact compressions (the largest write burst) overlap
# the decompose/wavespeed/winding device waits instead of landing in the
# end-of-trial writer drain. Artifact dependencies are
# unaffected: everything after flow needs only the in-memory velocity.
DEVICE_STAGES = ("flow", "streamline", "decompose", "wavespeed", "winding")
# The amplitude wave-speed variant (S5_compute_wave_v.py:14-58) exists in the
# reference but is never wired into its main; it is opt-in here too.
ALL_STAGES = DEVICE_STAGES + ("wavespeed_amplitude",)


class TrialRef(NamedTuple):
    subject: str
    run: str
    trial: str
    trial_dir: Path
    surface_path: Path
    movie_path: Path            # interpolated potentials (T, N) csv
    phases_path: Path | None    # interpolated phases csv, if present

    @property
    def key(self) -> str:
        return f"{self.subject}/{self.run}/{self.trial}"


def _find_surface(subject_dir: Path) -> Path | None:
    hits = sorted(subject_dir.glob("*reconstructed_surface.ply"))
    return hits[0] if hits else None


def discover_trials(root, subjects: Sequence[str] | None = None):
    """Walk the results tree and return every runnable trial, sorted.

    Mirrors the reference's run-folder walk (S2_interpolate.py:79-102):
    subjects are the top-level folders, runs match run-*, and a trial is any
    run subfolder holding an interpolated movie."""
    root = Path(root)
    out = []
    for subject_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        if subjects and subject_dir.name not in subjects:
            continue
        surface = _find_surface(subject_dir)
        if surface is None:
            logger.warning("batch: %s has no reconstructed surface; skipped",
                           subject_dir.name)
            continue
        for run_dir in sorted(subject_dir.glob("run-*")):
            if not run_dir.is_dir():
                continue
            for trial_dir in sorted(p for p in run_dir.iterdir()
                                    if p.is_dir()):
                movies = sorted(trial_dir.glob("*interpolation_data.csv"))
                if not movies:
                    continue
                phases = sorted(
                    trial_dir.glob("*interpolation_phases_data.csv"))
                out.append(TrialRef(
                    subject=subject_dir.name, run=run_dir.name,
                    trial=trial_dir.name, trial_dir=trial_dir,
                    surface_path=surface, movie_path=movies[0],
                    phases_path=phases[0] if phases else None))
    return out


def shard_trials(trials, num_shards: int, shard_index: int):
    """Deterministic round-robin assignment: trial i -> shard i % num_shards
    (the reference's manual one-argv-per-task split, made automatic)."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(
            f"shard_index {shard_index} outside [0, {num_shards})")
    return [t for i, t in enumerate(trials) if i % num_shards == shard_index]


def _find_sfreq_near(trial_dir: Path) -> float | None:
    """Sampling frequency from the nearest BIDS ieeg sidecar JSON — the
    reference reads SamplingFrequency per run (S5_compute_wave_v.py:301-305).
    Searches trial, run, then subject directory."""
    for d in (trial_dir, trial_dir.parent, trial_dir.parent.parent):
        for j in sorted(d.glob("*.json")):
            try:
                info = json.loads(j.read_text())
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(info, dict) and "SamplingFrequency" in info:
                return float(info["SamplingFrequency"])
    return None


def _find_sfreq(trial: TrialRef) -> float | None:
    return _find_sfreq_near(trial.trial_dir)


# ------------------------------------------------------------------- S2 ----
# Stimulated-pair extraction from the trial folder name: the reference's
# pattern2 (S2_interpolate.py:97-102) — 'G1-G2' stimulates G1 and G2, and
# both are removed from the interpolation inputs (S2:125-135).
_STIM_PAIR_PATTERN = re.compile(r"(.*?)-(.*)")


class InterpTask(NamedTuple):
    """One trial awaiting S2 interpolation: an evoked movie plus the BIDS
    sidecars needed to select and place its electrodes."""

    subject: str
    run: str
    trial: str
    trial_dir: Path
    surface_path: Path
    evoked_path: Path             # <stem>-ave.csv (portable) or -ave.fif
    electrodes_path: Path | None  # *_electrodes.tsv
    channels_path: Path | None    # *_channels.tsv (run-matched if present)

    @property
    def key(self) -> str:
        return f"{self.subject}/{self.run}/{self.trial}"


def _find_sidecar(trial_dir: Path, patterns) -> Path | None:
    """First match of any pattern in trial, run, then subject directory —
    the reference reads the TSVs from the per-session ieeg folder
    (S2:112-113); a results-tree copy at any level works here."""
    for d in (trial_dir, trial_dir.parent, trial_dir.parent.parent):
        for pat in patterns:
            hits = sorted(d.glob(pat))
            if hits:
                return hits[0]
    return None


def discover_interpolation_tasks(root, subjects: Sequence[str] | None = None):
    """Every trial with a per-site evoked movie, whether or not the
    interpolated movie exists yet (run_interpolation resumes by presence).

    Mirrors the reference's S2 walk (S2_interpolate.py:79-102): subjects ->
    run-* -> trial folders; the evoked is `<stem>-ave.fif` in the trial
    folder (our preprocessing also writes a portable `<stem>-ave.csv` twin,
    preferred because it needs no MNE)."""
    root = Path(root)
    out = []
    for subject_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        if subjects and subject_dir.name not in subjects:
            continue
        surface = _find_surface(subject_dir)
        if surface is None:
            continue
        for run_dir in sorted(subject_dir.glob("run-*")):
            if not run_dir.is_dir():
                continue
            run_no = run_dir.name[len("run-"):]
            for trial_dir in sorted(p for p in run_dir.iterdir()
                                    if p.is_dir()):
                evoked = (sorted(trial_dir.glob("*-ave.csv"))
                          or sorted(trial_dir.glob("*-ave.fif")))
                if not evoked:
                    continue
                electrodes = _find_sidecar(trial_dir, ["*_electrodes.tsv"])
                channels = _find_sidecar(
                    trial_dir, [f"*_run-{run_no}_channels.tsv",
                                "*_channels.tsv"])
                out.append(InterpTask(
                    subject=subject_dir.name, run=run_dir.name,
                    trial=trial_dir.name, trial_dir=trial_dir,
                    surface_path=surface, evoked_path=evoked[0],
                    electrodes_path=electrodes, channels_path=channels))
    return out


def selected_channel_names(channels_path, stim_pair=()):
    """Grid-ECoG channel names passing the reference's predicate, minus the
    stimulated pair.

    Conditions (S2_interpolate.py:116-123): type == ECOG, status == good,
    status_description == included, group == grid. The stimulated channels
    are then removed in order (S2:125-135). Returns (names, excluded)."""
    from manifold_flow_tpu.utils import io

    want = {"type": "ECOG", "status": "good",
            "status_description": "included", "group": "grid"}
    names = [r["name"] for r in io.read_tsv(channels_path)
             if all(r.get(k) == v for k, v in want.items())
             and r.get("name") is not None]
    excluded = []
    for stim in stim_pair:
        if stim in names:
            names.remove(stim)
            excluded.append(stim)
    return names, excluded


def _read_evoked(path: Path):
    """(data (T, C), ch_names, sfreq | None) from a portable evoked CSV or
    an MNE .fif (S2:106-110; the .fif route needs MNE installed)."""
    from manifold_flow_tpu.utils import io

    if path.suffix == ".csv":
        data, names = io.load_evoked_csv(path)
        return data, names, None
    import mne  # deferred: .fif evokeds only

    evoked = mne.read_evokeds(str(path), 0)
    return evoked.get_data().T, list(evoked.ch_names), float(
        evoked.info["sfreq"])


def interpolation_artifacts(task: InterpTask) -> tuple[Path, Path]:
    """(potentials, phases) movie paths run_interpolation will produce for
    `task` — derivable a priori, so shards can agree on the post-S2 trial
    list before every movie exists (see run_batch)."""
    name = task.evoked_path.name
    for suf in ("-ave.csv", "-ave.fif"):
        if name.endswith(suf):
            stem = name[: -len(suf)]
            break
    else:
        stem = task.evoked_path.stem
    return (task.trial_dir / f"{stem}-ave-interpolation_data.csv",
            task.trial_dir / f"{stem}-ave-interpolation_phases_data.csv")


def run_interpolation(task: InterpTask, config, overwrite: bool = False,
                      mesh_cache: dict | None = None, cache_dir=None) -> dict:
    """S2 for one trial: evoked (T, E) -> interpolated vertex movies
    (potentials AND phases CSVs, the flow/wavespeed stage inputs).

    The stimulated pair is parsed from the trial folder name and excluded
    automatically (S2_interpolate.py:97-102,125-135); channel selection
    applies the reference's TSV predicate (selected_channel_names); the
    movie windows to [start_time, end_time) seconds via the evoked's (or
    sidecar's) sampling frequency (S2:19-20,109-110). Artifacts follow the
    reference's names: `{stem}-ave-interpolation_data.csv` (S2:157) and
    `{stem}-ave-interpolation_phases_data.csv`. Returns a report dict;
    status 'skipped' when both artifacts already exist."""
    from manifold_flow_tpu.pipeline import stages as S
    from manifold_flow_tpu.utils import io

    art, art_ph = interpolation_artifacts(task)
    if not overwrite and art.exists() and art_ph.exists():
        return {"status": "skipped", "artifact": str(art)}

    m = _STIM_PAIR_PATTERN.search(task.trial)
    stim_pair = (m.group(1), m.group(2)) if m else ()
    if task.channels_path is None or task.electrodes_path is None:
        raise FileNotFoundError(
            f"{task.key}: interpolation needs *_channels.tsv and "
            "*_electrodes.tsv near the trial (searched trial, run and "
            "subject directories)")
    names, excluded = selected_channel_names(task.channels_path, stim_pair)

    data, ch_names, sfreq = _read_evoked(task.evoked_path)
    if sfreq is None:
        sfreq = _find_sfreq_near(task.trial_dir)
    if sfreq is None:
        logger.warning(
            "batch: %s: no sampling frequency (evoked metadata or sidecar "
            "JSON); interpolating the FULL evoked without the "
            "[start_time, end_time) window", task.key)

    # Electrode coordinates keep the TSV's row order; the evoked's columns
    # are aligned to that order BY NAME. (The reference builds data in
    # channels.tsv order and coordinates in electrodes.tsv order, silently
    # assuming both agree, S2:138-151 — true for this dataset; matching by
    # name makes it robust.)
    coords, kept = io.load_grid_electrodes(
        task.electrodes_path, group=None, names=names, with_names=True)
    no_coords = sorted(set(names) - set(kept))
    if no_coords:
        # A channel passing the channels.tsv predicate but absent (or
        # 'n/a') in electrodes.tsv silently shrinks the interpolation
        # basis — loud, because a typo'd electrode row would otherwise
        # change every downstream artifact without a trace.
        logger.warning(
            "batch: %s: channels %s have no coordinates in %s; "
            "interpolating from %d of %d selected electrodes",
            task.key, no_coords, task.electrodes_path.name, len(kept),
            len(names))
    missing = [n for n in kept if n not in ch_names]
    if missing:
        raise ValueError(
            f"{task.key}: channels {missing} selected by the TSVs are not "
            "in the evoked recording")
    cols = [ch_names.index(n) for n in kept]
    movie = data[:, cols]

    if mesh_cache is not None and task.surface_path in mesh_cache:
        mesh = mesh_cache[task.surface_path]
    else:
        mesh = S.load_surface(task.surface_path, cache_dir=cache_dir,
                              pad=getattr(config, "pad_meshes", False))
        if mesh_cache is not None:
            mesh_cache[task.surface_path] = mesh
    S.interpolate_stage(mesh, coords, movie, config, sfreq=sfreq,
                        save_path=art)
    S.interpolate_stage(mesh, coords, movie, config, sfreq=sfreq,
                        phases=True, save_path=art_ph)
    return {"status": "done", "artifact": str(art),
            "phases_artifact": str(art_ph), "n_electrodes": len(kept),
            "excluded": excluded}


def trial_prefix(trial: TrialRef) -> str:
    """Per-trial artifact-name stem, recovered from the movie filename.

    The reference derives every artifact name from one stem,
    `{subfolder}_{ses}_task-SPESclin_run-{run}-{trial}` (S3_compute_v_and_
    detection_singularity.py:44-53), and the interpolated movie is
    `{stem}-ave-interpolation_data.csv` (S2_interpolate.py:157) — so the stem
    is the movie filename minus that suffix. Movies that don't follow the
    convention get bare artifact names."""
    name = trial.movie_path.name
    for suf in ("-ave-interpolation_data.csv", "-interpolation_data.csv"):
        if name.endswith(suf):
            return name[: -len(suf)]
    return ""


def artifact_names(prefix: str) -> dict:
    """Reference on-disk artifact names for one trial (§2.2 SURVEY.md):
    prefixed like S3/S5/S7 build them; data_01.npz and the per-frame
    streamline files are unprefixed in the reference too
    (S4_...ConcatMatrices .py:166, S6_streamline.py:260)."""
    p = f"{prefix}-" if prefix else ""
    return {
        "v_k": f"{p}V_k.csv",                                  # S3:47
        "singularity": f"{p}singularity_points.pkl",           # S3:49
        "speed": f"{p}wave_velocity_opticalflow.pkl.bz2",      # S3:53
        "decompose": "data_01.npz",                            # S4:166
        "wavespeed": f"{p}wave_velocity.pkl.bz2",              # S5:316
        "wavespeed_amplitude": f"{p}wave_velocity_amplitude.pkl.bz2",
        "streamline_fmt": "t_velocityfields_streamlines_{frame}.pkl.bz2",
        "winding": f"{p}winding_lines.pkl.bz2",                # S7:259
    }


_FRAMES_CACHE: dict = {}


def _movie_frames(trial: TrialRef, config=None) -> int:
    """Movie frame count (CSV data rows, capped by solver.time_steps) —
    needed to enumerate the per-frame streamline artifacts. Cached by
    (path, mtime, size): stage_done checks run per stage per sweep, and a
    no-op resume over a cohort must not re-read every multi-MB movie CSV
    just to count rows."""
    import os

    st = os.stat(trial.movie_path)
    key = (str(trial.movie_path), st.st_mtime_ns, st.st_size)
    rows = _FRAMES_CACHE.get(key)
    if rows is None:
        with open(trial.movie_path, "r", encoding="utf-8") as f:
            rows = max(sum(1 for _ in f) - 1, 0)  # minus header
        _FRAMES_CACHE[key] = rows
        while len(_FRAMES_CACHE) > 4096:
            _FRAMES_CACHE.pop(next(iter(_FRAMES_CACHE)))
    ts = getattr(getattr(config, "solver", None), "time_steps", None)
    return min(rows, ts) if ts else rows


def stage_artifacts(trial: TrialRef, stage: str, config=None):
    """Paths a stage produces; a stage is 'done' (skippable) when every one
    exists."""
    names = artifact_names(trial_prefix(trial))
    d = trial.trial_dir
    if stage == "flow":
        return [d / names["v_k"], d / names["singularity"],
                d / names["speed"]]
    if stage == "streamline":
        t = _movie_frames(trial, config)
        # t - 1 velocity frames -> t - 1 per-frame files; a <= 1-frame movie
        # produces nothing, so the stage is trivially done (empty list)
        # rather than forever waiting on a file no run can create.
        return [d / names["streamline_fmt"].format(frame=k)
                for k in range(max(t - 1, 0))]
    if stage in ("decompose", "wavespeed", "wavespeed_amplitude", "winding"):
        return [d / names[stage]]
    raise ValueError(f"unknown batch stage {stage!r}")


def stage_done(trial: TrialRef, stage: str, config=None) -> bool:
    return all(a.exists() for a in stage_artifacts(trial, stage, config))


def run_trial(trial: TrialRef, config, stages: Sequence[str] = DEVICE_STAGES,
              sfreq: float | None = None, overwrite: bool = False,
              mesh_cache: dict | None = None, cache_dir=None,
              timings: dict | None = None, movie_data=None,
              writer=None, device_mesh=None) -> dict:
    """Run the requested device stages for one trial; returns
    {stage: 'done' | 'skipped'}. Stage inputs flow in memory; artifacts land
    in the trial directory in the reference's formats.

    `timings`, when given, receives wall seconds per executed stage plus a
    'flow_detail' sub-breakdown (movie CSV load, solve dispatch/wait,
    artifact-fetch starts, detection, solver counters) — the recorded fact
    the bench reports, instead of scraping this module's log lines.

    `movie_data` optionally supplies the trial's potentials movie already
    parsed (an (T, E) array or a concurrent Future of one): run_batch
    prefetches the NEXT trial's CSV while the current trial computes, so
    steady-state cohort sweeps never pay the parse on the critical path
    (trial_flow_detail.movie_load).

    `device_mesh` optionally runs the trial MULTI-DEVICE: the solve
    (sharded_compute_velocity_fields over ('frames', 'mesh')), detection,
    wave speeds, and the winding profile grid all shard their frame axis
    (parallel.analysis); only the streamline tracer stays single-device
    (its adaptive escalation is a data-dependent host loop). Results match
    the single-device trial (solver to tolerance; analysis exactly).

    `writer` optionally supplies a SWEEP-SHARED io.ArtifactWriter: this
    trial's artifact serialization (per-frame bz2 pickles are the bulk of
    it) then overlaps the NEXT
    trial's device compute instead of draining before returning — the
    caller owns the drain, and 'done' means the writes are QUEUED, not
    yet on disk, until the caller's writer.wait(). Without it the trial
    drains its own writer, so 'done' means files are on disk."""
    from manifold_flow_tpu.pipeline import stages as S
    from manifold_flow_tpu.utils import io

    result = {}
    todo = [s for s in stages
            if overwrite or not stage_done(trial, s, config)]
    for s in stages:
        if s not in todo:
            result[s] = "skipped"
    if not todo:
        return result

    if mesh_cache is not None and trial.surface_path in mesh_cache:
        mesh = mesh_cache[trial.surface_path]
    else:
        # pad_meshes (default on) buckets every subject's surface to shared
        # shapes so one compiled program serves the whole cohort; artifacts
        # are written unpadded by the stages.
        mesh = S.load_surface(trial.surface_path, cache_dir=cache_dir,
                              pad=getattr(config, "pad_meshes", False))
        if mesh_cache is not None:
            mesh_cache[trial.surface_path] = mesh
    d = trial.trial_dir
    names = artifact_names(trial_prefix(trial))

    movie = None
    vel = None
    sing_pts = None
    sing_centers = None
    v_world_cache = None
    sfreq_cache = [sfreq, sfreq is not None]

    def get_sfreq():
        """Sampling frequency, warning loudly on the unit-dt fallback: times
        silently becoming frame indices is the same seconds-vs-unit-dt
        ambiguity the reference itself carries between its S3 driver and
        compute_optical_flow's __main__ (SURVEY.md §7.3)."""
        if not sfreq_cache[1]:
            sfreq_cache[0] = _find_sfreq(trial)
            sfreq_cache[1] = True
            if sfreq_cache[0] is None:
                logger.warning(
                    "batch: %s: no SamplingFrequency sidecar JSON found near "
                    "%s; falling back to unit dt (times = frame indices) — "
                    "velocities and wave speeds will be in per-frame, not "
                    "per-second, units", trial.key, trial.trial_dir)
        return sfreq_cache[0]

    def get_movie():
        nonlocal movie
        if movie is None:
            from manifold_flow_tpu.geometry.mesh import pad_vertex_field

            raw = movie_data
            if raw is not None and hasattr(raw, "result"):
                raw = raw.result()  # a prefetch Future from run_batch
            if raw is None:
                raw = io.load_indexed_csv(trial.movie_path)
            movie = np.asarray(raw)
            if (config.solver.time_steps
                    and movie.shape[0] > config.solver.time_steps):
                movie = movie[: config.solver.time_steps]
            movie = pad_vertex_field(mesh, movie)
        return movie

    def get_times(n):
        f = get_sfreq()
        return (np.arange(n) / f if f
                else np.arange(n, dtype=np.float64))

    def get_velocity():
        """v_world for S3-S7 analysis: from this run's flow stage, or
        reloaded (once) from the V_k.csv artifact of a previous (resumed)
        run. Returned as ONE shared device array so the downstream stages
        neither refetch nor re-upload the movie."""
        nonlocal v_world_cache
        if v_world_cache is not None:
            return v_world_cache
        import jax.numpy as jnp

        if vel is not None:
            v = jnp.asarray(vel.v_world)
        elif stage_done(trial, "flow", config) and "flow" not in todo:
            from manifold_flow_tpu.geometry.mesh import pad_dof_field
            from manifold_flow_tpu.ops.recombine import velocity_to_world

            v_k = pad_dof_field(mesh, io.load_indexed_csv(d / names["v_k"]))
            v = jnp.asarray(velocity_to_world(v_k, mesh.basis))
        else:
            raise RuntimeError(
                f"{trial.key}: stage needs velocity fields but 'flow' "
                "neither ran nor left artifacts; include 'flow' in stages")
        v_world_cache = v
        return v_world_cache

    # One background writer per trial: artifact serialization (pandas CSV,
    # bz2 pickles) overlaps the next stage's device program instead of
    # blocking it; the context manager drains it before returning, so a
    # 'done' result means the files are on disk. The phases CSV (wavespeed's
    # input) is prefetched on a second thread for the same reason — both
    # sides are GIL-releasing pandas/bz2 C code riding the accelerator wait.
    with contextlib.ExitStack() as stack:
        phases_future = None
        if ("wavespeed" in todo and todo[0] != "wavespeed"
                and trial.phases_path is not None):
            from concurrent.futures import ThreadPoolExecutor

            pool = stack.enter_context(ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="artifact-prefetch"))
            phases_future = pool.submit(io.load_indexed_csv,
                                        trial.phases_path)
        # Two workers: the per-frame streamline pkl.bz2 set is the largest
        # (GIL-releasing) compression burst; a second thread halves the
        # drain tail after the last device stage. A
        # sweep-shared writer (run_batch) skips the per-trial drain so the
        # tail rides the next trial's device compute instead.
        if writer is None:
            writer = stack.enter_context(io.ArtifactWriter(workers=2))
        for s in todo:
            t0 = time.perf_counter()
            if s == "flow":
                detail: dict = {}
                m = get_movie()
                detail["movie_load"] = time.perf_counter() - t0
                # S3:46 writes e per subject: {subfolder}_e.csv — one file
                # shared by every trial of the subject, so only the first
                # trial that finds it missing (or an overwrite sweep)
                # writes it; writes are atomic (utils.io) so even
                # concurrent same-path submits stay whole.
                e_path = trial.surface_path.parent / f"{trial.subject}_e.csv"
                vel = S.velocity_stage(
                    mesh, m, get_times(m.shape[0]), config,
                    e_path=(e_path if overwrite or not e_path.exists()
                            else None),
                    v_k_path=d / names["v_k"],
                    speed_path=d / names["speed"], writer=writer,
                    timings=detail, device_mesh=device_mesh)
                t_det = time.perf_counter()
                sing_pts, _, sing_centers = S.singularity_stage(
                    mesh, get_velocity(), config,
                    save_path=d / names["singularity"], writer=writer,
                    return_centers=True, device_mesh=device_mesh)
                detail["detect"] = time.perf_counter() - t_det
                if timings is not None:
                    timings["flow_detail"] = detail
            elif s == "decompose":
                if vel is not None:
                    # Device slices: the numpy unpad would fetch the whole
                    # (T, 2N) movie host-ward only for decompose_stage to
                    # re-upload it.
                    from manifold_flow_tpu.geometry.mesh import (
                        unpad_dof_field_device)

                    v_k = unpad_dof_field_device(mesh, vel.v_k)
                else:
                    v_k = io.load_indexed_csv(d / names["v_k"]) if (
                        d / names["v_k"]).exists() else None
                if v_k is None:
                    raise RuntimeError(
                        f"{trial.key}: decompose needs {names['v_k']}")
                S.decompose_stage(v_k, config, mode="concat",
                                  npz_path=d / names["decompose"],
                                  writer=writer)
            elif s in ("wavespeed", "wavespeed_amplitude"):
                if s == "wavespeed":
                    if trial.phases_path is None:
                        result[s] = "skipped"
                        continue
                    m = (phases_future.result() if phases_future is not None
                         else io.load_indexed_csv(trial.phases_path))
                    method = "phase"
                else:
                    m = get_movie()
                    method = "amplitude"
                f = get_sfreq()
                S.wavespeed_stage(mesh, m, dt=1.0 / f if f else 1.0,
                                  method=method, save_path=d / names[s],
                                  writer=writer, device_mesh=device_mesh)
            elif s == "streamline":
                # Per-frame files, the reference's layout (S6:258-262): a
                # consumer globbing t_velocityfields_streamlines_<k>.pkl.bz2
                # finds one dict {frame: lines} per frame.
                sdetail: dict = {}
                S.streamline_stage(
                    mesh, get_velocity(), config,
                    save_path_fmt=str(d / names["streamline_fmt"]),
                    writer=writer, timings=sdetail)
                if timings is not None:
                    timings["streamline_detail"] = sdetail
            elif s == "winding":
                # This run's detection pass hands its points (and snapped
                # centers) over in memory (the pickle may still be queued on
                # the writer); a resumed run reads the artifact of the
                # previous one and re-snaps on the host.
                pts = ([list(p) for p in sing_pts]
                       if sing_pts is not None
                       else io.load_pickle(d / names["singularity"]))
                S.winding_stage(mesh, get_velocity(), pts, config,
                                save_path=d / names["winding"],
                                writer=writer, centers=sing_centers,
                                device_mesh=device_mesh)
            else:
                raise ValueError(f"unknown batch stage {s!r}")
            result[s] = "done"
            wall = time.perf_counter() - t0
            if timings is not None:
                timings[s] = wall
            logger.info("batch: %s %s done in %.2fs", trial.key, s, wall)
    return result


def run_batch(root, config, stages: Sequence[str] = DEVICE_STAGES,
              subjects: Sequence[str] | None = None,
              sfreq: float | None = None, overwrite: bool = False,
              num_shards: int | None = None, shard_index: int | None = None,
              distributed: bool = False, cache_dir=None,
              mesh_cache: dict | None = None, device_mesh=None) -> dict:
    """Run `stages` for every trial under `root` owned by this shard.

    distributed=True wires jax.distributed (parallel.multihost) and derives
    the shard from jax.process_index()/process_count(); explicit
    num_shards/shard_index reproduce the reference's manual argv sharding.
    Returns {"trials": {key: {stage: status}}, "errors": {key: message},
    "shard": [index, count]}.

    `mesh_cache` optionally persists loaded TriMesh objects ACROSS calls:
    the per-mesh compiled-program caches (fused flow, boundary tables,
    coarse tables) key on mesh identity, so a caller sweeping repeatedly
    should pass one dict to avoid re-tracing per call.
    """
    if distributed:
        from manifold_flow_tpu.parallel import multihost
        import jax

        multihost.initialize()
        num_shards = jax.process_count()
        shard_index = jax.process_index()
    num_shards = num_shards or 1
    shard_index = shard_index or 0

    report = {"trials": {}, "errors": {},
              "shard": [shard_index, num_shards]}
    if mesh_cache is None:
        mesh_cache = {}
    stages = tuple(stages)
    tasks = []
    if "interpolate" in stages:
        # S2 first: produce the interpolated movies the device stages
        # consume, sharded like trials (same round-robin over the sorted
        # task list). One command then flows a cohort from S0 outputs
        # (evokeds + TSVs) to winding lines.
        tasks = discover_interpolation_tasks(root, subjects=subjects)
        report["interpolation"] = {}
        for i, task in enumerate(tasks):
            if i % num_shards != shard_index:
                continue
            try:
                report["interpolation"][task.key] = run_interpolation(
                    task, config, overwrite=overwrite,
                    mesh_cache=mesh_cache, cache_dir=cache_dir)
            except Exception as e:  # per-trial isolation
                logger.exception("batch: interpolation %s failed", task.key)
                # Namespaced: a later device-stage failure of the same
                # trial must not overwrite the interpolation error.
                report["errors"][
                    f"interpolate:{task.key}"] = f"{type(e).__name__}: {e}"
        stages = tuple(s for s in stages if s != "interpolate")

    trials = discover_trials(root, subjects=subjects)
    # Multi-host consistency: index-based sharding needs every shard to
    # agree on the trial list, but discover_trials only sees movies that
    # exist RIGHT NOW — another shard's still-running interpolation would
    # make shards disagree and silently orphan trials. The evoked task
    # list IS shard-independent, so merge in the trials every task will
    # produce (paths derived a priori). A trial whose owning shard hasn't
    # interpolated yet fails loudly here and completes on the next resume
    # sweep — never a silent skip. (For long multi-host sweeps, running
    # stages=('interpolate',) to completion first avoids those transient
    # errors entirely.)
    if tasks:
        have = {t.trial_dir for t in trials}
        for task in tasks:
            if task.trial_dir in have:
                continue
            movie, phases = interpolation_artifacts(task)
            trials.append(TrialRef(
                subject=task.subject, run=task.run, trial=task.trial,
                trial_dir=task.trial_dir, surface_path=task.surface_path,
                movie_path=movie, phases_path=phases))
        trials.sort(key=lambda t: t.key)
    mine = shard_trials(trials, num_shards, shard_index) if stages else []
    report["discovered"] = len(trials)
    # Cross-trial movie prefetch: trial i+1's CSV parses on a worker thread
    # while trial i computes on the accelerator, so steady-state sweeps
    # never pay the parse (~0.2 s at reference scale) on the critical path.
    from concurrent.futures import ThreadPoolExecutor

    from manifold_flow_tpu.utils import io

    def _wants_movie(t):
        return "flow" in stages and (overwrite
                                     or not stage_done(t, "flow", config))

    # One SWEEP-SHARED artifact writer: trial i's serialization (bz2 pickles,
    # CSVs) overlaps trial i+1's device compute instead of draining at each
    # trial boundary. The writer drains before run_batch returns, so the report
    # still means every artifact is on disk; a failed write raises into
    # whichever trial is running when it surfaces (or at the final drain) —
    # loud, though possibly attributed one trial late.
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="movie-prefetch") as pool, \
            io.ArtifactWriter(workers=2) as shared_writer:
        futures: dict = {}
        for i, trial in enumerate(mine):
            if i + 1 < len(mine) and _wants_movie(mine[i + 1]):
                futures[mine[i + 1].key] = pool.submit(
                    io.load_indexed_csv, mine[i + 1].movie_path)
            fut = futures.pop(trial.key, None)
            try:
                report["trials"][trial.key] = run_trial(
                    trial, config, stages=stages, sfreq=sfreq,
                    overwrite=overwrite, mesh_cache=mesh_cache,
                    cache_dir=cache_dir, movie_data=fut,
                    writer=shared_writer, device_mesh=device_mesh)
            except Exception as e:  # per-trial isolation: record + continue
                logger.exception("batch: trial %s failed", trial.key)
                report["errors"][trial.key] = f"{type(e).__name__}: {e}"
        try:
            shared_writer.wait()
        except Exception as e:
            logger.exception("batch: artifact write failed during drain")
            report["errors"]["artifact-writer"] = f"{type(e).__name__}: {e}"
    return report
