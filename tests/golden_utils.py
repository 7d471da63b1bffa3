"""Golden-artifact fixtures: pin the on-disk interop surface permanently.

This image can never run PyVista/MNE, so reference-produced artifacts cannot
be regenerated here. Instead a tiny synthetic trial's FULL artifact tree —
both quirk modes — is checked in under tests/fixtures/golden/, and
tests/test_golden.py asserts that today's pipeline reproduces every file
through the same loaders a reference consumer would use.

Regenerate (only when an intentional numerics/format change lands) with:

    python -m tests.golden_utils

which rewrites tests/fixtures/golden/quirks_{off,on}/.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# One trial named exactly like the reference's S2 output (S2:157).
STEM = "sub-01_ses-1_task-SPESclin_run-007-G1-G2"
SUBJECT = "sub-01"
RUN = "run-007"
TRIAL = "G1-G2"
N_FRAMES = 4
NX = 9  # 81 vertices — big enough for real singularities, tiny on disk

GOLDEN_ROOT = Path(__file__).parent / "fixtures" / "golden"


def _config(quirks: bool):
    from manifold_flow_tpu.pipeline.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.reference_quirks = quirks
    cfg.solver.tol = 1e-10          # tight: pins values well below drift
    cfg.analysis.min_streamline_length = 3   # walks are short on 81 vertices
    return cfg


def build_mesh():
    """Generic bumpy surface: perfectly symmetric flat meshes put field
    zeros exactly on vertices/edges and flip discrete outputs on last-ulp
    changes (CLAUDE.md numerical gotchas)."""
    from manifold_flow_tpu.geometry import synthetic

    return synthetic.plane_patch(
        nx=NX, ny=NX, lx=6.0, ly=6.0,
        height=lambda x, y: 0.35 * np.sin(1.3 * x + 0.4) * np.cos(
            0.9 * y - 0.2))


def make_input_tree(root: Path):
    """Reference-layout inputs for one trial (surface, movie, phases,
    BIDS sidecar); returns the trial directory."""
    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.utils import io

    mesh = build_mesh()
    subj = root / SUBJECT
    subj.mkdir(parents=True, exist_ok=True)
    io.write_ply(subj / f"{SUBJECT}_reconstructed_surface.ply",
                 np.asarray(mesh.points), np.asarray(mesh.triangles))
    pot, _, _ = synthetic.two_source_movie(
        mesh, sources=((1.6, 1.7), (4.3, 4.5)), n_frames=N_FRAMES)
    tdir = subj / RUN / TRIAL
    tdir.mkdir(parents=True, exist_ok=True)
    io.save_indexed_csv(tdir / f"{STEM}-ave-interpolation_data.csv",
                        np.asarray(pot))
    rng = np.random.default_rng(7)
    io.save_indexed_csv(
        tdir / f"{STEM}-ave-interpolation_phases_data.csv",
        rng.uniform(-np.pi, np.pi, size=np.asarray(pot).shape))
    (subj / f"{SUBJECT}_ieeg.json").write_text(
        json.dumps({"SamplingFrequency": 512}))
    return tdir


def generate(root: Path, quirks: bool) -> dict:
    """Run every batch stage for the fixture trial under `root`."""
    from manifold_flow_tpu.pipeline import batch

    make_input_tree(root)
    trials = batch.discover_trials(root)
    assert len(trials) == 1
    return batch.run_trial(trials[0], _config(quirks),
                           stages=batch.ALL_STAGES, overwrite=True)


def mode_dir(quirks: bool) -> Path:
    return GOLDEN_ROOT / ("quirks_on" if quirks else "quirks_off")


def artifact_files(root: Path) -> dict:
    """{relative_path: absolute_path} for every OUTPUT artifact under a
    generated tree (inputs excluded so the comparison covers outputs only)."""
    inputs = {f"{STEM}-ave-interpolation_data.csv",
              f"{STEM}-ave-interpolation_phases_data.csv",
              f"{SUBJECT}_reconstructed_surface.ply",
              f"{SUBJECT}_ieeg.json"}
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file() and p.name not in inputs:
            out[str(p.relative_to(root))] = p
    return out


def compare_artifact(name: str, got: Path, want: Path) -> None:
    """Loader-level equality for one artifact; assertion messages name it."""
    from manifold_flow_tpu.utils import io

    def close(a, b, what, rtol=1e-5, atol=1e-8):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (
            f"{name}: {what} shape {a.shape} != golden {b.shape}")
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=atol, err_msg=f"{name}: {what}")

    if name.endswith("_e.csv"):
        close(io.load_e_csv(got), io.load_e_csv(want), "tangent bases",
              rtol=1e-9, atol=1e-12)
    elif name.endswith(".csv"):
        close(io.load_indexed_csv(got), io.load_indexed_csv(want), "table")
    elif name.endswith("singularity_points.pkl"):
        a, b = io.load_pickle(got), io.load_pickle(want)
        assert len(a) == len(b), f"{name}: frame count {len(a)} != {len(b)}"
        for k, (fa, fb) in enumerate(zip(a, b)):
            close(fa, fb, f"frame {k} points", rtol=1e-5, atol=1e-6)
    elif "winding_lines" in name:
        a, b = io.load_pickle(got), io.load_pickle(want)
        assert sorted(a) == sorted(b), (
            f"{name}: frames {sorted(a)} != golden {sorted(b)}")
        for k in b:
            assert len(a[k]) == len(b[k]), (
                f"{name}: frame {k} row count {len(a[k])} != {len(b[k])}")
            for i, (ra, rb) in enumerate(zip(a[k], b[k])):
                close(ra[0], rb[0], f"frame {k} row {i} coord",
                      rtol=1e-5, atol=1e-6)
                assert ra[1] == rb[1], (
                    f"{name}: frame {k} row {i} ring count "
                    f"{ra[1]} != {rb[1]}")
                assert ra[2] == rb[2], (
                    f"{name}: frame {k} row {i} type {ra[2]} != {rb[2]}")
    elif "streamlines" in name:
        a, b = io.load_pickle(got), io.load_pickle(want)
        assert sorted(a) == sorted(b), f"{name}: keys differ"
        for k in b:
            assert len(a[k]) == len(b[k]), (
                f"{name}: frame {k} line count {len(a[k])} != {len(b[k])}")
            for i, (la, lb) in enumerate(zip(a[k], b[k])):
                close(la, lb, f"frame {k} line {i}", rtol=1e-6, atol=1e-9)
    elif name.endswith(".npz"):
        with np.load(got) as za, np.load(want) as zb:
            assert set(za.files) == set(zb.files), f"{name}: keys differ"
            assert int(za["point_num"]) == int(zb["point_num"]), (
                f"{name}: point_num")
            close(za["Sigma"], zb["Sigma"], "Sigma")
            # U/VT columns are sign/phase-ambiguous only under degenerate
            # sigmas; the fixture spectrum is simple, so compare directly.
            close(za["U"], zb["U"], "U")
            close(za["VT"], zb["VT"], "VT")
    elif name.endswith(".pkl.bz2") or name.endswith(".pkl"):
        close(io.load_pickle(got), io.load_pickle(want), "array")
    else:
        raise AssertionError(f"{name}: no comparison rule for this artifact")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import shutil

    for quirks in (False, True):
        dst = mode_dir(quirks)
        if dst.exists():
            shutil.rmtree(dst)
        dst.mkdir(parents=True)
        report = generate(dst, quirks)
        print(f"quirks={quirks}: {report}")
        print(f"  -> {len(artifact_files(dst))} artifacts under {dst}")
