"""chip_smoke.py's CPU-testable parts: the device gate and its phase and
compare functions at a tiny size (the script itself needs a GPU)."""

import jax
import numpy as np
import pytest

import chip_smoke


def test_device_gate_refuses_cpu_backend(tmp_path, capsys):
    """On the CPU backend the smoke run exits non-zero before any phase
    and never prints the ok verdict."""
    with pytest.raises(SystemExit) as e:
        chip_smoke.device_gate()
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--workdir", str(tmp_path / "work")])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
    assert not (tmp_path / "work").exists()


def test_smoke_phases_and_comparisons_tiny_on_cpu(tmp_path):
    """The cohort phase (cli batch + resume), the SuperLU / scipy-Rbf /
    backend comparisons and the numerics checks run end to end at a tiny
    size, with the CPU standing in for the card."""
    from manifold_flow_tpu.pipeline import batch
    from manifold_flow_tpu.pipeline import stages as S
    from manifold_flow_tpu.pipeline.config import PipelineConfig
    from manifold_flow_tpu.utils import io

    sizes = chip_smoke.Sizes(nx=16, n_trials=1, check_frames=3)
    out = chip_smoke.phase_cohort(tmp_path / "cohort", sizes, seed=3)
    (trial,) = out["trials"]
    cfg = PipelineConfig()
    mesh = S.load_surface(trial.surface_path)
    movie = io.load_indexed_csv(trial.movie_path)[: cfg.solver.time_steps]
    times = np.arange(movie.shape[0]) / sizes.sfreq
    names = batch.artifact_names(batch.trial_prefix(trial))
    vk = io.load_indexed_csv(trial.trial_dir / names["v_k"])
    err = chip_smoke.check_solve("tiny", mesh, movie, times, vk,
                                 sizes.check_frames)
    assert err < chip_smoke.SOLVE_RMSE_GATE
    assert chip_smoke.compare_rbf(trial, sizes, cfg) < chip_smoke.RBF_GATE
    cpu = jax.devices("cpu")[0]
    chip_smoke.compare_analysis(mesh, vk, io.load_indexed_csv(
        trial.phases_path), 1.0 / sizes.sfreq, cfg, cpu, cpu)
    num = chip_smoke.check_numerics(mesh, movie[:8], times[:8], vk[:7])
    assert num["tf32_rel_err"] < chip_smoke.TF32_GATE
    assert num["residual_rel_err"] <= chip_smoke.RESIDUAL_GATE
    # A failed check raises instead of being reported and skipped.
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_solve("perturbed", mesh, movie, times, vk * 1.01,
                               sizes.check_frames)
