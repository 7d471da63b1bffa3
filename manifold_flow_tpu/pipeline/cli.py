"""Command-line driver for the pipeline stages.

One CLI with subcommands replaces the reference's per-script positional-argv
drivers (`python S3_... <subject> <run> <trial>`, S3:16-18; `python
S2_interpolate.py <subfolder>`, S2:65; etc.). Every subcommand reads the
typed PipelineConfig (which also accepts the reference's own config.yaml)
and exchanges artifacts in the reference's file formats so individual stages
interoperate with the original pipeline.

    python -m manifold_flow_tpu.pipeline.cli flow --surface s.ply \
        --potentials p.csv --sfreq 2048 --out-dir results/
    python -m manifold_flow_tpu.pipeline.cli demo --out-dir /tmp/demo
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _load_config(args):
    from manifold_flow_tpu.pipeline.config import PipelineConfig

    if getattr(args, "config", None):
        return PipelineConfig.from_yaml(args.config)
    return PipelineConfig()


def _add_common(p):
    p.add_argument("--config", help="YAML config (accepts the reference's "
                   "config.yaml layout)")
    p.add_argument("--out-dir", default=".", help="artifact directory")


def _load_movie(path):
    from manifold_flow_tpu.utils import io

    path = str(path)
    if path.endswith(".csv"):
        return io.load_indexed_csv(path)
    if path.endswith(".npy"):
        return np.load(path)
    raise SystemExit(f"unsupported movie format: {path} (want .csv or .npy)")


def cmd_preprocess(args):
    from manifold_flow_tpu.pipeline import preprocess

    cfg = _load_config(args)
    done = preprocess.process_subject(args.subject_dir, args.out_dir,
                                      cfg.preprocess, runs=args.runs)
    print(json.dumps({"stage": "preprocess", "runs_done": done}))


def cmd_reconstruct(args):
    from manifold_flow_tpu.pipeline import stages
    from manifold_flow_tpu.utils import io

    cfg = _load_config(args)
    coords = io.load_grid_electrodes(args.electrodes, group=args.group)
    out = Path(args.out_dir) / "reconstructed_surface.ply"
    res = stages.reconstruct_stage(coords, cfg, save_path=out)
    print(json.dumps({"stage": "reconstruct",
                      "n_vertices": int(res.mesh.n_vertices),
                      "n_triangles": int(res.mesh.n_triangles),
                      "surface": str(out)}))


def cmd_interpolate(args):
    from manifold_flow_tpu.pipeline import stages
    from manifold_flow_tpu.utils import io

    cfg = _load_config(args)
    mesh = stages.load_surface(args.surface)
    coords = io.load_grid_electrodes(args.electrodes, group=args.group,
                                     exclude=args.exclude)
    data = _load_movie(args.data)
    suffix = "phases_data" if args.phases else "data"
    out = Path(args.out_dir) / f"interpolation_{suffix}.csv"
    movie = stages.interpolate_stage(mesh, coords, data, cfg,
                                     sfreq=args.sfreq, phases=args.phases,
                                     save_path=out)
    print(json.dumps({"stage": "interpolate", "shape": list(movie.shape),
                      "out": str(out)}))


def cmd_flow(args):
    """S3: velocity fields + singularity detection/classification."""
    from manifold_flow_tpu.pipeline import stages

    cfg = _load_config(args)
    if args.tol:
        cfg.solver.tol = args.tol
    if args.method:
        cfg.solver.method = args.method
    mesh = stages.load_surface(args.surface)
    movie = _load_movie(args.potentials)
    if cfg.solver.time_steps and movie.shape[0] > cfg.solver.time_steps:
        movie = movie[: cfg.solver.time_steps]
    times = (np.arange(movie.shape[0]) / args.sfreq if args.sfreq
             else np.arange(movie.shape[0], dtype=np.float64))

    out = Path(args.out_dir)
    t0 = time.perf_counter()
    vel = stages.velocity_stage(
        mesh, movie, times, cfg,
        e_path=out / "e.csv", v_k_path=out / "V_k.csv",
        speed_path=out / "wave_velocity_opticalflow.pkl.bz2")
    solve_s = time.perf_counter() - t0
    pts, labels = stages.singularity_stage(
        mesh, vel.v_world, cfg, classify=args.classify,
        save_path=out / "singularity_points.pkl",
        classification_path=(out / "singularity_points_classification.pkl"
                             if args.classify else None))
    print(json.dumps({
        "stage": "flow", "frames": int(vel.v_k.shape[0]),
        "n_dof": int(vel.v_k.shape[1]), "solve_seconds": round(solve_s, 3),
        "iterations": vel.iterations, "converged": vel.converged,
        "singularities_per_frame": [len(p) for p in pts],
    }))


def cmd_decompose(args):
    from manifold_flow_tpu.pipeline import stages
    from manifold_flow_tpu.utils import io

    cfg = _load_config(args)
    v_k = io.load_indexed_csv(args.v_k)
    modes = stages.decompose_stage(v_k, cfg, mode=args.mode,
                                   npz_path=Path(args.out_dir) / "data_01.npz")
    sigma = np.asarray(modes.sigma)
    rendered = []
    if args.render_modes:
        from manifold_flow_tpu.viz import fields

        if not args.surface:
            raise SystemExit("--render-modes requires --surface")
        mesh = stages.load_surface(args.surface)
        underlay = (fields.load_pial_surfaces(*args.pial)
                    if args.pial else None)
        fmt = str(Path(args.out_dir) / "spatial_mode_{mode}.png")
        figs = fields.plot_spatial_modes(
            mesh, modes, n_modes=args.render_modes, underlay=underlay,
            save_path_fmt=fmt)
        rendered = [fmt.format(mode=i + 1) for i in range(len(figs))]
        import matplotlib.pyplot as plt

        plt.close("all")
    print(json.dumps({"stage": "decompose", "mode": args.mode,
                      "energy_pct": list(np.round(
                          100 * sigma**2 / (sigma**2).sum(), 3)[:8]),
                      "rendered_modes": rendered}))


def cmd_wavespeed(args):
    from manifold_flow_tpu.pipeline import stages

    _ = _load_config(args)
    mesh = stages.load_surface(args.surface)
    movie = _load_movie(args.movie)
    out = (Path(args.out_dir)
           / f"wave_velocity_{args.method}.pkl.bz2")
    ws = stages.wavespeed_stage(mesh, movie, dt=1.0 / args.sfreq,
                                method=args.method, save_path=out)
    print(json.dumps({"stage": "wavespeed", "method": args.method,
                      "shape": list(ws.shape), "out": str(out)}))


def cmd_streamline(args):
    from manifold_flow_tpu.pipeline import stages
    from manifold_flow_tpu.utils import io

    cfg = _load_config(args)
    mesh = stages.load_surface(args.surface)
    e = io.load_e_csv(args.e)
    v_k = io.load_indexed_csv(args.v_k)
    from manifold_flow_tpu.ops.recombine import velocity_to_world

    v_world = np.asarray(velocity_to_world(v_k, e))
    frames = range(args.start, args.end if args.end >= 0 else v_world.shape[0])
    fmt = str(Path(args.out_dir) / "t_velocityfields_streamlines_{frame}.pkl.bz2")
    lines = stages.streamline_stage(mesh, v_world, cfg, frames=frames,
                                    save_path_fmt=fmt)
    print(json.dumps({"stage": "streamline",
                      "lines_per_frame": {k: len(v) for k, v in lines.items()}}))


def cmd_winding(args):
    from manifold_flow_tpu.pipeline import stages
    from manifold_flow_tpu.utils import io

    cfg = _load_config(args)
    mesh = stages.load_surface(args.surface)
    e = io.load_e_csv(args.e)
    v_k = io.load_indexed_csv(args.v_k)
    sing = io.load_pickle(args.singularities)
    from manifold_flow_tpu.ops.recombine import velocity_to_world

    v_world = np.asarray(velocity_to_world(v_k, e))
    out = Path(args.out_dir) / "winding_lines.pkl.bz2"
    lines = stages.winding_stage(mesh, v_world, sing, cfg, save_path=out)
    print(json.dumps({"stage": "winding",
                      "frames_with_lines": len(lines), "out": str(out)}))


def cmd_visualize(args):
    """C19: glyph plot of one frame, or a GIF animation, from artifacts."""
    from manifold_flow_tpu.ops.recombine import velocity_to_world
    from manifold_flow_tpu.pipeline import stages
    from manifold_flow_tpu.utils import io
    from manifold_flow_tpu.viz import fields

    _ = _load_config(args)
    mesh = stages.load_surface(args.surface)
    e = io.load_e_csv(args.e)
    v_k = io.load_indexed_csv(args.v_k)
    v_world = np.asarray(velocity_to_world(v_k, e))
    scalars = _load_movie(args.scalars) if args.scalars else None
    sing = io.load_pickle(args.singularities) if args.singularities else None
    true_sing = (io.load_pickle(args.true_singularities)
                 if args.true_singularities else None)
    underlay = fields.load_pial_surfaces(*args.pial) if args.pial else None
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if args.gif:
        name = ("true_vs_detected.gif" if true_sing is not None
                else "velocity_fields.gif")
        path = out / name
        times = (np.arange(v_world.shape[0]) / args.sfreq
                 if args.sfreq else None)
        fields.animate_velocity_fields(
            mesh, v_world, path, scalars=scalars,
            singularities_per_frame=sing,
            true_singularities_per_frame=true_sing, times=times,
            scaling=args.scaling, stride=args.stride, underlay=underlay)
        print(json.dumps({"stage": "visualize", "gif": str(path),
                          "frames": int(v_world.shape[0])}))
    else:
        k = args.frame
        path = out / f"velocity_frame_{k}.png"
        fig = fields.plot_velocity_frame(
            mesh, v_world[k],
            scalars=scalars[k] if scalars is not None else None,
            singularities=np.asarray(sing[k]) if sing else None,
            true_singularities=(np.asarray(true_sing[k])
                                if true_sing else None),
            scaling=args.scaling, stride=args.stride,
            title=f"frame {k}", underlay=underlay)
        fig.savefig(path, dpi=120)
        print(json.dumps({"stage": "visualize", "png": str(path),
                          "frame": k}))


def cmd_batch(args):
    """Batch driver over a subjects/runs/trials results tree (the
    reference's argv-sharded Slurm loops, S2:79-102, S5:264-300, S7:205-261),
    with resume-by-artifact-presence and host sharding."""
    from manifold_flow_tpu.pipeline import batch

    cfg = _load_config(args)
    device_mesh = None
    if getattr(args, "frame_shards", None):
        from manifold_flow_tpu.parallel import make_device_mesh

        device_mesh = make_device_mesh(args.frame_shards, 1)
    report = batch.run_batch(
        args.root, cfg, stages=tuple(args.stages),
        subjects=args.subjects or None, sfreq=args.sfreq,
        overwrite=args.overwrite, num_shards=args.num_shards,
        shard_index=args.shard_index, distributed=args.distributed,
        cache_dir=args.cache_dir, device_mesh=device_mesh)
    print(json.dumps({"stage": "batch", **report}))
    if report["errors"]:
        return 1
    return 0


def cmd_demo(args):
    """End-to-end on synthetic data: surface -> movie -> flow -> detection."""
    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.pipeline import stages
    from manifold_flow_tpu.utils import io

    cfg = _load_config(args)
    cfg.solver.tol = 1e-8
    mesh = synthetic.plane_patch(
        nx=args.nx, ny=args.nx, lx=20.0, ly=20.0,
        height=lambda x, y: 1.5 * np.sin(x / 4.0) * np.cos(y / 5.0))
    pot, times, true_pts = synthetic.two_source_movie(
        mesh, sources=((5.0, 5.0), (15.0, 15.0)), n_frames=args.frames)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    io.write_ply(out / "simulated_surface.ply", np.asarray(mesh.points),
                 np.asarray(mesh.triangles))
    vel = stages.velocity_stage(mesh, pot, times, cfg,
                                e_path=out / "e.csv",
                                v_k_path=out / "V_k.csv")
    pts, _ = stages.singularity_stage(mesh, vel.v_world, cfg,
                                      save_path=out / "singularity_points.pkl")
    from manifold_flow_tpu.ops import validation

    report = validation.score_all_frames(
        mesh, pts, [true_pts] * len(pts),
        threshold=cfg.analysis.threshold,
        turning_point=len(pts) + 1)
    gif_path = None
    if args.gif:
        # The reference's simulated-data visual validation: detected (red)
        # vs true (blue) singularities animated over the velocity movie
        # (draw_optical_flow_field.py:258-319).
        from manifold_flow_tpu.viz import fields

        gif_path = out / "true_vs_detected.gif"
        fields.animate_velocity_fields(
            mesh, vel.v_world, gif_path, scalars=pot[:-1],
            singularities_per_frame=[np.asarray(p) for p in pts],
            true_singularities_per_frame=[np.asarray(true_pts)] * len(pts),
            times=np.asarray(times)[:-1], stride=4, dpi=60)
    print(json.dumps({
        "stage": "demo", "frames": int(vel.v_k.shape[0]),
        "converged": vel.converged,
        "matched": report.matched, "missed": report.missed,
        "spare": report.spare, "err_max": report.err_max,
        "gif": str(gif_path) if gif_path else None,
        "out_dir": str(out)}))


def build_parser():
    p = argparse.ArgumentParser(
        prog="manifold_flow_tpu",
        description="Manifold optical-flow pipeline (JAX)")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("preprocess", help="S0: BIDS iEEG -> epochs/evokeds")
    _add_common(sp)
    sp.add_argument("--subject-dir", required=True)
    sp.add_argument("--runs", nargs="*", default=None)
    sp.set_defaults(func=cmd_preprocess)

    sp = sub.add_parser("reconstruct", help="S1: electrodes.tsv -> surface.ply")
    _add_common(sp)
    sp.add_argument("--electrodes", required=True)
    sp.add_argument("--group", default="grid")
    sp.set_defaults(func=cmd_reconstruct)

    sp = sub.add_parser("interpolate", help="S2: electrode movie -> vertex movie")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--electrodes", required=True)
    sp.add_argument("--data", required=True, help="(T, E) movie .csv/.npy")
    sp.add_argument("--sfreq", type=float, default=None)
    sp.add_argument("--phases", action="store_true")
    sp.add_argument("--exclude", nargs="*", default=None,
                    help="electrode names to drop (e.g. the stimulated pair, "
                         "S2_interpolate.py:125-135)")
    sp.add_argument("--group", default="grid")
    sp.set_defaults(func=cmd_interpolate)

    sp = sub.add_parser("flow", help="S3: velocity fields + singularities")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--potentials", required=True)
    sp.add_argument("--sfreq", type=float, default=None)
    sp.add_argument("--method", default=None,
                    choices=[None, "cg", "cholesky", "refined"])
    sp.add_argument("--tol", type=float, default=None)
    sp.add_argument("--classify", action="store_true")
    sp.set_defaults(func=cmd_flow)

    sp = sub.add_parser("decompose", help="S4: spatiotemporal SVD")
    _add_common(sp)
    sp.add_argument("--v-k", required=True)
    sp.add_argument("--mode", default="concat", choices=["concat", "complex"])
    sp.add_argument("--render-modes", type=int, default=0,
                    help="render the leading K spatial modes as glyph PNGs "
                         "(extract_modes, S4_...ComplexMatrices .py:145-162); "
                         "requires --surface")
    sp.add_argument("--surface", default=None)
    sp.add_argument("--pial", nargs="*", default=None,
                    help="FreeSurfer pial surface(s) for the translucent "
                         "context underlay (S4_...ConcatMatrices .py:147-158)")
    sp.set_defaults(func=cmd_decompose)

    sp = sub.add_parser("wavespeed", help="S5: wave speeds from a movie")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--movie", required=True)
    sp.add_argument("--sfreq", type=float, required=True)
    sp.add_argument("--method", default="phase",
                    choices=["phase", "amplitude"])
    sp.set_defaults(func=cmd_wavespeed)

    sp = sub.add_parser("streamline", help="S6: streamline extraction")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--e", required=True)
    sp.add_argument("--v-k", required=True)
    sp.add_argument("--start", type=int, default=0)
    sp.add_argument("--end", type=int, default=-1)
    sp.set_defaults(func=cmd_streamline)

    sp = sub.add_parser("winding", help="S7: winding-line analysis")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--e", required=True)
    sp.add_argument("--v-k", required=True)
    sp.add_argument("--singularities", required=True)
    sp.set_defaults(func=cmd_winding)

    sp = sub.add_parser("visualize",
                        help="C19: glyph plot / GIF from V_k artifacts")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--e", required=True)
    sp.add_argument("--v-k", required=True)
    sp.add_argument("--scalars", default=None,
                    help="(T, N) potentials/phases movie for the colormap")
    sp.add_argument("--singularities", default=None,
                    help="singularity_points.pkl to overlay (red)")
    sp.add_argument("--true-singularities", default=None,
                    help="ground-truth points pkl for the true-vs-detected "
                         "overlay/GIF (draw_optical_flow_field.py:258-319)")
    sp.add_argument("--pial", nargs="*", default=None,
                    help="FreeSurfer pial surface(s) underlay")
    sp.add_argument("--frame", type=int, default=0)
    sp.add_argument("--gif", action="store_true")
    sp.add_argument("--sfreq", type=float, default=None,
                    help="adds time-stamped GIF titles")
    sp.add_argument("--scaling", default="scaled", choices=["raw", "scaled"])
    sp.add_argument("--stride", type=int, default=1)
    sp.set_defaults(func=cmd_visualize)

    sp = sub.add_parser("batch",
                        help="walk a results tree; run device stages per "
                             "trial with resume + host sharding")
    _add_common(sp)
    sp.add_argument("--root", required=True,
                    help="results tree root: <root>/<subject>/run-*/<trial>/")
    sp.add_argument("--stages", nargs="*",
                    default=["flow", "streamline", "decompose", "wavespeed",
                             "winding"],
                    choices=["interpolate", "flow", "decompose", "wavespeed",
                             "streamline", "winding", "wavespeed_amplitude"],
                    help="'interpolate' adds the S2 sweep: evokeds + TSVs "
                         "-> interpolated movies (stim pair auto-excluded)")
    sp.add_argument("--subjects", nargs="*", default=None)
    sp.add_argument("--sfreq", type=float, default=None,
                    help="overrides the BIDS sidecar SamplingFrequency")
    sp.add_argument("--overwrite", action="store_true",
                    help="re-run stages whose artifacts already exist")
    sp.add_argument("--num-shards", type=int, default=None)
    sp.add_argument("--shard-index", type=int, default=None)
    sp.add_argument("--distributed", action="store_true",
                    help="derive the shard from jax.distributed "
                         "process_index/process_count")
    sp.add_argument("--cache-dir", default=None,
                    help="geometry-precompute cache directory")
    sp.add_argument("--frame-shards", type=int, default=None,
                    help="run each trial MULTI-DEVICE: shard the frame axis "
                         "of the solve + analysis stages over this many "
                         "devices (parallel.analysis; streamlines stay "
                         "single-device)")
    sp.set_defaults(func=cmd_batch)

    sp = sub.add_parser("demo", help="synthetic end-to-end run + validation")
    _add_common(sp)
    sp.add_argument("--nx", type=int, default=24)
    sp.add_argument("--frames", type=int, default=12)
    sp.add_argument("--gif", action="store_true",
                    help="also render the true-vs-detected validation GIF")
    sp.set_defaults(func=cmd_demo)
    return p


def main(argv=None):
    import jax

    from manifold_flow_tpu.utils.compile_cache import configure_compile_cache

    # x64 inputs enable the mixed-precision 'refined'/'auto' solver path and
    # keep artifact parity with the reference's float64 files.
    jax.config.update("jax_enable_x64", True)
    # Solver programs are expensive to build; reuse executables across CLI
    # invocations.
    configure_compile_cache()
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
