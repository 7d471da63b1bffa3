"""Benchmark: manifold optical-flow velocity solve, GPU vs CPU reference.

Problem: reference-scale cortical-patch analogue — ~3.1k-vertex curved
surface (the CCEP grids reconstruct to ~3101 vertices / ~6202 velocity DOFs,
SURVEY.md §0), 98-frame potentials movie (config.yaml:5), lambda = 0.01.

Device path: batched matrix-free block-Jacobi PCG over all frames at once
(manifold_flow_tpu.solve). CPU baseline: vectorized scipy assembly +
SuperLU spsolve per frame — the reference algorithm
(utils/compute_optical_flow.py:100-149) in its strongest reasonable NumPy
form (the original's pure-Python triangle loops would be ~100x slower still).

Prints ONE JSON line:
  {"metric": ..., "value": frames/s on the GPU, "unit": "frames/s",
   "vs_baseline": GPU frames/s / CPU frames/s, ...extras}

Needs a GPU: with any other JAX backend it exits non-zero, and any failed
stage fails the run. (Named benchmark cells are ROADMAP A1.)
"""

from __future__ import annotations

import json
import time

import numpy as np


def build_problem(dtype=np.float32):
    from manifold_flow_tpu.geometry import synthetic

    mesh = synthetic.plane_patch(
        nx=56, ny=56, lx=60.0, ly=60.0,
        height=lambda x, y: 6.0 * np.sin(x / 12.0) * np.cos(y / 15.0),
        dtype=np.float64,
    )
    pot, times, _ = synthetic.two_source_movie(
        mesh, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=98,
        speed=24.0, wavelength=24.0, dt=1.0 / 512.0, dtype=np.float64,
    )
    return mesh, pot, times


def bench_device(mesh64, pot, times, dtype, repeats=3, tol=1e-6):
    # tol 1e-6 on the outer residual puts the solution RMSE ~1e-6 vs SuperLU
    # (reported below), an order of magnitude below the 1e-5 parity gate.
    """Time the mixed-precision refined solve: f32 PCG inner iterations + a
    few high-precision residual matvecs, converging to SuperLU-level
    accuracy (solve.refine)."""
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.solve.api import compute_velocity_fields

    mesh = mesh64
    potd = jnp.asarray(pot)
    timesd = jnp.asarray(times)

    def step(p, t):
        return compute_velocity_fields(
            mesh, p, t, lambda_=0.01, method="refined", tol=tol,
            max_iter=4000)

    # One outer jit over the API call: the mesh (a closure constant) folds
    # the frame-independent DF tables into the executable at trace time.
    run = jax.jit(lambda p, t: step(p, t).v_k)

    out = run(potd, timesd)
    out.block_until_ready()  # compile + warmup
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run(potd, timesd)
        out.block_until_ready()
        best = min(best, time.perf_counter() - t0)
    n_frames = pot.shape[0] - 1
    res = step(potd, timesd)
    return np.asarray(out), n_frames / best, res


def _time_program(fn, *args, repeats=3):
    """Best wall-clock of a jitted program (compile + warmup excluded)."""
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def bench_analysis_stages(mesh, v_world, eps=1e-4):
    """Frames/s of each S3-S7 analysis stage as ONE device program over the
    whole movie (detection, classification, streamlines, winding). The
    reference runs these as
    per-frame/per-seed Python loops over PyVista queries
    (utils/find_singularity_point.py:530-605, S6_streamline.py:17-37,
    S7_winding_line.py:120-165)."""
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.ops import singularity as sing_ops
    from manifold_flow_tpu.ops import streamline as stream_ops
    from manifold_flow_tpu.ops import winding as wind_ops

    v = jnp.asarray(np.asarray(v_world), jnp.float32)
    t = v.shape[0]
    out = {}

    detect = jax.jit(lambda vv: sing_ops.detect(mesh, vv, eps=eps))
    out["detect_fps"] = t / _time_program(detect, v)
    field = detect(v)

    vm = np.asarray(field.vertex_mask)
    im = np.asarray(field.interior_mask)
    cap = max(int(vm.sum(axis=1).max()), int(im.sum(axis=1).max()), 1)
    cap = -(-cap // 8) * 8
    classify = jax.jit(lambda vv, ff: sing_ops.classify_detected(
        mesh, vv, ff, capacity=cap))
    out["classify_fps"] = t / _time_program(classify, v, field)

    # The stage entrypoint (adaptive window + compact escalation retrace):
    # device cost follows the actual walk-length distribution, not the
    # 256-step cap; includes the host-side escalation logic like production.
    plan: dict = {}

    def trace(vv):
        return stream_ops.trace_frames_adaptive(mesh, vv, max_steps=256,
                                                plan_out=plan)

    sl = trace(v)   # warmup 1: default schedule; records the length stats
    jax.block_until_ready(sl)
    sl = trace(v)   # warmup 2: compiles the stats-planned schedule
    jax.block_until_ready(sl)
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(trace(v))
        best = min(best, time.perf_counter() - t0)
    out["streamline_fps"] = t / best
    k = int(np.asarray(sl.overlay_ids).size) if sl.overlay_ids is not None \
        else 0
    out["streamline_retrace_k"] = k
    out["streamline_retrace_w"] = (
        int(sl.overlay_vertices.shape[1] - 1) if k else 0)
    out["streamline_plan_w1"] = int(plan.get("w1", 16))
    out["streamline_plan_cap"] = int(plan.get("cap", 0))

    # Part attribution: the tracer's three stages timed
    # separately — next-hop tables alone, pass 1 (tables + doubling +
    # first-repeat detection at the planned first window), and the full
    # adaptive trace (adds the escalation retrace dispatch) — so the
    # floor-fraction gap is attributable instead of a single opaque number.
    boundary = stream_ops.boundary_indices(mesh)
    tables_fn = jax.jit(
        lambda vv: stream_ops._hop_graph(mesh, vv, False, boundary))
    t_tables = _time_program(tables_fn, v)
    t_pass1 = _time_program(
        lambda vv: stream_ops._trace_frames_graph(
            mesh, vv, max_steps=int(plan.get("w1", 16)), quirks=False,
            boundary=boundary), v)
    out["streamline_part_tables_ms"] = t_tables * 1e3
    out["streamline_part_double_ms"] = max(t_pass1 - t_tables, 0.0) * 1e3
    out["streamline_part_retrace_ms"] = max(best - t_pass1, 0.0) * 1e3

    # Winding over the detected singularities at a common capacity (the
    # device program of pipeline.stages.winding_stage).
    pts = np.asarray(field.interior_point)
    smax = max(cap, 1)
    pts_arr = np.zeros((t, smax, 3), np.float32)
    valid = np.zeros((t, smax), bool)
    mpts = np.asarray(mesh.points)
    for k in range(t):
        sel = list(np.where(vm[k])[0][:smax])
        rows = [mpts[i] for i in sel]
        for m in np.where(im[k])[0][: smax - len(rows)]:
            rows.append(pts[k, m])
        if rows:
            pts_arr[k, : len(rows)] = np.stack(rows)
            valid[k, : len(rows)] = True
    # Snapped centers come precomputed, as in production (the detection
    # stage emits them from its own device program, so the winding stage
    # no longer pays a host-side snap).
    d2 = ((pts_arr.reshape(-1, 1, 3) - mpts[None]) ** 2).sum(-1)
    centers = d2.argmin(axis=1).astype(np.int32).reshape(t, smax)

    def wind(vv):
        # The production path: unique-center dedup + one jitted program.
        return wind_ops.analyze_singularities_movie(
            mesh, vv, pts_arr, valid, max_level=25, centers=centers)

    out["winding_fps"] = t / _time_program(wind, v)
    out["winding_capacity"] = smax
    # Distinct snapped centers across the movie — sizes the winding floor
    # model (ring tables are built once per unique center).
    out["winding_unique_centers"] = int(len(np.unique(centers[valid])))
    return out


def bench_field_stages(mesh, pot, v_k, sfreq=512.0, n_electrodes=64):
    """Frames/s of the field-processing stages the reference runs per trial:
    S2 RBF interpolation (electrodes -> vertices), S4 concat SVD of the
    velocity movie, S5 phase wave speeds. Completes the capability-surface
    coverage beyond the S3/S6/S7 analysis ops."""
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.ops import interpolate as rbf_ops
    from manifold_flow_tpu.ops import svd as svd_ops
    from manifold_flow_tpu.ops import wavespeed as wave_ops

    t = pot.shape[0]
    rng = np.random.default_rng(0)
    sel = rng.choice(mesh.n_vertices, n_electrodes, replace=False)
    coords = jnp.asarray(np.asarray(mesh.points)[sel])
    data = jnp.asarray(np.asarray(pot)[:, sel])
    out = {}
    interp = jax.jit(lambda c, d: rbf_ops.rbf_interpolate(c, d, mesh.points))
    out["interpolate_fps"] = t / _time_program(interp, coords, data)

    vkj = jnp.asarray(np.asarray(v_k))
    svd = jax.jit(lambda v: svd_ops.decompose_concat(v, n_modes=8))
    out["svd_fps"] = v_k.shape[0] / _time_program(svd, vkj)

    ph = jnp.asarray(np.angle(np.exp(1j * np.asarray(pot))))
    wave = jax.jit(lambda m: wave_ops.wave_velocity_phase_mm_per_ms(
        mesh, m, 1.0 / sfreq))
    out["wavespeed_fps"] = t / _time_program(wave, ph)
    return out


def bench_end_to_end_s3(mesh, pot, times, tol=1e-6):
    """The whole S3 stage as ONE program: refined velocity solve ->
    world-frame recombination -> speed map -> singularity detection."""
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.ops import singularity as sing_ops
    from manifold_flow_tpu.ops.recombine import velocity_to_world, world_speed
    from manifold_flow_tpu.solve.api import compute_velocity_fields

    def s3(p, t_):
        res = compute_velocity_fields(mesh, p, t_, lambda_=0.01,
                                      method="refined", tol=tol,
                                      max_iter=4000)
        v3 = velocity_to_world(res.v_k, mesh.basis).astype(jnp.float32)
        field = sing_ops.detect(mesh, v3)
        return v3, world_speed(v3), field.vertex_mask, field.interior_point

    fn = jax.jit(s3)
    best = _time_program(fn, jnp.asarray(pot), jnp.asarray(times))
    return (pot.shape[0] - 1) / best


def bench_yardsticks(chase_size: int):
    """Measured hardware ceilings on this device (one jitted program each,
    with an internal dependency-chained fori_loop so the dispatch latency
    amortizes away):

      axpy_gbps   streaming memory bandwidth: y = a*y + x on 16M-float32
                  arrays (3 streams/round, 64 MB each — beyond the L2).
      chase_geps  random-gather throughput (1e9 elements/s): idx = table[idx]
                  pointer chase over a `chase_size` permutation — the access
                  pattern of the streamline tracer's doubling rounds (indices
                  differ per element, table shared, no batch reuse).
      sort_gkps   row-sort throughput (1e9 keys/s) on winding-shaped rows
                  (T*S rows of N float32 keys) — the winding profile's
                  composite-key argsort is one such sort per frame batch.
      dispatch_ms fixed per-call latency of the device path (one
                  trivial program) — the floor for any stage whose compute
                  has been driven below it.

    These turn "bandwidth-bound"/"gather-floor" claims for the solve,
    streamline, and winding stages into recorded achieved-vs-ceiling
    fractions instead of working-notes prose."""
    import jax
    import jax.numpy as jnp

    out = {}
    size = 1 << 24
    rounds = 16
    x = jnp.ones((size,), jnp.float32)
    y0 = jnp.zeros((size,), jnp.float32)

    @jax.jit
    def axpy(y, x):
        return jax.lax.fori_loop(
            0, rounds, lambda i, y: jnp.float32(0.999) * y + x, y)

    t_ax = _time_program(axpy, y0, x)
    out["axpy_gbps"] = rounds * 3 * size * 4 / t_ax / 1e9

    g = int(chase_size)
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.permutation(g).astype(np.int32))
    idx0 = jnp.arange(g, dtype=jnp.int32)
    chase_rounds = 64

    @jax.jit
    def chase(idx, tab):
        return jax.lax.fori_loop(
            0, chase_rounds, lambda i, idx: tab[idx], idx)

    t_ch = _time_program(chase, idx0, table)
    out["chase_geps"] = chase_rounds * g / t_ch / 1e9

    rows, n = 776, 3136
    keys = jnp.asarray(rng.standard_normal((rows, n)).astype(np.float32))
    sort_rounds = 8

    @jax.jit
    def sorter(k):
        # Bitonic sort networks are data-oblivious, but re-sorting the same
        # ascending rows could still fold; reverse between rounds.
        return jax.lax.fori_loop(
            0, sort_rounds,
            lambda i, k: jax.lax.sort(k[:, ::-1], dimension=1), k)

    t_so = _time_program(sorter, keys)
    out["sort_gkps"] = sort_rounds * rows * n / t_so / 1e9

    trivial = jax.jit(lambda a: a + 1.0)
    out["dispatch_ms"] = _time_program(
        trivial, jnp.float32(1.0), repeats=5) * 1e3

    # Device->host link bandwidth: results crossing back to the host are
    # necessary traffic for any stage whose algorithm consumes them there
    # (the adaptive tracer's lengths array, the compaction fetches).
    # Fresh buffers each rep — jax caches the host copy after a fetch.
    fb = 1 << 21  # 8 MB of float32
    bufs = [jax.block_until_ready(jnp.full((fb,), np.float32(i)))
            for i in range(3)]
    best_f = np.inf
    for b in bufs:
        t0 = time.perf_counter()
        np.asarray(b)
        best_f = min(best_f, time.perf_counter() - t0)
    out["fetch_mbps"] = fb * 4 / best_f / 1e6
    return out


def floor_fractions(mesh, n_frames, iters, outer_steps, yard,
                    solve_time_s, streamline_time_s, winding_time_s,
                    winding_unique, stream_window=16, stream_retrace_k=0,
                    stream_retrace_w=0, stream_pipelined=False):
    """Achieved-vs-ceiling fractions for the three stages whose throughput
    sits furthest above the dispatch floor. Each floor is a documented
    minimal-traffic model priced at the measured yardsticks; frac ~= 1 means
    "at the hardware floor", well under ~0.7 means a gap worth attacking.

    Solve (refined, jacobi): per f32 CG iteration the matvec must move
      xg gather out (T*M*6) + g (T*M*6) + y_loc write (T*M*6) + the two
      reduction gathers (2*T*N*C) + ap write/p read (2V)
    and the vector recurrences move 14V more (x,r,z,p updates, 2x2 precond
    blocks = 2V, convergence dot) with V = T*2N float32 elements. The
    matvec's gathers share their index vector across all T frames (the
    (T, 2N) layout keeps them batched), so they price as STREAMING traffic,
    not pointer-chase gathers. Each outer step adds one f64 residual
    (~2x an f32 matvec's bytes, priced here as 3x). Ceiling: axpy_gbps.

    Streamlines (two-pass adaptive, first window w1 then a compact retrace
    of K truncated walks at w2): pointer doubling materializes seq via
    gathers of sum 2^k = (w-1)*R elements per pass (R = T*N then K) plus
    log2(w)*T*N jump-table squarings each and one final column; every one
    is an independent-index gather from a shared table — priced at
    chase_geps — and the second dispatch adds dispatch_ms. Next-hop tables
    + first-repeat detection are modeled as streaming reads of the
    neighbor/cell tables (T*(3*N*D + 2*N*C + 21*N) float32-equivalents at
    axpy_gbps; first-repeat detection at w<=64 is folded into that
    allowance). Table-build overhead beyond the streaming allowance and the
    host-side escalation logic between the two dispatches are genuine
    costs of the implementation, not hardware-necessary floor terms, so
    they stay OUT of the model and the fraction reads as "what a
    zero-overhead tracer could still save".

    Winding (unique-center grid design): one composite-key argsort of N
    keys (priced at sort_gkps; argsort ~ sort of key+payload, x2) and one
    25-level masked BFS per UNIQUE center — BFS frontier gathers reuse one
    index table across the vmapped batch, priced as streaming traffic of
    25*(N*D + N) elements at axpy_gbps — plus one prefix-sum profile per
    (unique center, frame) grid cell: ~14 streaming passes over N elements
    (projection, index-shared sorted gather, normalization, pair angles,
    cumsum, ring sampling). The stage is one device call, so the floor
    includes dispatch_ms; the residual above the floor is host-side (center
    dedup and table transfers)."""
    t = n_frames
    n = mesh.n_vertices
    m = int(mesh.triangles.shape[0])
    d = int(mesh.vertex_neighbors.shape[1])
    c = int(mesh.vertex_cells.shape[1])
    v = t * 2 * n
    bw = yard["axpy_gbps"] * 1e9
    geps = yard["chase_geps"] * 1e9
    kps = yard["sort_gkps"] * 1e9

    stream_elems = 3 * t * m * 6 + 2 * t * n * c + 2 * v + 14 * v
    per_iter = 4.0 * stream_elems / bw
    solve_floor = iters * per_iter + outer_steps * 3.0 * per_iter
    out = {
        "solve_floor_ms": solve_floor * 1e3,
        "solve_bw_frac": solve_floor / solve_time_s,
    }

    # Prices pass 1 plus ONE retrace at the recorded final width (the seed
    # count uses the graded capacity bucket the device actually gathers
    # over); a rare multi-round escalation executes extra passes the model
    # does not price, reading as a lower fraction on such runs. The
    # device->host result fetches (walk lengths + retrace lengths) are
    # NECESSARY traffic — the patching algorithm consumes them on the
    # host — priced at the measured link bandwidth. With the pipelined
    # schedule (stream_pipelined) both dispatches issue back-to-back and
    # the lengths fetch overlaps the retrace compute, so the floor exposes
    # ONE dispatch latency and only the fetch time the retrace cannot
    # hide; the legacy host-driven schedule serializes everything.
    from manifold_flow_tpu.ops.streamline import _bucket

    w1 = stream_window
    lg = lambda w: int(np.ceil(np.log2(max(w, 1))))  # noqa: E731
    table_elems = t * (3 * n * d + 2 * n * c + 21 * n)
    link = yard["fetch_mbps"] * 1e6
    disp = yard["dispatch_ms"] / 1e3
    stream_floor = (((w1 - 1) * t * n + lg(w1) * t * n + t * n) / geps
                    + 4.0 * table_elems / bw)
    len_fetch = t * n * 2 / link  # int16 lengths
    if stream_retrace_k:
        w2 = stream_retrace_w
        k_cap = _bucket(stream_retrace_k)
        # Squarings continue from the pass-1 power tables (not re-paid).
        retrace = ((w2 - 1) * k_cap + (lg(w2) - lg(w1)) * t * n
                   + k_cap) / geps
        ol_fetch = k_cap * 2 / link
        if stream_pipelined:
            stream_floor += (retrace + disp + ol_fetch
                             + max(0.0, len_fetch - retrace))
        else:
            stream_floor += retrace + 2 * disp + len_fetch + ol_fetch
    else:
        stream_floor += disp + len_fetch
    out["streamline_floor_ms"] = stream_floor * 1e3
    out["streamline_gather_frac"] = stream_floor / streamline_time_s

    u = winding_unique
    sort_keys = 2.0 * u * n
    bfs_elems = u * 25 * (n * d + n)
    profile_elems = u * t * 14 * n
    wind_floor = (sort_keys / kps
                  + 4.0 * (bfs_elems + profile_elems) / bw
                  + yard["dispatch_ms"] / 1e3)
    out["winding_floor_ms"] = wind_floor * 1e3
    out["winding_floor_frac"] = wind_floor / winding_time_s
    return out


def _mesh_12k():
    """The large-mesh benchmark surface (~12.5k vertices) — shared by the
    solve bench and the scaling accounting so the partition cache hits."""
    from manifold_flow_tpu.geometry import synthetic

    return synthetic.plane_patch(
        nx=112, ny=112, lx=60.0, ly=60.0,
        height=lambda x, y: 6.0 * np.sin(x / 12.0) * np.cos(y / 15.0),
        dtype=np.float64,
    )


def bench_scaling(mesh12, hbm_gbps):
    """Multi-device scaling evidence, two halves:

    (a) bytes-based mesh-axis model at production scale: halo all_gather
        traffic per matvec + boundary fraction from the real partition
        tables at 2/4/8 shards, and the overlap-free per-device efficiency
        prediction at the H100's published NVLink rate (450 GB/s each way)
        and the measured streaming bandwidth `hbm_gbps` (parallel.scaling;
        the written model is docs/SCALING.md).
    (b) measured frame-axis throughput retention on the virtual CPU device
        mesh (weak + strong, 1-8 devices). Retention beyond the host's
        physical cores is core-bound — recorded with the core count so it
        reads as mechanism validation, not device efficiency; the frames
        axis has no per-iteration communication, so its model efficiency
        is ~1.
    """
    from manifold_flow_tpu.parallel import (halo_comm_stats, measure_scaling,
                                            predicted_efficiency)
    from manifold_flow_tpu.parallel.scaling import NVLINK_GBPS_H100

    out = {}
    for n in (2, 4, 8):
        st = halo_comm_stats(mesh12, n)
        out[f"halo_bytes_per_matvec_{n}"] = int(st.link_bytes)
        out[f"halo_frac_{n}"] = round(st.halo_fraction, 4)
        out[f"scaling_eff_pred_{n}"] = round(
            predicted_efficiency(st, hbm_gbps=hbm_gbps,
                                 link_gbps=NVLINK_GBPS_H100), 3)
    out["scaling_link_gbps_assumed"] = NVLINK_GBPS_H100
    meas = measure_scaling(n_devices=(1, 2, 4, 8), frames_per_device=8,
                           nx=24, tol=1e-5)
    out["scaling_weak_eff"] = meas["weak_eff"]
    out["scaling_strong_eff"] = meas["strong_eff"]
    out["scaling_weak_fps"] = meas["weak_fps"]
    out["scaling_strong_fps"] = meas["strong_fps"]
    out["scaling_host_cores"] = meas["physical_cores"]
    # Self-describing semantics: on a host with fewer
    # physical cores than virtual devices, wall-time strong-scaling
    # retention measures HOST CORE saturation, not framework efficiency —
    # flag it so a parser cannot read 0.12@8 as a distributed-solve result.
    # The framework efficiency claim at real link bandwidth is
    # scaling_eff_pred_* above (bytes-based model, docs/SCALING.md).
    out["scaling_strong_core_bound"] = (
        meas["physical_cores"] < max((2, 4, 8)))
    return out


def bench_scale_12k(mesh, tol=1e-6, n_frames=98):
    """The large-mesh regime as a recorded number: ~12.5k
    vertices is where precond='auto' switches to the two-level aggregation
    coarse correction (solve/api.py TWO_LEVEL_MIN_VERTICES). Reports fps,
    inner iterations, and the
    preconditioner actually used."""
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.solve.api import (TWO_LEVEL_MIN_VERTICES,
                                             compute_velocity_fields)
    pot, times, _ = synthetic.two_source_movie(
        mesh, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=n_frames,
        speed=24.0, wavelength=24.0, dt=1.0 / 512.0, dtype=np.float64,
    )
    precond = ("two_level_full" if mesh.n_vertices >= TWO_LEVEL_MIN_VERTICES
               else "jacobi")

    def step(p, t):
        return compute_velocity_fields(
            mesh, p, t, lambda_=0.01, method="refined", tol=tol,
            max_iter=4000)

    run = jax.jit(lambda p, t: step(p, t).v_k)
    potd, timesd = jnp.asarray(pot), jnp.asarray(times)
    best = _time_program(run, potd, timesd, repeats=2)
    res = step(potd, timesd)
    out = {
        "fps_12k": round((n_frames - 1) / best, 2),
        "iters_12k": int(res.iterations),
        "precond_12k": precond,
        "converged_12k": bool(np.all(np.asarray(res.converged))),
        "n_vertices_12k": mesh.n_vertices,
    }
    # Accuracy at scale: SuperLU parity on a 2-frame sample (the full
    # 12.5k x 97-frame direct solve takes minutes on the host).
    v_cpu, _ = bench_cpu_baseline(mesh, pot, times, n_sample=2)
    scale = max(np.abs(v_cpu).max(), 1e-30)
    v_got = np.asarray(res.v_k[:2], np.float64)
    out["rmse_12k"] = float(
        np.sqrt(np.mean((v_got - v_cpu) ** 2)) / scale)
    return out


def bench_long_movie(mesh, n_frames=392, tol=1e-6, mesh12=None):
    """The long-trial regime: the reference's real trials
    span ~98-391 frames (S2_interpolate.py:109-110 window->frames math)
    while every other entry here uses T=97. Exercises, at T=391: the
    (T, 2N) solve iterate, the flat (T*N) streamline id space + adaptive
    escalation, and the (U, T, N) winding grid's center-axis chunking
    (whose chunk arithmetic at T=391 sits near _GRID_MAX_ELEMS — pinned by
    tests/test_ops_analysis.py). `mesh12` adds a solve-only smoke at the
    12.5k mesh."""
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.ops import singularity as sing_ops
    from manifold_flow_tpu.ops import streamline as stream_ops
    from manifold_flow_tpu.ops import winding as wind_ops
    from manifold_flow_tpu.ops.recombine import velocity_to_world
    from manifold_flow_tpu.solve.api import compute_velocity_fields

    pot, times, _ = synthetic.two_source_movie(
        mesh, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=n_frames,
        speed=24.0, wavelength=24.0, dt=1.0 / 512.0, dtype=np.float64)
    t = n_frames - 1

    def step(p, tt):
        return compute_velocity_fields(
            mesh, p, tt, lambda_=0.01, method="refined", tol=tol,
            max_iter=4000)

    run = jax.jit(lambda p, tt: step(p, tt).v_k)
    potd, timesd = jnp.asarray(pot), jnp.asarray(times)
    best = _time_program(run, potd, timesd, repeats=2)
    res = step(potd, timesd)
    out = {
        "fps_391": round(t / best, 2),
        "iters_391": int(res.iterations),
        "converged_391": bool(np.all(np.asarray(res.converged))),
    }

    v = jnp.asarray(velocity_to_world(res.v_k, mesh.basis), jnp.float32)

    def trace(vv):
        return stream_ops.trace_frames_adaptive(mesh, vv, max_steps=256)

    jax.block_until_ready(trace(v))
    best_s = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(trace(v))
        best_s = min(best_s, time.perf_counter() - t0)
    out["streamline_fps_391"] = round(t / best_s, 2)

    field = jax.jit(lambda vv: sing_ops.detect(mesh, vv))(v)
    cap = sing_ops.compact_capacity(field)
    det = sing_ops.compact_detected(mesh, field, capacity=cap)
    pts_arr = np.zeros((t, cap, 3), np.float32)
    valid = np.zeros((t, cap), bool)
    centers = np.zeros((t, cap), np.int32)
    mpts = np.asarray(mesh.points)
    vid = np.asarray(det.vertex_ids)
    vok = np.asarray(det.vertex_valid)
    iok = np.asarray(det.interior_valid)
    ipts = np.asarray(det.interior_points)
    icent = np.asarray(det.interior_centers)
    for k in range(t):
        rows = list(mpts[vid[k][vok[k]]]) + list(ipts[k][iok[k]])
        cent = list(vid[k][vok[k]]) + list(icent[k][iok[k]])
        rows, cent = rows[:cap], cent[:cap]
        if rows:
            pts_arr[k, : len(rows)] = np.stack(rows)
            valid[k, : len(rows)] = True
            centers[k, : len(cent)] = cent

    def wind(vv):
        return wind_ops.analyze_singularities_movie(
            mesh, vv, pts_arr, valid, max_level=25, centers=centers)

    out["winding_fps_391"] = round(t / _time_program(wind, v), 2)
    out["winding_unique_391"] = int(len(np.unique(centers[valid])))

    if mesh12 is not None:
        # 12.5k smoke: T*N = 391 * 12544 leaves the winding grid chunk at
        # exactly 8 centers (its floor); the solve proves the long iterate.
        pot12, times12, _ = synthetic.two_source_movie(
            mesh12, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=n_frames,
            speed=24.0, wavelength=24.0, dt=1.0 / 512.0, dtype=np.float64)

        def step12(p, tt):
            return compute_velocity_fields(
                mesh12, p, tt, lambda_=0.01, method="refined", tol=tol,
                max_iter=4000)

        run12 = jax.jit(lambda p, tt: step12(p, tt).v_k)
        p12, t12 = jnp.asarray(pot12), jnp.asarray(times12)
        best12 = _time_program(run12, p12, t12, repeats=1)
        out["fps_391_12k"] = round(t / best12, 2)
    return out


def bench_trial(mesh, pot, times, steady_repeats: int = 2):
    """Wall-clock of ONE production trial through the batch driver — all
    device stages (flow, decompose, wavespeed, streamline, winding) against
    a reference-layout results tree, including artifact IO and the padded
    shape-bucketed mesh path. This is the cohort sweep's unit of work, and
    it exercises the real pipeline (not op-level calls) on the device. The
    first, untimed run absorbs compiles and writes the artifacts; the timed
    run uses overwrite=True so the number reflects
    steady-state cohort throughput; a third run must skip everything
    (resume-by-artifact-presence)."""
    import json as _json
    import tempfile
    from pathlib import Path

    from manifold_flow_tpu.pipeline import batch
    from manifold_flow_tpu.pipeline.config import PipelineConfig
    from manifold_flow_tpu.utils import io as mio

    # Sidecar sampling frequency derived from the movie's own time base so
    # the trial computes at the same dt as the headline solver benches.
    sfreq = float(1.0 / (np.asarray(times)[1] - np.asarray(times)[0]))
    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        subj = root / "sub-01"
        td = subj / "run-001" / "T1"
        td.mkdir(parents=True)
        mio.write_ply(subj / "sub-01_reconstructed_surface.ply",
                      np.asarray(mesh.points), np.asarray(mesh.triangles))
        (subj / "sub-01_ieeg.json").write_text(
            _json.dumps({"SamplingFrequency": sfreq}))
        mio.save_indexed_csv(td / "sub_task-interpolation_data.csv",
                             np.asarray(pot))
        mio.save_indexed_csv(td / "sub_task-interpolation_phases_data.csv",
                             np.angle(np.exp(1j * np.asarray(pot))))
        trial = batch.discover_trials(root)[0]
        cfg = PipelineConfig()
        cache: dict = {}
        batch.run_trial(trial, cfg, mesh_cache=cache)  # compile + warmup
        # Second streamline-only warmup: the first trace of a mesh records
        # its walk-length stats and the SECOND compiles the stats-planned
        # window schedule (ops.streamline._plan_windows) — without this the
        # planned-schedule compile would land inside the timed trial.
        batch.run_trial(trial, cfg, stages=("streamline",), overwrite=True,
                        mesh_cache=cache)

        # Per-stage wall times + the flow sub-breakdown come straight from
        # run_trial's timings dict (recorded facts, not scraped log lines).
        # The movie arrives pre-parsed, as it does for every trial but the
        # first of a cohort sweep (run_batch prefetches trial i+1's CSV
        # while trial i computes) — this bench reports steady-state cohort
        # throughput, and the lone cold parse is a one-off.
        movie_pre = mio.load_indexed_csv(trial.movie_path)
        stage_walls: dict = {}
        t0 = time.perf_counter()
        res = batch.run_trial(trial, cfg, overwrite=True,
                              mesh_cache=cache, timings=stage_walls,
                              movie_data=movie_pre)
        dt = time.perf_counter() - t0
        flow_detail = stage_walls.pop("flow_detail", {})
        stream_detail = stage_walls.pop("streamline_detail", {})
        res3 = batch.run_trial(trial, cfg, mesh_cache=cache)

        # Steady-state cohort rate: THREE trials through run_batch's
        # sweep-shared writer (each trial's artifact serialization overlaps
        # the next trial's device compute; the final drain is included and
        # amortized) with the movie prefetch active and the mesh objects
        # persisted across calls (mesh_cache — the per-mesh compiled
        # programs key on identity) — the per-trial cost a long cohort
        # actually pays.
        for name in ("T2", "T3"):
            tdn = td.parent / name
            tdn.mkdir(exist_ok=True)
            for f in td.glob("*interpolation*data.csv"):
                (tdn / f.name).write_bytes(f.read_bytes())
        batch.run_batch(root, cfg, overwrite=True,
                        mesh_cache=cache)  # warmup; reuses the trial mesh
        # Best of `steady_repeats` timed sweeps (the compile-heavy 12.5k
        # variant runs a single sweep).
        steady = np.inf
        steady_ok = True
        for _ in range(steady_repeats):
            t0 = time.perf_counter()
            rep = batch.run_batch(root, cfg, overwrite=True,
                                  mesh_cache=cache)
            steady = min(steady, (time.perf_counter() - t0) / 3)
            steady_ok = steady_ok and rep["errors"] == {} \
                and len(rep["trials"]) == 3

        return {
            "trial_seconds": round(dt, 2),
            "trial_steady_seconds": round(steady, 2),
            "trial_steady_ok": steady_ok,
            "trial_stage_seconds": {k: round(v, 2)
                                    for k, v in stage_walls.items()},
            "trial_flow_detail": {k: round(v, 3)
                                  for k, v in flow_detail.items()},
            "trial_streamline_detail": {k: round(v, 3)
                                        for k, v in stream_detail.items()},
            "trial_drain_seconds": round(
                max(0.0, dt - sum(stage_walls.values())), 2),
            "trial_ok": all(v == "done" for v in res.values()),
            "trial_resume_ok": all(v == "skipped" for v in res3.values()),
        }


def bench_cpu_baseline(mesh, pot, times, n_sample=6):
    """Frames/s of the vectorized scipy oracle (assembly + spsolve)."""
    from tests.oracle import reference_impl as ref

    points = np.asarray(mesh.points)
    triangles = np.asarray(mesh.triangles)
    normals = np.asarray(mesh.normals)
    e = ref.orthonormal_basis_np(normals)
    grad_w = ref.hat_gradients_np(points, triangles)
    areas = ref.triangle_areas_np(points, triangles)
    a2 = ref.assemble_a2_np(triangles, areas, e, grad_w)

    from scipy.sparse.linalg import spsolve

    sols = []
    t0 = time.perf_counter()
    for k in range(n_sample):
        a1, f = ref.assemble_frame_np(
            pot[k], pot[k + 1], times[k + 1] - times[k],
            triangles, grad_w, e, areas)
        sols.append(spsolve((a1 + 0.01 * a2).tocsr(), f))
    dt = time.perf_counter() - t0
    return np.stack(sols), n_sample / dt


def main():
    import jax

    from manifold_flow_tpu.utils.compile_cache import configure_compile_cache

    jax.config.update("jax_enable_x64", True)
    # 8 virtual CPU devices alongside the GPU backend (set before the first
    # backend init): the scaling-retention bench runs the frame-sharded
    # solve on a CPU device mesh in this same process.
    jax.config.update("jax_num_cpu_devices", 8)
    configure_compile_cache()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU backend; got {dev.platform!r}")
    mesh, pot, times = build_problem()

    dtype = np.float64  # refined path: f32 inner CG + f64 residual outer loop
    v_dev, fps_dev, res = bench_device(mesh, pot, times, dtype)

    n_sample = 6
    v_cpu, fps_cpu = bench_cpu_baseline(mesh, pot, times, n_sample=n_sample)

    scale = max(np.abs(v_cpu).max(), 1e-30)
    rmse = float(np.sqrt(np.mean(
        (v_dev[:n_sample].astype(np.float64) - v_cpu) ** 2)) / scale)

    # Analysis-stage + end-to-end throughput: every stage of the capability
    # surface on the device, not just the hot solve.
    from manifold_flow_tpu.ops.recombine import velocity_to_world

    v_world = np.asarray(velocity_to_world(v_dev, np.asarray(mesh.basis)))
    stages = {}
    stages.update(bench_analysis_stages(mesh, v_world))
    stages.update(bench_field_stages(mesh, pot, v_dev))
    s3_fps = bench_end_to_end_s3(mesh, pot, times)

    # Hardware yardsticks + achieved-vs-ceiling floor fractions, and the
    # large-mesh (two-level preconditioner) regime.
    extras = {}
    n_frames = pot.shape[0] - 1
    yard = bench_yardsticks(chase_size=n_frames * mesh.n_vertices)
    extras.update({k: round(val, 2) for k, val in yard.items()})
    floors = floor_fractions(
        mesh, n_frames, iters=int(res.iterations),
        outer_steps=int(res.outer_steps), yard=yard,
        solve_time_s=n_frames / fps_dev,
        streamline_time_s=n_frames / stages["streamline_fps"],
        winding_time_s=n_frames / stages["winding_fps"],
        winding_unique=stages["winding_unique_centers"],
        stream_window=stages.get("streamline_plan_w1", 16),
        stream_retrace_k=stages["streamline_retrace_k"],
        stream_retrace_w=stages["streamline_retrace_w"],
        stream_pipelined=stages.get("streamline_plan_cap", 0) > 0)
    extras.update({k: round(val, 3) for k, val in floors.items()})
    mesh12 = _mesh_12k()
    extras.update(bench_scale_12k(mesh12))
    # Multi-device scaling evidence: bytes-based mesh-axis model at the
    # 12.5k production scale + measured frame-axis retention on the
    # virtual CPU mesh.
    extras.update(bench_scaling(mesh12, hbm_gbps=yard["axpy_gbps"]))
    # Long-trial regime: solve + streamline + winding at the reference's
    # upper frame count T=391.
    extras.update(bench_long_movie(mesh, mesh12=mesh12))
    extras.update(bench_trial(mesh, pot, times))
    # Scale-regime trial: the SAME end-to-end batch trial at the 12.5k
    # two-level mesh, where the gather/sort-bound analysis ops scale
    # differently than the solve.
    from manifold_flow_tpu.geometry import synthetic as _synth

    pot12, times12, _ = _synth.two_source_movie(
        mesh12, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=98,
        speed=24.0, wavelength=24.0, dt=1.0 / 512.0, dtype=np.float64)
    tr12 = bench_trial(mesh12, pot12, times12, steady_repeats=1)
    for k in ("trial_seconds", "trial_steady_seconds", "trial_steady_ok",
              "trial_stage_seconds", "trial_flow_detail",
              "trial_streamline_detail", "trial_drain_seconds"):
        extras[f"{k}_12k"] = tr12[k]
    extras["trial_12k_ok"] = tr12["trial_ok"]

    headline = {
        "metric": "optical_flow_frames_per_sec_per_device",
        "value": round(fps_dev, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps_dev / fps_cpu, 2),
        "cpu_baseline_fps": round(fps_cpu, 2),
        "rmse_vs_spsolve_normalized": rmse,
        "converged": bool(np.all(np.asarray(res.converged))),
        "cg_iterations": int(res.iterations),
    }
    print(json.dumps({
        **headline,
        "s3_end_to_end_fps": round(s3_fps, 2),
        **{k: (round(val, 2) if isinstance(val, float) else val)
           for k, val in stages.items()},
        **extras,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "n_vertices": mesh.n_vertices,
        "n_frames": pot.shape[0] - 1,
        "dtype": np.dtype(dtype).name,
    }))
    # Compact headline LAST: a reader of the output's tail always gets the
    # headline plus the key comparables even if the full line is cut.
    for k in ("solve_bw_frac", "fps_12k", "rmse_12k", "trial_steady_seconds",
              "trial_steady_seconds_12k", "streamline_gather_frac",
              "fps_391"):
        if k in extras:
            headline[k] = extras[k]
    print(json.dumps(headline))


if __name__ == "__main__":
    main()
