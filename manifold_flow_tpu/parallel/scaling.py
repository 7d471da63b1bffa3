"""Multi-device scaling accounting: measured retention + a bytes-based model.

The reference's whole distributed backend is a single-host
`multiprocessing.Pool(32)` over frames plus argv sharding across Slurm tasks
(utils/compute_optical_flow.py:152-194); BASELINE.md's third target is
>= 80% scaling efficiency at N >= 2 hosts. This framework's two axes scale
differently:

  * 'frames' (data parallel): frames are independent linear systems — the
    only collectives are the tiny per-iteration convergence dots. Model
    efficiency ~ 1.0; the measured quantity is the weak/strong throughput
    retention below.
  * 'mesh' (halo vertex blocks, parallel.halo): one all_gather of block-
    boundary values per matvec. Its cost is a BYTES question, so the
    per-device efficiency at N devices is predictable from the partition
    tables alone — `halo_comm_stats` + `predicted_efficiency` do exactly
    that, given the device-memory and link bandwidths the caller passes.

`measure_scaling` runs on a virtual CPU device mesh: its retention numbers
validate the mechanism (sharding, collectives, padding) and are bounded by
the host's physical cores. The bytes model is deliberately overlap-free
(t_comp + t_comm, no compute/comm overlap), i.e. a LOWER bound on
achievable efficiency.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

# Published H100 SXM figures (NVIDIA data sheet), for callers that want a
# prediction for that card: NVLink 900 GB/s per card = 450 GB/s each way,
# HBM3 3.35 TB/s. Measured rates belong in their place when available.
NVLINK_GBPS_H100 = 450.0
HBM_GBPS_H100 = 3350.0


@dataclass(frozen=True)
class HaloCommStats:
    """Per-matvec communication/computation accounting for one mesh-axis
    partition (all quantities per FRAME, float32, worst shard)."""

    n_shards: int
    v_owned: int            # owned vertices (max over shards)
    v_halo: int             # halo vertices (max over shards)
    b_send: int             # boundary vertices published (max over shards)
    halo_fraction: float    # b_send / v_owned — boundary-to-owned ratio
    allgather_bytes: float  # bytes of the gathered (S, 2B) buffer
    link_bytes: float       # bytes crossing each device's link per matvec
                            # (ring all_gather: (S-1)/S of the buffer)
    compute_bytes: float    # streaming bytes of one local f32 CG iteration


def halo_comm_stats(mesh, n_shards: int, dtype_bytes: int = 4
                    ) -> HaloCommStats:
    """Build (or reuse) the halo partition and account one CG iteration.

    The compute model is the solve floor model of bench.floor_fractions
    restricted to one shard: per frame and iteration the matvec streams
    3*Ml*6 (gathered x, g tables, local products) + 2*Vo*C (the two
    reduction gathers) elements, and the vector recurrences 16*(2*Vo) more
    (x/r/z/p updates, 2x2 precond blocks, convergence dot).
    """
    from manifold_flow_tpu.parallel.halo import build_partition

    part = build_partition(mesh, n_shards)
    vo, vh, b = part.v_owned, part.v_halo, part.b_send
    ml = part.m_local
    c = int(part.base6.shape[2])
    # all_gather buffer: every shard publishes (2, B); each device ends up
    # holding (S, 2, B). A ring/bidirectional all_gather moves (S-1)/S of
    # the final buffer through each device's links.
    buffer_elems = n_shards * 2 * b
    link_elems = (n_shards - 1) * 2 * b
    v_local2 = 2 * vo
    compute_elems = 3 * ml * 6 + 2 * vo * c + 16 * v_local2
    return HaloCommStats(
        n_shards=n_shards, v_owned=vo, v_halo=vh, b_send=b,
        halo_fraction=b / max(vo, 1),
        allgather_bytes=float(buffer_elems * dtype_bytes),
        link_bytes=float(link_elems * dtype_bytes),
        compute_bytes=float(compute_elems * dtype_bytes))


def predicted_efficiency(stats: HaloCommStats, *, hbm_gbps: float,
                         link_gbps: float) -> float:
    """Per-device efficiency of the mesh-sharded solve at the given device
    memory and link bandwidths (GB/s, one direction), both required.

    Overlap-free serial model: each iteration takes
    t = compute_bytes / HBM + link_bytes / link, and efficiency is the
    compute fraction. Both terms scale linearly in frames, so the frame
    count cancels. Collective latency is ignored — stated so the number
    reads as a bandwidth argument, not a measurement."""
    t_comp = stats.compute_bytes / (hbm_gbps * 1e9)
    t_comm = stats.link_bytes / (link_gbps * 1e9)
    return t_comp / (t_comp + t_comm)


def _cpu_devices(n: int):
    import jax

    devs = jax.devices("cpu")
    if len(devs) < n:
        raise RuntimeError(
            f"virtual CPU mesh has {len(devs)} devices, need {n} "
            "(set jax_num_cpu_devices before backend init)")
    return devs[:n]


def _time_solve(mesh, pot, times, dm, tol, repeats=2):
    import jax
    import jax.numpy as jnp

    from manifold_flow_tpu.parallel import sharded_compute_velocity_fields

    # Pin the CPU default device: in a process whose default backend is an
    # accelerator, an unpinned jnp.asarray would place the movie there only
    # to copy it back for the CPU device mesh.
    with jax.default_device(dm.devices.flat[0]):
        potd, timesd = jnp.asarray(pot), jnp.asarray(times)

        def run():
            return sharded_compute_velocity_fields(
                mesh, potd, timesd, dm, lambda_=0.01, tol=tol,
                max_iter=2000).v_k

        jax.block_until_ready(run())  # compile + warmup
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            best = min(best, time.perf_counter() - t0)
    return (pot.shape[0] - 1) / best


def measure_scaling(n_devices=(1, 2, 4, 8), frames_per_device: int = 8,
                    nx: int = 24, tol: float = 1e-5) -> dict:
    """Frame-sharded throughput retention on the virtual CPU device mesh.

    Weak scaling: per-device frame count fixed (total problem grows with N);
    retention = fps(N) / (N * fps(1)). Strong scaling: total frame count
    fixed at frames_per_device * max(N); retention = fps(N) / (N * fps(1)).
    Retention beyond the host's physical core count is core-bound — the
    numbers validate the distributed mechanism and carry the core count
    for honest reading."""
    import os

    import jax

    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.parallel import make_device_mesh

    mesh = synthetic.plane_patch(
        nx=nx, ny=nx, lx=10.0, ly=10.0,
        height=lambda x, y: 0.3 * np.sin(0.8 * x) * np.cos(0.6 * y),
        dtype=np.float64)
    out = {"physical_cores": os.cpu_count(),
           "n_vertices": mesh.n_vertices,
           "frames_per_device": frames_per_device}
    n_max = max(n_devices)
    weak_fps = {}
    strong_fps = {}
    for n in sorted(n_devices):
        dm = make_device_mesh(n, 1, devices=_cpu_devices(n))
        pot_w, times_w, _ = synthetic.two_source_movie(
            mesh, n_frames=frames_per_device * n + 1, dtype=np.float64)
        weak_fps[n] = _time_solve(mesh, pot_w, times_w, dm, tol)
        pot_s, times_s, _ = synthetic.two_source_movie(
            mesh, n_frames=frames_per_device * n_max + 1, dtype=np.float64)
        strong_fps[n] = _time_solve(mesh, pot_s, times_s, dm, tol)
    # Retention relative to PER-DEVICE throughput at the smallest measured
    # device count (eff(n) = (fps(n)/n) / (fps(n0)/n0)): with n0 = 1 this
    # is the documented fps(N)/(N*fps(1)); for a baseline-free call (no
    # 1-device entry) it still reads 1.0 at n0 instead of 1/n0.
    n0 = min(n_devices)
    base_w = weak_fps[n0] / n0
    base_s = strong_fps[n0] / n0
    out["weak_fps"] = {str(n): round(v, 2) for n, v in weak_fps.items()}
    out["strong_fps"] = {str(n): round(v, 2) for n, v in strong_fps.items()}
    out["weak_eff"] = {str(n): round(weak_fps[n] / n / base_w, 3)
                       for n in weak_fps}
    out["strong_eff"] = {str(n): round(strong_fps[n] / n / base_s, 3)
                         for n in strong_fps}
    return out
