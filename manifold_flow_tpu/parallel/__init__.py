"""Multi-device parallelism over a ('frames', 'mesh') device mesh.

The reference's only parallelism is a single-host multiprocessing.Pool over
frames (utils/compute_optical_flow.py:152-194, SURVEY.md §2 P1). Here:

  * 'frames' axis — pure data parallelism: frames are independent linear
    systems; zero communication.
  * 'mesh' axis — vertices partition into owned blocks with halo exchange
    (parallel.halo): each device holds only its block's DOF/iterate/
    preconditioner rows (~2N / n_mesh + halo) and the per-matvec collective
    is an all_gather of block-boundary values, not a full-DOF psum. Works
    for both the f32/f64 CG path and the refined path.
"""

from manifold_flow_tpu.parallel.analysis import (
    sharded_detect,
    sharded_wave_velocity,
    sharded_winding_movie,
)
from manifold_flow_tpu.parallel.halo import (
    build_partition,
    halo_compute_velocity_fields,
    halo_refined_velocity_fields,
)
from manifold_flow_tpu.parallel.partition import (
    make_device_mesh,
    sharded_compute_velocity_fields,
)
from manifold_flow_tpu.parallel.scaling import (
    halo_comm_stats,
    measure_scaling,
    predicted_efficiency,
)

__all__ = [
    "build_partition",
    "halo_comm_stats",
    "halo_compute_velocity_fields",
    "halo_refined_velocity_fields",
    "make_device_mesh",
    "measure_scaling",
    "predicted_efficiency",
    "sharded_compute_velocity_fields",
    "sharded_detect",
    "sharded_wave_velocity",
    "sharded_winding_movie",
]
