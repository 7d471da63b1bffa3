"""manifold_flow_tpu — JAX framework for manifold-based optical flow.

A JAX/XLA framework with the capabilities of
`SEU-dynamical-models/Manifold-based-optical-flow-method` (the reference is a
pure-Python staged pipeline; see /root/repo/SURVEY.md): variational optical
flow on triangulated 2-manifolds via P1 finite elements, plus the downstream
vector-field analyses (singularity detection/classification, spatiotemporal
SVD, wave speeds, streamlines, winding numbers) — all designed for a
batched accelerator (GPU) first:

* one canonical geometry layer (the reference duplicates its basis /
  projection helpers across five files, SURVEY.md §2 "Duplication");
* triangle-batched gather/scatter FEM operators instead of scipy LIL
  assembly (reference: utils/compute_optical_flow.py:27-149);
* a batched matrix-free preconditioned-CG solve with frames on a batch
  axis instead of `multiprocessing.Pool` + per-frame SuperLU
  (reference: utils/compute_optical_flow.py:152-194);
* `vmap`-able analysis ops with fixed shapes and masked ragged outputs;
* `jax.sharding` device-mesh parallelism over ('frames', 'mesh') axes.
"""

from manifold_flow_tpu import (
    fem,
    geometry,
    kernels,
    ops,
    parallel,
    pipeline,
    solve,
    utils,
    viz,
)
from manifold_flow_tpu.geometry.mesh import TriMesh
from manifold_flow_tpu.solve.api import compute_velocity_fields

__version__ = "0.1.0"

__all__ = [
    "TriMesh",
    "compute_velocity_fields",
    "fem",
    "geometry",
    "kernels",
    "ops",
    "parallel",
    "pipeline",
    "solve",
    "utils",
    "viz",
]
