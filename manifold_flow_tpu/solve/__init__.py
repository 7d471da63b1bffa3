"""Linear solvers for the per-frame FEM systems.

Replaces the reference's `scipy.sparse.linalg.spsolve` under a
`multiprocessing.Pool` (utils/compute_optical_flow.py:143-194) with batched
device paths:

  * `cg`       — batched matrix-free preconditioned conjugate gradients over
                 all frames simultaneously (block-Jacobi 2x2 preconditioner);
  * `cholesky` — batched dense Cholesky with mixed-precision iterative
                 refinement (small meshes; exact to working precision);
  * `refined`  — f32 inner PCG + native f64 residuals (solve.refine):
                 direct-solver accuracy from f32 inner iterations.

The iterative paths use a two-level preconditioner by default (solve.coarse):
block-Jacobi smoothing plus an aggregation coarse-grid correction applied as
one batched dense matvec per iteration.
"""

from manifold_flow_tpu.solve.api import compute_velocity_fields
from manifold_flow_tpu.solve.cg import solve_cg
from manifold_flow_tpu.solve.cholesky import solve_cholesky
from manifold_flow_tpu.solve.coarse import build_tables, make_two_level
from manifold_flow_tpu.solve.refine import solve_refined

__all__ = ["compute_velocity_fields", "solve_cg", "solve_cholesky",
           "solve_refined", "build_tables", "make_two_level"]
