"""FEM layer: triangle-batched assembly and matrix-free operators.

Batched replacement for the reference's scipy LIL assembly + per-frame
sparse matrices (utils/compute_optical_flow.py:27-149): the operator
A_k = a1_k + lambda * a2 is represented by precomputed per-triangle 6x6
blocks (a2) plus per-frame rank-structured factors (a1), applied by
gather -> local contraction -> segment-sum scatter.
"""

from manifold_flow_tpu.fem.assembly import (
    a2_blocks,
    local_dof_indices,
    frame_factors,
    rhs_vector,
    dense_a2,
    diag_blocks,
)
from manifold_flow_tpu.fem.operator import FlowOperator, make_operator

__all__ = [
    "a2_blocks",
    "local_dof_indices",
    "frame_factors",
    "rhs_vector",
    "dense_a2",
    "diag_blocks",
    "FlowOperator",
    "make_operator",
]
