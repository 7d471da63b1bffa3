"""Scatter-free batched segment reduction for fixed-topology FEM assembly.

Written for an accelerator whose XLA lowered scatter-add to a serialized
per-index loop; whether it still beats `zeros.at[idx].add(vals)` /
`jax.ops.segment_sum` on the GPU is ROADMAP C3. It replaces scatter with
the standard sorted-COO two-stage reduction, expressed entirely as static
gathers + dense reshape-sums (deterministic summation order):

  1. Host-side (once per mesh): sort the contribution indices; pad each
     output slot's run of contributions to a multiple of `group`; record
     (a) the permutation that lays contributions out in padded sorted order,
     (b) for each output slot, which contiguous groups belong to it.
  2. Device-side (per call, batched over frames): one gather into padded
     sorted order, a reshape-(T, G, group)-sum, one small gather of group
     partials per slot, and a final gather that densifies unique slots into
     the requested output length.

The same plan machinery serves any fixed-topology scatter-add in the
framework (coarse-matrix assembly, and as a drop-in for RHS/diagonal
assembly when those show up in profiles).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """Static gather tables realizing `out[s] = sum(vals[flat_idx == s])`.

    pad_perm     (L,)      contribution index per padded-sorted position
                           (n_vals = "zero" sentinel for padding)
    slot_groups  (U, Kg)   group ids per unique output slot (n_groups pads)
    dense_gather (n_out,)  unique-slot position per dense output element
                           (U = "zero" sentinel for empty slots)
    """

    pad_perm: jnp.ndarray
    slot_groups: jnp.ndarray
    dense_gather: jnp.ndarray
    n_vals: int = dataclasses.field(default=0, metadata=dict(static=True))
    group: int = dataclasses.field(default=8, metadata=dict(static=True))


def build_reduce_plan(flat_idx: np.ndarray, n_out: int,
                      group: int = 8) -> ReducePlan:
    """Build a ReducePlan on the host from int contribution targets.

    Args:
      flat_idx: (V,) target output element per contribution (0 <= idx < n_out).
      n_out: dense output length.
      group: stage-1 reduction width (8 = one f32 sublane).
    """
    pad_perm, slot_groups, dense_gather, n_vals = build_reduce_plan_np(
        flat_idx, n_out, group)
    return ReducePlan(
        pad_perm=jnp.asarray(pad_perm),
        slot_groups=jnp.asarray(slot_groups),
        dense_gather=jnp.asarray(dense_gather),
        n_vals=n_vals,
        group=group,
    )


def build_reduce_plan_np(flat_idx: np.ndarray, n_out: int, group: int = 8):
    """Numpy guts of build_reduce_plan — cacheable across traces.

    Returns (pad_perm, slot_groups, dense_gather, n_vals) as numpy arrays;
    callers that cache plans must cache these (not jnp arrays, which would
    pin tracers/constants of a specific trace).
    """
    flat_idx = np.asarray(flat_idx).reshape(-1)
    n_vals = int(flat_idx.shape[0])
    order = np.argsort(flat_idx, kind="stable")
    uniq, counts = np.unique(flat_idx, return_counts=True)
    padded = -(-counts // group) * group            # per-slot padded lengths
    total = int(padded.sum())
    pad_perm = np.full(total, n_vals, dtype=np.int32)
    src_off = np.concatenate([[0], np.cumsum(counts)])
    dst_off = np.concatenate([[0], np.cumsum(padded)])
    for i in range(uniq.shape[0]):
        pad_perm[dst_off[i]: dst_off[i] + counts[i]] = (
            order[src_off[i]: src_off[i + 1]])
    n_groups_per = padded // group
    n_groups = int(n_groups_per.sum())
    kg = max(int(n_groups_per.max()), 1)
    slot_groups = np.full((uniq.shape[0], kg), n_groups, dtype=np.int32)
    goff = np.concatenate([[0], np.cumsum(n_groups_per)])
    for i in range(uniq.shape[0]):
        slot_groups[i, : n_groups_per[i]] = np.arange(goff[i], goff[i + 1])
    dense_gather = np.full(n_out, uniq.shape[0], dtype=np.int32)
    dense_gather[uniq] = np.arange(uniq.shape[0], dtype=np.int32)
    return pad_perm, slot_groups, dense_gather, n_vals


def apply_reduce(plan: ReducePlan, vals: jnp.ndarray) -> jnp.ndarray:
    """Batched dense segment sum: vals (..., V) -> (..., n_out)."""
    lead = vals.shape[:-1]
    v = vals.reshape(-1, vals.shape[-1])
    t = v.shape[0]
    zero = jnp.zeros((t, 1), dtype=v.dtype)
    vp = jnp.concatenate([v, zero], axis=1)
    s1 = jnp.take(vp, plan.pad_perm, axis=1)
    s1 = s1.reshape(t, -1, plan.group).sum(axis=-1)          # (T, n_groups)
    s1p = jnp.concatenate([s1, zero], axis=1)
    per_slot = jnp.take(s1p, plan.slot_groups, axis=1).sum(-1)  # (T, U)
    out = jnp.take(jnp.concatenate([per_slot, zero], axis=1),
                   plan.dense_gather, axis=1)                # (T, n_out)
    return out.reshape(*lead, -1)
