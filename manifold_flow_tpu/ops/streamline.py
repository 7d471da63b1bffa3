"""Streamline extraction: greedy tangent-projected walks on the mesh graph.

Batched redesign of S6_streamline.py:17-138: all N seed vertices advance in
lockstep through a fixed number of masked steps (`lax.scan` + `vmap`) instead
of per-seed Python `while True` loops with PyVista topology calls.

Walk rule per step (extract_static_streamline_dot_product, S6:51-138):
  * project the edges to all 1-ring neighbors onto the current vertex's
    tangent plane, normalize, and pick the neighbor maximizing the dot
    product with the (unprojected) local velocity;
  * interior vertices (>= 6 incident cells) advance if the best dot is
    positive and the neighbor was not already visited;
  * boundary vertices additionally require either >= 2 shared cells with the
    chosen neighbor, or — when only one cell is shared — that the velocity
    direction (expressed on the basis) lies strictly inside the shared
    triangle mapped to the tangent plane (S6:100-133).

Deviation (documented, deliberate): the reference's single-shared-cell test
passes vertex *indices* where coordinates are expected and reverses one
argument pair (S6:115-117), producing numerically meaningless (though
deterministic) triangle coordinates; we implement the intended geometry
(B - A and C - A expressed in the tangent basis) by default. Passing
`quirks=True` (config `reference_quirks`) reproduces the reference's
index-arithmetic bit-for-bit so S6 artifacts can be cross-validated against
reference outputs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from manifold_flow_tpu.geometry.mesh import PAD_INDEX, TriMesh
from manifold_flow_tpu.geometry.tangent import (
    express_on_basis,
    position_diff_on_basis,
    project_to_plane,
)


class Streamlines(NamedTuple):
    vertices: jnp.ndarray  # (S, L+1) visited vertex ids, PAD_INDEX beyond length
    lengths: jnp.ndarray   # (S,) number of points in each streamline
    # Adaptive-tracer overlay: walks longer than the first-pass window are
    # re-traced compactly (a few % of seeds); their full rows live here
    # instead of widening the whole (S, L+1) array. `overlay_ids` are seed
    # indices into the flattened leading axes; `overlay_vertices` rows are
    # LOCAL vertex ids, wider than `vertices`. compact() consults them.
    overlay_ids: object | None = None       # (K,) int
    overlay_vertices: object | None = None  # (K, L2+1) int


# First-repeat detection strategy crossover (see trace): all-pairs compare
# up to this window, composite-key sort beyond. The pairwise (rows, W, W)
# compare volume grows quadratically and overtakes the sort's ~log^2 W
# passes somewhere between 64 and 96. With the two-pass adaptive tracer
# (initial window 16), the full-seed first pass and the common 64-step
# compact retrace both take the pairwise path; only 128+-step escalations
# sort. The value was chosen on an earlier accelerator and awaits
# re-tuning on the GPU (ROADMAP C7).
PAIRWISE_MAX_WINDOW = 72


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _shared_cells(cells_a, cells_b):
    """Number of common incident cells and the first common cell id."""
    va = cells_a != PAD_INDEX
    eq = (cells_a[:, None] == cells_b[None, :]) & va[:, None] & (
        cells_b != PAD_INDEX)[None, :]
    match_a = jnp.any(eq, axis=1)
    count = jnp.sum(match_a)
    first = jnp.where(
        jnp.any(match_a),
        cells_a[jnp.argmax(match_a)],
        PAD_INDEX,
    )
    return count, first


def _scalar_posdiff(s, e1, e2):
    """position_diff_on_basis_with_origin evaluated on SCALAR args — the
    reference's single-shared-cell bug (S6:115-117) passes vertex indices
    where coordinates are expected, so B_relative = B - A is a scalar and
    numpy broadcasting yields proj = s - s * n^2 / |n|^2 elementwise."""
    n = jnp.cross(e1, e2)
    proj = s - s * (n * n) / jnp.sum(n * n)
    return jnp.stack([jnp.sum(proj * e1), jnp.sum(proj * e2)])


def _boundary_triangle_test(mesh: TriMesh, cur, cand, cell, e1, e2, vel,
                            quirks: bool = False):
    """Single-shared-cell orientation test (S6:100-133).

    quirks=False: the intended geometry (corner coordinate differences on
    the tangent basis). quirks=True: the reference's exact index arithmetic
    (vertex ids fed to position_diff_on_basis_with_origin, and the reversed
    (C, A) argument pair), reproduced for artifact parity.
    """
    tri = mesh.triangles[cell]
    # Reorder so A == cur (the reference's corner swap, S6:103-113).
    a = cur
    b = jnp.where(tri[0] == cur, tri[1], jnp.where(tri[1] == cur, tri[0], tri[1]))
    c = jnp.where(tri[2] == cur, tri[0], tri[2])
    if quirks:
        dt = e1.dtype
        p1 = _scalar_posdiff((b - a).astype(dt), e1, e2)
        p2 = _scalar_posdiff((a - c).astype(dt), e1, e2)
    else:
        p1 = position_diff_on_basis(mesh.points[a], mesh.points[b], e1, e2)
        p2 = position_diff_on_basis(mesh.points[a], mesh.points[c], e1, e2)
    orient = _cross2(p1, p2)
    # Counter-clockwise order (clockwise(), S6:204-219); collinear -> reject.
    pb = jnp.where(orient >= 0, p1, p2)
    pc = jnp.where(orient >= 0, p2, p1)
    v2 = express_on_basis(vel, e1, e2)
    pa = jnp.zeros_like(pb)
    inside = (
        (_cross2(pb - pa, v2 - pa) > 0)
        & (_cross2(pc - pb, v2 - pb) > 0)
        & (_cross2(pa - pc, v2 - pc) > 0)
    )
    return inside & (orient != 0)


def _next_hop_tables(mesh: TriMesh, vel: jnp.ndarray, quirks: bool = False,
                     boundary=None):
    """Per-vertex next-hop candidate and static advance mask for one frame.

    The walk rule (S6:51-138) chooses the next vertex from the CURRENT vertex
    and its local velocity only — the walk history enters solely through the
    no-revisit check. So the candidate `next[v]` and every static condition
    (positive dot, interior/boundary triangle tests) can be computed ONCE for
    all N vertices, vectorized; the scan then just chases pointers.

    `boundary` optionally lists the non-interior vertex ids (padded, from
    boundary_indices): the shared-cell count and boundary-triangle test —
    all private-index chase-class gathers — only influence `advance_ok`
    where `interior` is False, so evaluating them on the boundary rows only
    drops that gather volume ~B/N-fold (typically ~7% of vertices).
    """
    e1 = mesh.basis[:, 0]                                  # (N, 3)
    e2 = mesh.basis[:, 1]
    nb = mesh.vertex_neighbors                             # (N, D)
    nb_mask = nb != PAD_INDEX
    nb_safe = jnp.where(nb_mask, nb, 0)
    vec = mesh.points[nb_safe] - mesh.points[:, None]      # (N, D, 3)
    proj = project_to_plane(vec, e1[:, None], e2[:, None])
    nrm = jnp.linalg.norm(proj, axis=-1, keepdims=True)
    unit = proj / jnp.where(nrm > 0, nrm, 1.0)
    dots = jnp.sum(unit * vel[:, None], axis=-1)           # (N, D)
    dots = jnp.where(nb_mask, dots, -jnp.inf)
    idx = jnp.argmax(dots, axis=-1)                        # (N,)
    cand = jnp.take_along_axis(nb_safe, idx[:, None], axis=-1)[:, 0]
    dmax = jnp.take_along_axis(dots, idx[:, None], axis=-1)[:, 0]

    interior = mesh.vertex_cell_count >= 6                 # (N,)
    if boundary is None:
        rows = jnp.arange(mesh.n_vertices, dtype=cand.dtype)
        cand_b, e1b, e2b, velb = cand, e1, e2, vel
    else:
        rows = boundary                                    # (B,) padded
        cand_b = cand[rows]
        e1b, e2b, velb = e1[rows], e2[rows], vel[rows]
    count, cell = jax.vmap(_shared_cells)(
        mesh.vertex_cells[rows], mesh.vertex_cells[cand_b])
    tri_ok = jax.vmap(partial(_boundary_triangle_test, quirks=quirks),
                      in_axes=(None, 0, 0, 0, 0, 0, 0))(
        mesh, rows.astype(cand.dtype), cand_b,
        jnp.maximum(cell, 0), e1b, e2b, velb)
    bnd_ok = (count >= 2) | (tri_ok & (cell != PAD_INDEX))
    if boundary is None:
        ok = interior | bnd_ok
    else:
        # Tiny (B,) scatter-OR; duplicate padded rows write the same value.
        ok = interior.at[rows].max(bnd_ok)
    advance_ok = (dmax > 0) & ok
    return cand.astype(jnp.int32), advance_ok


@partial(jax.jit, static_argnames=("max_steps", "quirks"))
def trace(mesh: TriMesh, v_world_frame: jnp.ndarray,
          max_steps: int = 128, quirks: bool = False) -> Streamlines:
    """Trace one streamline from every vertex of the mesh for one frame.

    Seeds with zero velocity produce length-1 streamlines (the caller filters
    by min length, matching S6:29 + S6:135-138). `quirks` reproduces the
    reference's single-shared-cell index bug (module docstring).

    One-frame wrapper over the batched tracer (see trace_frames): one
    jitted program per call, never eager per-op dispatch."""
    return _trace1(mesh, v_world_frame, boundary_indices(mesh),
                   max_steps=max_steps, quirks=quirks)


@partial(jax.jit, static_argnames=("max_steps", "quirks"))
def _trace1(mesh, v_world_frame, boundary, max_steps, quirks):
    sl, _ = _trace_batched(mesh, v_world_frame[None], max_steps=max_steps,
                           quirks=quirks, boundary=boundary)
    return Streamlines(vertices=sl.vertices[0], lengths=sl.lengths[0])


_BOUNDARY_CACHE: dict = {}


def boundary_indices(mesh: TriMesh):
    """Padded int32 ids of the mesh's non-interior REAL vertices (cell count
    < 6), or None when the mesh topology is traced. Cached by mesh identity
    (id-pin pattern, see solve.coarse.build_tables); padded to a multiple
    of 8 by repeating the first id so shape buckets are reused."""
    import numpy as np

    key = id(mesh.vertex_cell_count)
    entry = _BOUNDARY_CACHE.get(key)
    if entry is not None and entry[0] is mesh.vertex_cell_count:
        return entry[1]
    try:
        counts = np.asarray(mesh.vertex_cell_count)
    except Exception:  # traced mesh — callers fall back to the full path
        return None
    nv = int(mesh.valid_vertices)
    ids = np.flatnonzero(counts[:nv] < 6).astype(np.int32)
    if ids.size == 0:
        out = jnp.zeros((8,), jnp.int32)  # closed surface: inert rows
    else:
        cap = -(-ids.size // 8) * 8
        out = jnp.asarray(np.concatenate(
            [ids, np.full(cap - ids.size, ids[0], np.int32)]))
    _BOUNDARY_CACHE[key] = (mesh.vertex_cell_count, out)
    while len(_BOUNDARY_CACHE) > 8:
        _BOUNDARY_CACHE.pop(next(iter(_BOUNDARY_CACHE)))
    return out


def _hop_graph(mesh: TriMesh, v_world: jnp.ndarray, quirks: bool,
               boundary=None):
    """Fuse the T frames' next-hop tables into ONE functional graph f (T*N,)
    over global ids (frame k's vertex v = k*N + v; halting vertices are
    self-loops, so every walk is a rho-shaped path)."""
    t = v_world.shape[0]
    n = mesh.n_vertices
    next_tab, ok_tab = jax.vmap(
        lambda v: _next_hop_tables(mesh, v, quirks=quirks,
                                   boundary=boundary))(v_world)
    idx = jnp.arange(n, dtype=jnp.int32)
    f_local = jnp.where(ok_tab, next_tab, idx[None])  # halting => fixed point
    offs = (jnp.arange(t, dtype=jnp.int32) * n)[:, None]
    return (f_local + offs).reshape(-1)


def _walk_dtype(n: int, max_steps: int):
    """Narrowest int dtype for the LOCAL walk results (vertex ids < n,
    lengths <= max_steps + 1, PAD_INDEX = -1). The walk arrays cross the
    device->host boundary, so int16 halves the tracer's dominant fetch
    whenever the mesh size allows; global-id internals stay int32."""
    return (jnp.int16 if max(n, max_steps + 2) < jnp.iinfo(jnp.int16).max
            else jnp.int32)


def _double_and_detect(f: jnp.ndarray, seeds: jnp.ndarray, max_steps: int,
                       powers: tuple = ()):
    """Materialize walks for `seeds` (R,) global ids over the graph f by
    pointer doubling, and find each walk's first-repeat length.

    `powers` optionally carries already-squared jump tables
    (f^1, f^2, f^4, ...) from an earlier pass — each squaring costs a full
    (T*N,)-sized gather, so escalation retraces must not re-pay the prefix
    the first pass computed. Returns (seq (R, max_steps+1) GLOBAL ids,
    lengths (R,), powers_out); lengths is max_steps + 1 for walks that
    never repeat in-window (the escalation marker). See trace_frames for
    the algorithm rationale."""
    pows = list(powers) if powers else [f]
    seq = seeds[:, None]
    p = 1
    k = 0
    while p < max_steps:
        if k >= len(pows):
            pows.append(pows[-1][pows[-1]])
        seq = jnp.concatenate([seq, pows[k][seq]], axis=1)
        p *= 2
        k += 1
    if p == max_steps:  # one extra column for step max_steps itself
        if k >= len(pows):
            pows.append(pows[-1][pows[-1]])
        seq = jnp.concatenate([seq, pows[k][seeds][:, None]], axis=1)
    seq = seq[:, : max_steps + 1]                     # (R, L+1)

    # Walk length = first step whose vertex already occurred. For small
    # windows an all-pairs equality test (any i<j with seq[i]==seq[j]) fuses
    # into one compare+reduce — no sort passes at all; the quadratic
    # term W^2 stays cheaper than the sort's W log^2 W passes until the
    # (rows, W, W) tile volume takes over. Larger windows fall back to
    # sorting (vertex, step) pairs: steps ascend within equal-vertex runs,
    # so every non-first element of a run is a revisit; the earliest such
    # step is the rho length mu + lam (or the cap when the walk never
    # repeats in-window). Walks stay within their frame's id block, so the
    # comparisons work unchanged on global ids.
    width = max_steps + 2
    steps = jnp.arange(max_steps + 1, dtype=jnp.int32)
    if max_steps + 1 <= PAIRWISE_MAX_WINDOW:
        eq = (seq[:, :, None] == seq[:, None, :]) \
            & (steps[:, None] < steps[None, :])
        repeat_j = jnp.any(eq, axis=1)                     # (R, W)
        lengths = jnp.min(
            jnp.where(repeat_j, steps[None, :], max_steps + 1), axis=1)
    else:
        # Composite keys hold GLOBAL ids scaled by the window width, so the
        # int32 headroom is set by the id-space size, not the row count.
        if f.shape[0] * width <= jnp.iinfo(jnp.int32).max:
            key = jax.lax.sort(seq * jnp.int32(width) + steps[None, :],
                               dimension=1)
            v_sorted = key // width
            repeat = v_sorted[:, 1:] == v_sorted[:, :-1]
            s_sorted = key[:, 1:] % width
        else:  # huge movies: lexicographic two-operand sort
            v_sorted, s_all = jax.lax.sort(
                (seq, jnp.broadcast_to(steps, seq.shape)), dimension=1,
                num_keys=2)
            repeat = v_sorted[:, 1:] == v_sorted[:, :-1]
            s_sorted = s_all[:, 1:]
        lengths = jnp.min(
            jnp.where(repeat, s_sorted, max_steps + 1), axis=1)
    return seq, lengths, tuple(pows)


@partial(jax.jit, static_argnames=("n", "max_steps"))
def _trace_seeds(powers: tuple, seeds: jnp.ndarray, n: int, max_steps: int):
    """Compact retrace: walks for `seeds` (K,) global ids only, at a wider
    window, over an already-built hop graph (passed as its squared jump
    powers so the prefix squarings are not re-paid). The adaptive tracer's
    escalation pass — the few % of walks that outlived the first-pass
    window re-trace without paying the whole movie's gather volume again."""
    seq, lengths, pows = _double_and_detect(powers[0], seeds, max_steps,
                                            powers=powers)
    base = (seeds // n) * n
    seq_local = seq - base[:, None]
    slot = jnp.arange(max_steps + 1, dtype=jnp.int32)[None]
    visited = jnp.where(slot < lengths[:, None], seq_local, PAD_INDEX)
    dt = _walk_dtype(n, max_steps)
    return visited.astype(dt), lengths.astype(dt), pows


def _trace_batched(mesh: TriMesh, v_world: jnp.ndarray, max_steps: int,
                   quirks: bool, boundary=None) -> "tuple[Streamlines, tuple]":
    """All frames, all seeds, one flat id space; returns the walks plus the
    squared jump-power tables for escalation reuse.

    The next hop depends only on the current vertex, so the hop table is a
    FUNCTIONAL GRAPH (halting vertices made self-loops): every walk is a
    rho-shaped path, and the no-revisit stop (S6:39-49) fires exactly on the
    first repeated vertex. The walk sequences are materialized by POINTER
    DOUBLING — seq[:, :2^k] extends to seq[:, :2^(k+1)] through the squared
    jump table f^(2^k) — so the whole movie needs only log2(max_steps)
    sequential gather rounds instead of O(max_steps) sequential scan steps
    of tiny kernels.

    The T frames' hop tables are fused into ONE (T*N,) table over global ids
    (frame k's vertex v = k*N + v; every frame's walk stays inside its own
    block), so each doubling round is a single large flat gather rather than
    T small ones (what a per-frame vmap compiles to).
    """
    t = v_world.shape[0]
    n = mesh.n_vertices
    if t * n >= jnp.iinfo(jnp.int32).max:
        # The fused flat id space (frame k's vertex v = k*N + v) is int32:
        # overflow must fail loudly, not wrap into garbage walks. Split the
        # movie into frame chunks at this scale (>2^31 walk SEEDS in one
        # program is far beyond any single-device memory anyway).
        raise ValueError(
            f"streamline tracer: T*N = {t}*{n} overflows the int32 global id "
            "space; trace the movie in frame chunks")
    f = _hop_graph(mesh, v_world, quirks, boundary)   # (T*N,) global ids
    idxg = jnp.arange(t * n, dtype=jnp.int32)
    seq, lengths, pows = _double_and_detect(f, idxg, max_steps)

    offs = (jnp.arange(t, dtype=jnp.int32) * n)[:, None]
    seq_local = seq.reshape(t, n, -1) - offs[:, :, None]
    lengths = lengths.reshape(t, n)
    slot = jnp.arange(max_steps + 1, dtype=jnp.int32)[None, None, :]
    visited = jnp.where(slot < lengths[..., None], seq_local, PAD_INDEX)
    dt = _walk_dtype(n, max_steps)
    return Streamlines(vertices=visited.astype(dt),
                       lengths=lengths.astype(dt)), pows


@partial(jax.jit, static_argnames=("max_steps", "quirks"))
def _trace_frames_graph(mesh: TriMesh, v_world: jnp.ndarray,
                        max_steps: int, quirks: bool, boundary=None):
    """(Streamlines, jump-power tables) — the hop graph's squared powers
    stay on device so compact escalation retraces extend them instead of
    re-squaring from scratch (trace_frames_adaptive)."""
    return _trace_batched(mesh, v_world, max_steps=max_steps, quirks=quirks,
                          boundary=boundary)


@partial(jax.jit, static_argnames=("max_steps", "quirks", "cap"))
def _trace_frames_graph_compact(mesh: TriMesh, v_world: jnp.ndarray,
                                max_steps: int, quirks: bool, boundary,
                                cap: int):
    """Pass 1 FUSED with device-side escalation-seed compaction: also
    returns the first `cap` unresolved seed ids (ascending; stable argsort
    of the unresolved mask) and the true unresolved count. The adaptive
    tracer can then dispatch the escalation retrace IMMEDIATELY on the
    device-resident seed buffer — no blocking lengths fetch, no host
    flatnonzero, no seed upload between the two dispatches. Tail rows beyond
    the true
    count hold already-resolved ids; retracing them is harmless and the
    host ignores their results."""
    sl, pows = _trace_batched(mesh, v_world, max_steps=max_steps,
                              quirks=quirks, boundary=boundary)
    unres = (sl.lengths.reshape(-1) == max_steps + 1)
    order = jnp.argsort(~unres, stable=True)
    seeds = order[:cap].astype(jnp.int32)
    count = jnp.sum(unres).astype(jnp.int32)
    return sl, seeds, count, pows


def _bucket(x: int) -> int:
    """Smallest capacity of the graded {2^k, 1.5 * 2^k} family >= x: shape
    buckets for compiled-program reuse with <= 33% overshoot (plain pow2
    buckets overshoot up to 2x — a 1.05M-row retrace for 620k real seeds —
    and overfetch up to 2x on packed-gather transfers)."""
    import numpy as np

    x = max(int(x), 8)
    p2 = 1 << int(np.ceil(np.log2(x)))
    mid = 3 * (p2 // 4)
    return mid if mid >= x else p2


# Per-mesh walk-length statistics (exact histograms from completed traces),
# keyed by mesh identity like _BOUNDARY_CACHE. The first trace of a mesh
# runs the default two-pass schedule and records the histogram; subsequent
# traces (the cohort steady state every sweep lives in) pick their windows
# from the recorded distribution (_plan_windows). Why one fixed window is
# wrong: on the reference-scale bench surfaces most walks end within 16
# steps at 3.1k vertices, while at 12.5k about half run past 16.
_STATS_CACHE: dict = {}
# Gathered elements that cost as much wall time as one extra device
# dispatch — the constant that trades extra escalation rounds against
# wider first passes. Measured on an NVIDIA H100 80GB HBM3 (700 W limit,
# chip_smoke.py phase 7): a blocking dispatch round trip of ~128 us times a
# ~19.8 Ge/s dependent-gather rate over a 304k-element table = 2.54e6.
_DISPATCH_GATHER_EQUIV = 2.5e6
# Powers of two ONLY: _double_and_detect materializes power-of-two column
# counts and truncates, so a width-12 window pays the same device gathers
# as width 16 while covering fewer walks — non-pow2 candidates can never
# genuinely win (they looked cheaper under the old (w-1) pricing and biased
# the planner toward schedules with extra escalation rounds).
_WINDOW_CANDIDATES = (8, 16, 32, 64, 128, 256, 512, 1024)


def _record_stats(mesh: TriMesh, quirks: bool, lengths) -> None:
    import numpy as np

    key = (id(mesh.vertex_neighbors), bool(quirks))
    flat = np.asarray(lengths, np.int64).ravel()
    _STATS_CACHE[key] = (mesh.vertex_neighbors, flat.size, np.bincount(flat))
    while len(_STATS_CACHE) > 16:
        _STATS_CACHE.pop(next(iter(_STATS_CACHE)))


def _plan_windows(mesh: TriMesh, quirks: bool, t: int, n: int,
                  max_steps: int, default_w: int) -> dict:
    """Window schedule from the mesh's recorded length histogram.

    Minimizes modeled gather traffic (pointer-doubling elements priced 1,
    dispatches priced _DISPATCH_GATHER_EQUIV) over candidate first windows:
      cost(w1) = T*N*(w1 - 1 + ceil(log2 w1) + 1) + dispatch
               + [per escalation round: cap_r*(w_r - 1) + new squarings
                  * T*N + cap_r + dispatch]
    Returns {'w1', 'w2', 'cap', 'planned'}: cap > 0 means "escalations are
    expected — run the fused compact pass and pipeline the retrace at w2";
    cap == 0 with planned=True means the first window should cover every
    walk. Without stats: the default schedule (w1=default_w, host-driven
    escalation), planned=False."""
    import numpy as np

    key = (id(mesh.vertex_neighbors), bool(quirks))
    entry = _STATS_CACHE.get(key)
    if entry is None or entry[0] is not mesh.vertex_neighbors:
        return {"w1": min(default_w, max_steps), "w2": 0, "cap": 0,
                "planned": False}
    size_stats, hist = entry[1], entry[2]
    scale = (t * n) / max(size_stats, 1)
    cum = np.cumsum(hist)
    total = int(cum[-1])

    def beyond(w):
        """Expected walks unresolved within window w (true length > w);
        recorded max_steps+1 markers count as 'always beyond'."""
        i = min(w, len(cum) - 1)
        return (total - int(cum[i])) * scale

    def log2c(w):
        return int(np.ceil(np.log2(max(w, 1))))


    cands = sorted({c for c in _WINDOW_CANDIDATES if c <= max_steps}
                   | {max_steps})
    # Smallest window covering every recorded walk (the no-escalation
    # schedule's width), capped at max_steps.
    needed = next((c for c in cands if beyond(c) < 0.5), max_steps)

    def next_window(w):
        return min(max_steps, max(2 * w, needed))

    best = None
    for w1 in cands:
        cost = t * n * (w1 - 1 + log2c(w1) + 1) + _DISPATCH_GATHER_EQUIV
        k = beyond(w1)
        w = w1
        while k >= 0.5 and w < max_steps:
            w2 = next_window(w)
            cap_r = _bucket(k * 1.05 + 32)
            cost += (cap_r * (w2 - 1) + (log2c(w2) - log2c(w)) * t * n
                     + cap_r + _DISPATCH_GATHER_EQUIV)
            k = beyond(w2)
            w = w2
        if best is None or cost < best[0]:
            best = (cost, w1)
    w1 = best[1]
    k1 = beyond(w1)
    if k1 < 0.5 or w1 >= max_steps:
        return {"w1": w1, "w2": 0, "cap": 0, "planned": True}
    return {"w1": w1, "w2": next_window(w1),
            "cap": min(_bucket(k1 * 1.05 + 32), t * n), "planned": True}


def trace_frames(mesh: TriMesh, v_world: jnp.ndarray,
                 max_steps: int = 128, quirks: bool = False) -> Streamlines:
    """Trace all frames in one device program: (T, N, 3) -> batched walks.

    One dispatch for the whole movie instead of one per frame, so the
    per-call latency is paid once. Internally all frames share one flat id
    space so each pointer-doubling round is a single large gather
    (_trace_batched)."""
    return _trace_frames_graph(mesh, v_world, max_steps=max_steps,
                               quirks=quirks,
                               boundary=boundary_indices(mesh))[0]


def trace_frames_adaptive(mesh: TriMesh, v_world, max_steps: int = 128,
                          quirks: bool = False,
                          initial_window: int = 16,
                          auto_plan: bool = True,
                          plan_out: dict | None = None) -> Streamlines:
    """trace_frames with an adaptive window + compact escalation retrace.

    The tracer's device cost is the pointer-doubling gather volume
    ~ T * N * window, yet real velocity-field walks are short and
    front-loaded: at reference scale most end within 16 steps, against a
    256-step cap. Pass 1 traces every seed at
    a small window; walks that hit the cap (lengths == window + 1) re-trace
    at a wider window — but ONLY those seeds (_trace_seeds, reusing the
    pass-1 hop graph that stayed on device), so the escalation costs
    K * window' gathers instead of T * N * window'. Results are identical
    to trace_frames(max_steps=max_steps): a resolved walk's length and
    vertex prefix do not depend on the window. The retraced walks come back
    as an OVERLAY (Streamlines.overlay_*) rather than widening the whole
    (T, N, L) array — compact() stitches them in.

    Window schedule: the first trace of a mesh uses `initial_window` and
    records the exact walk-length histogram; every later trace picks the
    gather-traffic-minimizing schedule from it (_plan_windows — at 12.5k
    vertices about half of the walks outlive window 16, so a fixed schedule
    pays a large retrace every movie). When escalations are expected, pass 1
    runs FUSED with device-side seed compaction and the retrace dispatches
    immediately on the device-resident seeds — the two programs pipeline
    with no blocking lengths fetch / host flatnonzero / seed upload between
    them.

    `plan_out`, when given, receives the schedule actually used (w1/w2/cap/
    planned) — the bench feeds its floor model with it. `auto_plan=False`
    pins the schedule to `initial_window` + host-driven 4x escalation (and
    records no stats) — for callers/tests that need a specific window.

    Not jittable (data-dependent host loop); pipeline stages and benchmarks
    call it from the host. Use trace_frames inside jit.
    """
    import numpy as np

    from manifold_flow_tpu.utils.io import start_host_copy

    t = np.shape(v_world)[0]
    n = mesh.n_vertices
    boundary = boundary_indices(mesh)
    if auto_plan:
        plan = _plan_windows(mesh, quirks, t, n, max_steps, initial_window)
    else:
        plan = {"w1": min(initial_window, max_steps), "w2": 0, "cap": 0,
                "planned": False}
    if plan_out is not None:
        plan_out.update(plan)
    w1 = plan["w1"]
    def record(lengths_arr):
        if auto_plan:
            _record_stats(mesh, quirks, lengths_arr)

    rounds = []                  # (seed ids, device rows, host lengths)
    if plan["cap"]:
        # Pipelined two-pass: both dispatches issue back-to-back; the only
        # blocking fetches happen after both programs are in flight.
        w2 = plan["w2"]
        cap = plan["cap"]
        sl, seeds_d, count_d, pows = _trace_frames_graph_compact(
            mesh, v_world, max_steps=w1, quirks=quirks, boundary=boundary,
            cap=cap)
        ov, ol_d, pows = _trace_seeds(pows, seeds_d, n=n, max_steps=w2)
        # Only the lengths + retrace-lengths cross the link: the seed ids
        # and count re-derive on host from lengths (flatnonzero ascends
        # exactly like the device compaction's stable argsort), saving two
        # fetch round trips per trace. `seeds_d`/`count_d` exist solely to
        # feed the retrace dispatch without host involvement.
        del seeds_d, count_d
        start_host_copy(sl.lengths, ol_d)
        lengths = np.asarray(sl.lengths)
        all_unres = np.flatnonzero(
            lengths.ravel() == w1 + 1).astype(np.int32)
        count = all_unres.size
        if count == 0:
            record(lengths)
            return sl
        k = min(count, cap)
        ids = all_unres[:k]
        ol = np.asarray(ol_d)[:k]
        rounds.append((ids, ov, ol))
        active = ids[ol == w2 + 1]
        if count > cap:
            # Stats-derived capacity overflowed (distribution shifted):
            # the uncovered tail escalates through the host-driven loop.
            extra = all_unres[cap:]
            cap_e = _bucket(extra.size)
            seeds_e = np.full(cap_e, extra[0], np.int32)
            seeds_e[: extra.size] = extra
            ov_e, ol_e, pows = _trace_seeds(pows, jnp.asarray(seeds_e),
                                            n=n, max_steps=w2)
            ol_e = np.asarray(ol_e)[: extra.size]
            rounds.append((extra, ov_e, ol_e))
            active = np.concatenate([active, extra[ol_e == w2 + 1]])
        wcur = w2
    else:
        sl, pows = _trace_frames_graph(mesh, v_world, max_steps=w1,
                                       quirks=quirks, boundary=boundary)
        lengths = np.asarray(sl.lengths)
        if w1 >= max_steps:
            record(lengths)
            return sl
        active = np.flatnonzero(
            lengths.ravel() == w1 + 1).astype(np.int32)
        if active.size == 0:
            record(lengths)
            return sl
        wcur = w1
    while active.size and wcur < max_steps:
        wcur = (min(wcur * 4, max_steps) if rounds
                else min(max(wcur * 4, plan["w2"] or 0), max_steps))
        # Seed capacity buckets to powers of two so cohort sweeps reuse the
        # compiled retrace program; pad slots repeat a real seed (harmless —
        # their rows are simply ignored). Each round re-traces only the
        # SURVIVORS of the previous one, and the jump-power tables carry
        # over so no squaring gather is ever paid twice.
        cap_r = _bucket(active.size)
        seeds = np.full(cap_r, active[0], np.int32)
        seeds[: active.size] = active
        ov, ol, pows = _trace_seeds(pows, jnp.asarray(seeds), n=n,
                                    max_steps=wcur)
        ol = np.asarray(ol)[: active.size]
        rounds.append((active, ov, ol))
        active = active[ol == wcur + 1]
    patched = lengths.copy()
    for ids, _, ol_r in rounds:
        patched.ravel()[ids] = ol_r  # later rounds overwrite their subset
    record(patched)
    if len(rounds) == 1:
        # overlay_vertices stays a DEVICE array: fetching it here would move
        # K * (w2+1) ints to the host even when the
        # consumer only compacts a subset; np.asarray at the use site
        # instead (same accounting as the main vertices array). Rows beyond
        # len(overlay_ids) are capacity padding.
        ids, ov, _ = rounds[0]
        return Streamlines(vertices=sl.vertices,
                           lengths=patched.reshape(t, n),
                           overlay_ids=ids, overlay_vertices=ov)
    # Multi-round escalation: merge the rounds into ONE overlay ON DEVICE
    # at the widest width over the UNION of all seed ids (the pipelined
    # first round and an overflow tail round are siblings, not subsets),
    # later rounds overwriting their seeds' rows; scatter positions come
    # from one searchsorted against the ascending union (a host-side merge
    # would fetch every round's overlay — hundreds of MB at 12.5k scale —
    # and loop per walk in Python).
    uids = np.unique(np.concatenate([r[0] for r in rounds]))
    w_cols = max(r[1].shape[1] for r in rounds)
    dt = rounds[-1][1].dtype

    def pad_rows(ov):
        missing = w_cols - ov.shape[1]
        if missing == 0:
            return ov
        return jnp.concatenate(
            [ov, jnp.full((ov.shape[0], missing), PAD_INDEX, ov.dtype)],
            axis=1)

    cap_u = _bucket(uids.size)
    base = jnp.full((cap_u, w_cols), PAD_INDEX, dt)
    for ids_r, ov_r, _ in rounds:
        pos = np.searchsorted(uids, ids_r).astype(np.int32)
        base = base.at[jnp.asarray(pos)].set(
            pad_rows(ov_r)[: len(ids_r)].astype(dt))
    return Streamlines(vertices=sl.vertices, lengths=patched.reshape(t, n),
                       overlay_ids=uids.astype(np.int32),
                       overlay_vertices=base)


@partial(jax.jit, static_argnames=())
def _gather_walk_rows(vflat: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    return vflat[ids]


@partial(jax.jit, static_argnames=("l_cap",))
def _gather_packed(rows: jnp.ndarray, ids: jnp.ndarray,
                   offsets: jnp.ndarray, l_cap: int) -> jnp.ndarray:
    """Ragged walk extraction: concatenate rows[ids[k], :len_k] for all k
    into ONE flat (l_cap,) vector on device.

    `offsets` is the (K+1,) prefix sum of the walk lengths; l_cap a
    power-of-two bucket >= offsets[-1]. Callers bucket K too (pad ids
    arbitrarily and repeat offsets[-1]) so cohort sweeps reuse one
    compiled program per bucket pair instead of recompiling per distinct
    walk count. The walk->element expansion is a scatter of segment
    starts + cumsum (no per-element searchsorted), then two flat gathers.
    This fetches exactly sum(lengths) elements instead of fixed-width
    rows — at 12.5k-mesh scale the qualifying walks' useful payload is
    ~60 MB where the fixed-width row fetch is ~500 MB."""
    pos = jnp.arange(l_cap, dtype=jnp.int32)
    # Segment index via scatter+cumsum; out-of-range starts (the capacity
    # tail) drop out of the scatter by XLA's OOB-update rule.
    marks = jnp.zeros((l_cap,), jnp.int32).at[offsets[1:]].add(1)
    seg = jnp.cumsum(marks)                          # (L,) walk index
    seg = jnp.minimum(seg, ids.shape[0] - 1)
    col = pos - offsets[seg]
    col = jnp.clip(col, 0, rows.shape[1] - 1)
    return rows[ids[seg], col]


def compact_frames(mesh: TriMesh, sl: Streamlines, min_length: int = 20,
                   coord_dtype=None, emit=None):
    """Host-side: a whole movie's masked walks -> per-frame polyline lists.

    Equivalent to per-frame `compact` over a (T, N, W) Streamlines, but
    fetches ONLY the qualifying rows: at reference scale just ~13% of walks
    reach min_length, and the full (T, N, W) array is ~11 MB while the
    survivors are ~1.4 MB. The keep mask
    comes from the (small) lengths array; one jitted gather compacts the
    kept rows on device (capacity bucketed to powers of two so cohort
    sweeps reuse the compiled program).

    `coord_dtype` sets the polyline coordinate dtype (default: the mesh's
    point dtype). Streamline polylines are bz2-pickled per frame — the
    largest artifact volume of a trial — and a polyline is a list of mesh
    vertex coordinates, which f32 holds exactly enough for plotting, so the
    pipeline ships float32 unless reference_quirks asks for the f64
    bytes.

    `emit(frame_index, lines)`, when given, is called once per frame AS
    SOON as that frame's polylines exist — pipeline.stages queues each
    frame's pickle write from the callback so the (GIL-releasing) bz2
    compression overlaps the remaining frames' assembly instead of
    starting after the whole movie is built."""
    import numpy as np

    pts = np.asarray(mesh.points)
    if coord_dtype is not None:
        pts = pts.astype(coord_dtype)
    lengths = np.asarray(sl.lengths)                        # (T, N)
    t, n = lengths.shape
    nv = min(n, int(mesh.valid_vertices))
    keep = lengths[:, :nv] >= min_length                    # (T, nv)
    fr, sd = np.nonzero(keep)
    fids = (fr.astype(np.int64) * n + sd).astype(np.int32)  # flat (T*N) ids
    olengths = lengths.reshape(-1)

    def packed_dispatch(device_rows, positions, lens):
        """DISPATCH the packed ragged gather for walks `positions` (row
        indices into device_rows) with lengths `lens`; returns
        (device buffer, total, offsets). One packed gather (+ graded
        length bucket for compiled-program reuse) produces exactly the
        useful ids; `packed_finish` fetches and expands them. Split so the
        overlay and base gathers DISPATCH back-to-back and their fetches
        pipeline over the link (the previous fused helper blocked on the
        first fetch before dispatching the second gather)."""
        offsets = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        total = int(offsets[-1])
        l_cap = _bucket(total)
        # Bucket the walk-count axis too: padding walks are zero-length
        # (offsets repeat the total, so they claim no elements) — without
        # this every distinct qualifying-walk count K would compile a
        # fresh program.
        k_cap = _bucket(len(lens))
        pos_p = np.zeros(k_cap, np.int32)
        pos_p[: positions.size] = positions
        offs_p = np.full(k_cap + 1, total, np.int32)
        offs_p[: offsets.size] = offsets
        dev = _gather_packed(device_rows, jnp.asarray(pos_p),
                             jnp.asarray(offs_p), l_cap)
        return dev, total, offsets

    def packed_finish(dev, total):
        """(sum lens, 3) coords from a packed_dispatch buffer: materialize
        the (already in-flight) fetch, expand vertex ids to coordinates.
        np.take keeps the narrow id dtype (no 17.5M-element int64 cast
        pass at 12.5k scale)."""
        flat = np.asarray(dev)[:total]
        return np.take(pts, flat, axis=0)

    if sl.overlay_ids is not None and len(sl.overlay_ids):
        # Overlay ids ascend (flatnonzero order), so membership and
        # positions vectorize; only the QUALIFYING overlay walks' useful
        # elements cross the link.
        o_ids = np.asarray(sl.overlay_ids)
        # Membership via searchsorted (o_ids ascend): np.isin re-sorts both
        # operands every call.
        pos = np.searchsorted(o_ids, fids)
        pos_c = np.minimum(pos, len(o_ids) - 1)
        in_overlay = o_ids[pos_c] == fids
    else:
        in_overlay = np.zeros(len(fids), bool)

    from manifold_flow_tpu.utils.io import start_host_copy

    need = fids[in_overlay]
    base_ids = fids[~in_overlay]
    o_dev = b_dev = None
    if need.size:
        opos = np.searchsorted(o_ids, need)
        o_dev, o_total, o_offs = packed_dispatch(
            jnp.asarray(sl.overlay_vertices), opos, olengths[need])
    if base_ids.size:
        vflat = jnp.reshape(jnp.asarray(sl.vertices), (t * n, -1))
        b_dev, b_total, b_offs = packed_dispatch(vflat, base_ids,
                                                 olengths[base_ids])
    start_host_copy(*(d for d in (o_dev, b_dev) if d is not None))
    if o_dev is not None:
        o_coords = packed_finish(o_dev, o_total)
    if b_dev is not None:
        b_coords = packed_finish(b_dev, b_total)

    # Each walk's polyline is a SLICE VIEW of its source's packed coords —
    # no merged copy (scattering both sources into one flat array first
    # costs an extra ~210 MB fancy-index copy at 12.5k scale). The per-walk
    # work here is one list-index + one slice.
    k_walks = len(fids)
    starts = np.zeros(k_walks, np.int64)
    ends = np.zeros(k_walks, np.int64)
    src_of = in_overlay.view(np.int8)
    srcs = [None, None]
    if base_ids.size:
        srcs[0] = b_coords
        starts[~in_overlay] = b_offs[:-1]
        ends[~in_overlay] = b_offs[1:]
    if need.size:
        srcs[1] = o_coords
        starts[in_overlay] = o_offs[:-1]
        ends[in_overlay] = o_offs[1:]
    sel_l = src_of.tolist()
    st_l = starts.tolist()                      # python ints: faster slicing
    en_l = ends.tolist()
    bounds = np.searchsorted(fr, np.arange(t + 1)).tolist()
    out = []
    for k in range(t):
        a, b = bounds[k], bounds[k + 1]
        lines = [srcs[sel_l[j]][st_l[j]: en_l[j]] for j in range(a, b)]
        out.append(lines)
        if emit is not None:
            emit(k, lines)
    return out


def compact(mesh: TriMesh, sl: Streamlines, min_length: int = 20):
    """Host-side: masked walks -> list of coordinate polylines (S6:135-138).

    Walks longer than the main array's window read their full row from the
    adaptive tracer's overlay (Streamlines docstring). Padding-vertex seeds
    (padded meshes) are skipped outright."""
    import numpy as np

    pts = np.asarray(mesh.points)
    verts = np.asarray(sl.vertices)
    lengths = np.asarray(sl.lengths)
    omap = {}
    if sl.overlay_ids is not None and len(sl.overlay_ids):
        over = np.asarray(sl.overlay_vertices)
        omap = {int(s): j for j, s in enumerate(np.asarray(sl.overlay_ids))}
    # Iterate the qualifying seeds only (numpy filter): a python loop over
    # every seed of every frame costs seconds per movie on small hosts.
    nv = min(verts.shape[0], int(mesh.valid_vertices))
    out = []
    for i in np.flatnonzero(lengths[:nv] >= min_length):
        row = over[omap[i]] if i in omap else verts[i]
        out.append(pts[row[: lengths[i]]])
    return out
