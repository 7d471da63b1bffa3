"""Topology queries over TriMesh, replacing live PyVista/VTK calls.

Reference usages replaced here:
  * `surface.find_closest_point`       -> closest_vertex          (S6:59, S7:131)
  * `surface.point_neighbors_levels`   -> bfs_levels              (S7:131-132)
  * `surface.geodesic_distance`        -> geodesic_distance_matrix
                                          (utils/find_singularity_point.py:653)
  * `surface.find_cells_intersecting_line` on a shared mesh edge
                                       -> other_cell_across_edge
                                          (utils/find_singularity_point.py:431-438)

Device functions are jit/vmap friendly (fixed shapes, masked outputs);
`geodesic_distance_matrix` is host-side (scipy Dijkstra over the edge graph,
the same graph-geodesic VTK computes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from manifold_flow_tpu.geometry.mesh import PAD_INDEX, TriMesh


def closest_vertex(points: jnp.ndarray, queries: jnp.ndarray,
                   n_valid: int | None = None) -> jnp.ndarray:
    """Index of the Euclidean-nearest vertex for each query point (..., 3)."""
    d2 = jnp.sum((queries[..., None, :] - points) ** 2, axis=-1)
    if n_valid is not None:
        # n_valid is a runtime operand (TriMesh valid counts are data
        # leaves so padded/unpadded meshes share compiled programs), so the
        # compare+select executes on every call even for unpadded meshes —
        # one (..., N) pass, negligible next to the distance computation.
        pad = jnp.arange(points.shape[0]) >= n_valid
        d2 = jnp.where(pad, jnp.inf, d2)
    return jnp.argmin(d2, axis=-1).astype(jnp.int32)


def bfs_levels(vertex_neighbors: jnp.ndarray, source: jnp.ndarray,
               max_level: int) -> jnp.ndarray:
    """Breadth-first ring levels from `source` vertex.

    Returns levels (N,) int32: 0 at the source, k for the k-th ring,
    -1 for vertices beyond `max_level`. Fixed-iteration masked BFS: each step
    gathers the frontier mask over the padded 1-ring table, so it is jit- and
    vmap-compatible (batched equivalent of `point_neighbors_levels`,
    S7:131).
    """
    n = vertex_neighbors.shape[0]
    neigh = jnp.where(vertex_neighbors == PAD_INDEX, 0, vertex_neighbors)
    valid = vertex_neighbors != PAD_INDEX
    levels0 = jnp.full((n,), -1, dtype=jnp.int32).at[source].set(0)

    def step(l, levels):
        frontier = levels == l - 1
        reached = jnp.any(frontier[neigh] & valid, axis=-1)
        return jnp.where(reached & (levels < 0), l, levels)

    return jax.lax.fori_loop(1, max_level + 1, step, levels0)


def edge_lookup(edges: jnp.ndarray, va: jnp.ndarray, vb: jnp.ndarray) -> jnp.ndarray:
    """Index into the sorted unique-edge table for edge (va, vb), else -1."""
    lo = jnp.minimum(va, vb)
    hi = jnp.maximum(va, vb)
    match = (edges[:, 0] == lo) & (edges[:, 1] == hi)
    idx = jnp.argmax(match)
    return jnp.where(jnp.any(match), idx, -1).astype(jnp.int32)


def other_cell_across_edge(edges: jnp.ndarray, edge_cells: jnp.ndarray,
                           cell_id: jnp.ndarray, va: jnp.ndarray,
                           vb: jnp.ndarray) -> jnp.ndarray:
    """The triangle on the other side of edge (va, vb) from `cell_id`.

    Returns -1 for boundary edges / unknown edges. This is the deterministic
    equivalent of the reference's
    `set(find_cells_intersecting_line(edge)) - {index}).pop()`
    (utils/find_singularity_point.py:434-437), whose `.pop()` picks an
    arbitrary member when the VTK line query returns extra cells touching the
    edge endpoints; we always return the unique edge-adjacent neighbor.
    """
    eid = edge_lookup(edges, va, vb)
    cells = edge_cells[jnp.maximum(eid, 0)]
    other = jnp.where(cells[0] == cell_id, cells[1], cells[0])
    return jnp.where(eid < 0, -1, other).astype(jnp.int32)


def edge_graph_csr(mesh: TriMesh):
    """Host-side sparse edge-length graph (scipy CSR) of the mesh."""
    import scipy.sparse as sp

    edges = np.asarray(mesh.edges)
    pts = np.asarray(mesh.points)
    valid = edges[:, 0] != PAD_INDEX
    edges = edges[valid]
    w = np.linalg.norm(pts[edges[:, 0]] - pts[edges[:, 1]], axis=-1)
    n = mesh.n_vertices
    g = sp.coo_matrix(
        (np.concatenate([w, w]),
         (np.concatenate([edges[:, 0], edges[:, 1]]),
          np.concatenate([edges[:, 1], edges[:, 0]]))),
        shape=(n, n),
    )
    return g.tocsr()


def geodesic_distance_matrix(mesh: TriMesh, sources: np.ndarray) -> np.ndarray:
    """Graph-geodesic distances (len(sources), N) along mesh edges.

    Host-side Dijkstra — the same graph geodesic as VTK's
    `geodesic_distance` used for simulated-data validation
    (utils/find_singularity_point.py:653). Runs in the validation/scoring
    path only, never inside the device compute graph.
    """
    from scipy.sparse.csgraph import dijkstra

    g = edge_graph_csr(mesh)
    return dijkstra(g, directed=False, indices=np.asarray(sources))
