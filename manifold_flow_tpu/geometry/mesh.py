"""TriMesh: the central mesh container (a JAX pytree).

Replaces the reference's reliance on a live PyVista object for geometry
arrays and topology queries (points / faces / point_normals / cell areas at
utils/compute_optical_flow.py:345-350; point_neighbors, point_cell_ids,
point_neighbors_levels, find_closest_point, find_cells_intersecting_line,
geodesic used across utils/find_singularity_point.py, S5, S6, S7). All
topology is precomputed host-side into fixed-shape padded int arrays so every
downstream op is jit/vmap/shard-friendly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from manifold_flow_tpu.geometry.fem_quantities import (
    hat_gradients,
    mass_integrals,
    triangle_areas,
    vertex_normals_from_cells,
)
from manifold_flow_tpu.geometry.tangent import tangent_basis

PAD_INDEX = -1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TriMesh:
    """Triangulated 2-manifold with precomputed FEM + topology arrays.

    Array fields (pytree leaves):
      points          (N, 3)  float  vertex coordinates
      triangles       (M, 3)  int32  corner vertex ids
      normals         (N, 3)  float  unit vertex normals
      areas           (M,)    float  triangle areas
      basis           (N, 2, 3) float tangent orthonormal bases ("e")
      grad_w          (M, 3, 3) float P1 hat gradients per corner
      integrals       (M, 2)  float  [A/6, A/12] mass integrals
      vertex_neighbors (N, D) int32  1-ring vertex ids, PAD_INDEX padded
      vertex_cells     (N, C) int32  incident cell ids, PAD_INDEX padded
      vertex_cell_slot (N, C) int32  corner slot (0..2) of the vertex within
                                     each incident cell, PAD_INDEX padded —
                                     turns FEM scatter-adds into fixed-width
                                     gather+sum reductions (fem.operator)
      vertex_degree    (N,)   int32  valid entries in vertex_neighbors
      vertex_cell_count(N,)   int32  valid entries in vertex_cells
      boundary_vertex  (N,)   bool   vertex on mesh boundary
      edges            (E, 2) int32  unique undirected edges (sorted pairs)
      edge_cells       (E, 2) int32  incident cells per edge (PAD for boundary)

    Static (aux) fields: n_vertices, n_triangles (PADDED counts — the array
    sizes every jitted program shapes to) and n_valid_vertices /
    n_valid_triangles (the real mesh; 0 means "all valid"). `pad_mesh` builds
    padded meshes whose array shapes are rounded to multiples, so different
    surfaces share one compiled program; padding triangles reference padding
    vertices only, have zero area/gradients, and contribute nothing to FEM
    assembly or adjacency of real vertices. Ops mask their outputs with
    `valid_vertices` / `valid_triangles` (ops.singularity.detect,
    topology.closest_vertex callers).
    """

    points: jnp.ndarray
    triangles: jnp.ndarray
    normals: jnp.ndarray
    areas: jnp.ndarray
    basis: jnp.ndarray
    grad_w: jnp.ndarray
    integrals: jnp.ndarray
    vertex_neighbors: jnp.ndarray
    vertex_cells: jnp.ndarray
    vertex_cell_slot: jnp.ndarray
    vertex_degree: jnp.ndarray
    vertex_cell_count: jnp.ndarray
    boundary_vertex: jnp.ndarray
    edges: jnp.ndarray
    edge_cells: jnp.ndarray
    n_vertices: int = dataclasses.field(metadata=dict(static=True))
    n_triangles: int = dataclasses.field(metadata=dict(static=True))
    # Valid (non-padding) counts are DATA leaves, not static fields: two
    # surfaces padded to the same shape bucket then share every compiled
    # program — the jit cache keys on shapes and static fields only, and the
    # valid count rides along as a scalar operand. 0 means "all valid".
    n_valid_vertices: int = 0
    n_valid_triangles: int = 0

    @property
    def n_dof(self) -> int:
        """Velocity DOF count 2N (two tangent components per vertex)."""
        return 2 * self.n_vertices

    @property
    def valid_vertices(self):
        """Count of REAL (non-padding) vertices.

        A Python int on concrete meshes; a traced scalar inside jit (ops mask
        with it unconditionally — on unpadded meshes the mask is all-true)."""
        n = self.n_valid_vertices
        if isinstance(n, jax.core.Tracer):
            return jnp.where(n > 0, n, self.n_vertices)
        return int(n) or self.n_vertices

    @property
    def valid_triangles(self):
        """Count of REAL (non-padding) triangles (see valid_vertices)."""
        n = self.n_valid_triangles
        if isinstance(n, jax.core.Tracer):
            return jnp.where(n > 0, n, self.n_triangles)
        return int(n) or self.n_triangles

    @property
    def is_padded(self) -> bool:
        """Host-side only: needs a concrete (untraced) mesh."""
        return (self.valid_vertices != self.n_vertices
                or self.valid_triangles != self.n_triangles)

    @property
    def e(self) -> jnp.ndarray:
        """Alias matching the reference's name for the tangent bases."""
        return self.basis


def _vertex_adjacency(n_vertices: int, triangles: np.ndarray):
    """Vertex->vertex and vertex->(cell, corner-slot) incidence, padded."""
    neigh = [set() for _ in range(n_vertices)]
    cells = [[] for _ in range(n_vertices)]
    slots = [[] for _ in range(n_vertices)]
    for m, (a, b, c) in enumerate(triangles):
        neigh[a].update((b, c))
        neigh[b].update((a, c))
        neigh[c].update((a, b))
        for slot, v in enumerate((a, b, c)):
            cells[v].append(m)
            slots[v].append(slot)
    max_deg = max((len(s) for s in neigh), default=1) or 1
    max_cells = max((len(s) for s in cells), default=1) or 1
    vn = np.full((n_vertices, max_deg), PAD_INDEX, dtype=np.int32)
    vc = np.full((n_vertices, max_cells), PAD_INDEX, dtype=np.int32)
    vs = np.full((n_vertices, max_cells), PAD_INDEX, dtype=np.int32)
    deg = np.zeros(n_vertices, dtype=np.int32)
    ncell = np.zeros(n_vertices, dtype=np.int32)
    for i in range(n_vertices):
        s = sorted(neigh[i])
        vn[i, : len(s)] = s
        deg[i] = len(s)
        vc[i, : len(cells[i])] = cells[i]
        vs[i, : len(slots[i])] = slots[i]
        ncell[i] = len(cells[i])
    return vn, vc, vs, deg, ncell


def _edges_and_boundary(n_vertices: int, triangles: np.ndarray):
    """Unique undirected edges, their incident cells, boundary vertices."""
    edge_map: dict[tuple[int, int], list[int]] = {}
    for m, tri in enumerate(triangles):
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            key = (min(a, b), max(a, b))
            edge_map.setdefault(key, []).append(m)
    n_edges = max(len(edge_map), 1)
    edges = np.full((n_edges, 2), PAD_INDEX, dtype=np.int32)
    edge_cells = np.full((n_edges, 2), PAD_INDEX, dtype=np.int32)
    boundary = np.zeros(n_vertices, dtype=bool)
    for idx, (key, cs) in enumerate(sorted(edge_map.items())):
        edges[idx] = key
        edge_cells[idx, : min(len(cs), 2)] = cs[:2]
        if len(cs) == 1:
            boundary[key[0]] = True
            boundary[key[1]] = True
    return edges, edge_cells, boundary


def _precompute_quantities(pts, tris, nrm, n_vertices: int):
    """All per-mesh FEM quantities in one traceable function."""
    if nrm is None:
        nrm = vertex_normals_from_cells(pts, tris, n_vertices)
    areas = triangle_areas(pts, tris)
    basis = tangent_basis(nrm)
    grad_w = hat_gradients(pts, tris)
    integrals = mass_integrals(areas)
    return nrm, areas, basis, grad_w, integrals


_precompute_jit = jax.jit(_precompute_quantities,
                          static_argnames=("n_vertices",))


def build_mesh(points, triangles, normals=None, dtype=None) -> TriMesh:
    """Construct a TriMesh from raw arrays (host-side, runs once per surface).

    `normals` defaults to cell-normal-averaged vertex normals (the quantity
    the reference takes from `surface.point_normals`,
    utils/compute_optical_flow.py:349).

    The precompute runs as ONE jitted program on the default device, so its
    results are already where the solver uses them.
    """
    points = np.asarray(points)
    if dtype is not None:
        points = points.astype(dtype)
    triangles = np.asarray(triangles, dtype=np.int32)
    n_vertices = int(points.shape[0])
    n_triangles = int(triangles.shape[0])

    nrm_in = (None if normals is None
              else np.asarray(normals, dtype=points.dtype))
    nrm, areas, basis, grad_w, integrals = _precompute_jit(
        points, triangles, nrm_in, n_vertices)
    pts = jnp.asarray(points)
    tris = jnp.asarray(triangles)

    from manifold_flow_tpu import native

    topo = native.build_topology(n_vertices, triangles)
    if topo is not None:
        vn, vc, vs = (topo.vertex_neighbors, topo.vertex_cells,
                      topo.vertex_cell_slot)
        deg, ncell = topo.vertex_degree, topo.vertex_cell_count
        edges, edge_cells = topo.edges, topo.edge_cells
        boundary = topo.boundary_vertex
    else:  # pure-Python fallback (no C++ toolchain)
        vn, vc, vs, deg, ncell = _vertex_adjacency(n_vertices, triangles)
        edges, edge_cells, boundary = _edges_and_boundary(n_vertices, triangles)

    return TriMesh(
        points=pts,
        triangles=tris,
        normals=nrm,
        areas=areas,
        basis=basis,
        grad_w=grad_w,
        integrals=integrals,
        vertex_neighbors=jnp.asarray(vn),
        vertex_cells=jnp.asarray(vc),
        vertex_cell_slot=jnp.asarray(vs),
        vertex_degree=jnp.asarray(deg),
        vertex_cell_count=jnp.asarray(ncell),
        boundary_vertex=jnp.asarray(boundary),
        edges=jnp.asarray(edges),
        edge_cells=jnp.asarray(edge_cells),
        n_vertices=n_vertices,
        n_triangles=n_triangles,
    )


def _pad_cols(a: np.ndarray, multiple: int, fill: int) -> np.ndarray:
    w = a.shape[1]
    w2 = -(-w // multiple) * multiple
    if w2 == w:
        return a
    out = np.full((a.shape[0], w2), fill, dtype=a.dtype)
    out[:, :w] = a
    return out


def _append_rows(a: np.ndarray, k: int, fill=0) -> np.ndarray:
    """Append k fill rows. Returns `a` itself (possibly a read-only view of
    a jax array) when k == 0 — callers must not mutate in that case."""
    a = np.asarray(a)
    if k == 0:
        return a
    out = np.full((a.shape[0] + k,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _pad_rows(a: np.ndarray, multiple: int, fill: int) -> np.ndarray:
    r = a.shape[0]
    return _append_rows(a, -(-r // multiple) * multiple - r, fill)


def pad_mesh(mesh: TriMesh, vertex_multiple: int = 128,
             triangle_multiple: int = 256, table_multiple: int = 8,
             edge_multiple: int = 2048) -> TriMesh:
    """Round the mesh's array shapes up to multiples for fixed-shape program
    reuse: surfaces padded to the same bucket share one compiled program per
    kernel instead of recompiling per subject/run. The jit cache keys on EVERY
    pytree leaf's shape, so the topology tables are bucketed too: adjacency
    widths round to `table_multiple` and the unique-edge table to
    `edge_multiple` rows (all consumers mask on PAD_INDEX already), and the
    valid counts ride along as scalar data leaves rather than static fields.

    Padding never touches real topology: pad rows are appended to the
    already-precomputed arrays (no rebuild), pad vertices carry EMPTY
    adjacency rows (zero extra gather traffic in the FEM matvec), and pad
    triangles reference one pad vertex with zero area/gradients/integrals.
    """
    n = mesh.valid_vertices
    m = mesh.valid_triangles
    if mesh.is_padded:
        raise ValueError("mesh is already padded")
    n_pad = -(-n // vertex_multiple) * vertex_multiple
    m_pad = -(-m // triangle_multiple) * triangle_multiple
    if m_pad > m and n_pad == n:
        n_pad += vertex_multiple  # pad triangles need a pad corner vertex

    points = np.asarray(mesh.points)
    fdt = points.dtype
    qv, qm = n_pad - n, m_pad - m
    # Pad rows are INERT, appended to the precomputed arrays directly (no
    # topology rebuild): pad vertices have empty adjacency rows (so they add
    # zero gather traffic in the FEM matvec and no graph edges), pad
    # triangles reference one pad vertex with zero area/gradients/integrals
    # (so they contribute nothing to assembly), and pad coordinates sit far
    # outside the bounding box so closest-point snaps can never pick them
    # even without the explicit valid_vertices mask.
    far = points.max(axis=0) + 1e6 * max(
        1.0, float(np.ptp(points, axis=0).max())) if n else np.zeros(3, fdt)

    rows = _append_rows
    pts_pad = rows(points, qv)
    basis_pad = rows(np.asarray(mesh.basis), qv)
    nrm_pad = rows(np.asarray(mesh.normals), qv)
    if qv:  # k == 0 returns the original (read-only) array — don't write
        pts_pad[n:] = far
        basis_pad[n:] = np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], fdt)
        nrm_pad[n:] = np.asarray([0.0, 0.0, 1.0], fdt)
    tris_pad = rows(np.asarray(mesh.triangles), qm, fill=n if qv else 0)

    return dataclasses.replace(
        mesh,
        points=jnp.asarray(pts_pad),
        triangles=jnp.asarray(tris_pad),
        normals=jnp.asarray(nrm_pad),
        basis=jnp.asarray(basis_pad),
        areas=jnp.asarray(rows(mesh.areas, qm)),
        grad_w=jnp.asarray(rows(mesh.grad_w, qm)),
        integrals=jnp.asarray(rows(mesh.integrals, qm)),
        vertex_neighbors=jnp.asarray(_pad_cols(
            rows(mesh.vertex_neighbors, qv, PAD_INDEX),
            table_multiple, PAD_INDEX)),
        vertex_cells=jnp.asarray(_pad_cols(
            rows(mesh.vertex_cells, qv, PAD_INDEX),
            table_multiple, PAD_INDEX)),
        vertex_cell_slot=jnp.asarray(_pad_cols(
            rows(mesh.vertex_cell_slot, qv, PAD_INDEX),
            table_multiple, PAD_INDEX)),
        vertex_degree=jnp.asarray(rows(mesh.vertex_degree, qv)),
        vertex_cell_count=jnp.asarray(rows(mesh.vertex_cell_count, qv)),
        boundary_vertex=jnp.asarray(rows(mesh.boundary_vertex, qv)),
        edges=jnp.asarray(_pad_rows(
            np.asarray(mesh.edges), edge_multiple, PAD_INDEX)),
        edge_cells=jnp.asarray(_pad_rows(
            np.asarray(mesh.edge_cells), edge_multiple, PAD_INDEX)),
        n_vertices=n_pad, n_triangles=m_pad,
        n_valid_vertices=n, n_valid_triangles=m)


# ------------------------- padded-field helpers (host-side, numpy) ---------
def unpad_vertex_field(mesh: TriMesh, arr) -> np.ndarray:
    """Strip padding columns from a per-vertex field (..., N) -> (..., nv)."""
    return np.asarray(arr)[..., : int(mesh.valid_vertices)]


def pad_vertex_field(mesh: TriMesh, arr, fill=0.0) -> np.ndarray:
    """Zero-extend a per-vertex field (..., nv) -> (..., N)."""
    arr = np.asarray(arr)
    n = mesh.n_vertices
    if arr.shape[-1] == n:
        return arr
    out = np.full(arr.shape[:-1] + (n,), fill, dtype=arr.dtype)
    out[..., : arr.shape[-1]] = arr
    return out


def unpad_dof_field(mesh: TriMesh, arr) -> np.ndarray:
    """Strip padding from DOF vectors (..., 2N) -> (..., 2nv).

    The DOF layout is dof = vertex + N * alpha (two stacked component
    halves), so unpadding keeps the first nv entries of each half.
    Returns HOST numpy — on a device array this is a synchronous fetch;
    use unpad_dof_field_device when the result stays on device (the fetch
    moves the whole array)."""
    arr = np.asarray(arr)
    n = mesh.n_vertices
    nv = int(mesh.valid_vertices)
    if nv == n:
        return arr
    return np.concatenate([arr[..., :nv], arr[..., n: n + nv]], axis=-1)


def unpad_dof_field_device(mesh: TriMesh, arr):
    """unpad_dof_field as DEVICE slices: no host fetch, result stays a
    device array (start its host copy async if an artifact needs it)."""
    import jax.numpy as jnp

    n = mesh.n_vertices
    nv = int(mesh.valid_vertices)
    if nv == n:
        return arr
    return jnp.concatenate([arr[..., :nv], arr[..., n: n + nv]], axis=-1)


def unpad_vertex_field_device(mesh: TriMesh, arr):
    """unpad_vertex_field as a DEVICE slice (identity when unpadded)."""
    nv = int(mesh.valid_vertices)
    if nv == mesh.n_vertices:
        return arr
    return arr[..., :nv]


def pad_dof_field(mesh: TriMesh, arr) -> np.ndarray:
    """Zero-extend DOF vectors (..., 2nv) -> (..., 2N)."""
    arr = np.asarray(arr)
    n = mesh.n_vertices
    nv = arr.shape[-1] // 2
    if nv == n:
        return arr
    out = np.zeros(arr.shape[:-1] + (2 * n,), dtype=arr.dtype)
    out[..., :nv] = arr[..., :nv]
    out[..., n: n + nv] = arr[..., nv:]
    return out
