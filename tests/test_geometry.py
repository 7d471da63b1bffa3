"""Geometry layer parity vs the scipy oracle + basic invariants."""

import jax.numpy as jnp
import numpy as np

from manifold_flow_tpu.geometry import (
    synthetic,
    tangent_basis,
    project_to_plane,
    express_on_basis,
    position_diff_on_basis,
    topology,
)
from manifold_flow_tpu.geometry.fem_quantities import (
    hat_gradients,
    triangle_areas,
)
from manifold_flow_tpu.geometry.mesh import PAD_INDEX
from tests.oracle import reference_impl as ref


def test_tangent_basis_matches_oracle(curved_mesh):
    normals = np.asarray(curved_mesh.normals)
    got = np.asarray(tangent_basis(jnp.asarray(normals)))
    want = ref.orthonormal_basis_np(normals)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_tangent_basis_degenerate_normals():
    normals = jnp.asarray(
        [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
    )
    e = tangent_basis(normals)
    assert not np.any(np.isnan(np.asarray(e)))
    # Orthonormality and tangency.
    for i in range(normals.shape[0]):
        np.testing.assert_allclose(np.dot(e[i, 0], e[i, 1]), 0.0, atol=1e-12)
        np.testing.assert_allclose(np.dot(e[i, 0], normals[i]), 0.0, atol=1e-12)
        np.testing.assert_allclose(np.linalg.norm(e[i, 0]), 1.0, atol=1e-12)


def test_hat_gradients_match_oracle(curved_mesh):
    pts = np.asarray(curved_mesh.points)
    tris = np.asarray(curved_mesh.triangles)
    got = np.asarray(hat_gradients(jnp.asarray(pts), jnp.asarray(tris)))
    want = ref.hat_gradients_np(pts, tris)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_areas_match_oracle(curved_mesh):
    got = np.asarray(triangle_areas(curved_mesh.points, curved_mesh.triangles))
    want = ref.triangle_areas_np(
        np.asarray(curved_mesh.points), np.asarray(curved_mesh.triangles)
    )
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_projection_and_basis_roundtrip(curved_mesh):
    e = curved_mesh.basis
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=(curved_mesh.n_vertices, 3)))
    vt = project_to_plane(v, e[:, 0], e[:, 1])
    coef = express_on_basis(vt, e[:, 0], e[:, 1])
    back = coef[:, :1] * e[:, 0] + coef[:, 1:] * e[:, 1]
    np.testing.assert_allclose(np.asarray(back), np.asarray(vt), atol=1e-10)
    # Projection removes the normal component only.
    n = jnp.cross(e[:, 0], e[:, 1])
    np.testing.assert_allclose(
        np.asarray(jnp.sum(vt * n, axis=-1)), 0.0, atol=1e-10
    )


def test_position_diff_is_planar_coordinates(curved_mesh):
    e = curved_mesh.basis
    pts = curved_mesh.points
    uv = position_diff_on_basis(pts[10], pts[11], e[10, 0], e[10, 1])
    rel = np.asarray(pts[11] - pts[10])
    n = np.cross(np.asarray(e[10, 0]), np.asarray(e[10, 1]))
    proj = rel - np.dot(rel, n) * n / np.dot(n, n)
    np.testing.assert_allclose(
        np.asarray(uv),
        [np.dot(proj, np.asarray(e[10, 0])), np.dot(proj, np.asarray(e[10, 1]))],
        atol=1e-10,
    )


def test_adjacency_tables(small_mesh):
    vn = np.asarray(small_mesh.vertex_neighbors)
    deg = np.asarray(small_mesh.vertex_degree)
    tris = np.asarray(small_mesh.triangles)
    # Vertex 0 is a corner of the grid: neighbors are exactly those sharing a
    # triangle with it.
    want = sorted(set(tris[np.any(tris == 0, axis=1)].ravel()) - {0})
    got = sorted(vn[0, : deg[0]].tolist())
    assert got == want
    assert np.all(vn[0, deg[0]:] == PAD_INDEX)


def test_boundary_detection(small_mesh):
    b = np.asarray(small_mesh.boundary_vertex)
    pts = np.asarray(small_mesh.points)
    on_edge = (
        np.isclose(pts[:, 0], 0) | np.isclose(pts[:, 0], 6)
        | np.isclose(pts[:, 1], 0) | np.isclose(pts[:, 1], 6)
    )
    np.testing.assert_array_equal(b, on_edge)


def test_bfs_levels(small_mesh):
    levels = np.asarray(
        topology.bfs_levels(small_mesh.vertex_neighbors, jnp.int32(0), 3)
    )
    assert levels[0] == 0
    vn = np.asarray(small_mesh.vertex_neighbors)
    deg = np.asarray(small_mesh.vertex_degree)
    ring1 = set(vn[0, : deg[0]].tolist())
    assert all(levels[v] == 1 for v in ring1)
    # Ring 2 = neighbors-of-ring1 minus closer rings.
    ring2 = set()
    for v in ring1:
        ring2.update(vn[v, : deg[v]].tolist())
    ring2 -= ring1 | {0}
    assert all(levels[v] == 2 for v in ring2)
    assert np.all(levels[np.asarray(sorted(ring2))] == 2)
    assert np.sum(levels == -1) > 0  # beyond max_level


def test_closest_vertex(small_mesh):
    q = small_mesh.points[7] + 1e-3
    idx = topology.closest_vertex(small_mesh.points, q[None])
    assert int(idx[0]) == 7


def test_other_cell_across_edge(small_mesh):
    edges = np.asarray(small_mesh.edges)
    ecells = np.asarray(small_mesh.edge_cells)
    interior = np.where((ecells[:, 1] != PAD_INDEX))[0][0]
    va, vb = edges[interior]
    c0, c1 = ecells[interior]
    got = topology.other_cell_across_edge(
        small_mesh.edges, small_mesh.edge_cells,
        jnp.int32(c0), jnp.int32(va), jnp.int32(vb),
    )
    assert int(got) == c1
    boundary = np.where(ecells[:, 1] == PAD_INDEX)[0][0]
    va, vb = edges[boundary]
    got = topology.other_cell_across_edge(
        small_mesh.edges, small_mesh.edge_cells,
        jnp.int32(ecells[boundary, 0]), jnp.int32(va), jnp.int32(vb),
    )
    assert int(got) == PAD_INDEX


def test_geodesic_matrix_symmetric(small_mesh):
    d = topology.geodesic_distance_matrix(small_mesh, np.array([0, 5]))
    assert d.shape == (2, small_mesh.n_vertices)
    assert d[0, 0] == 0
    # Graph distance to an adjacent vertex equals the edge length.
    vn = np.asarray(small_mesh.vertex_neighbors)
    j = vn[0, 0]
    pts = np.asarray(small_mesh.points)
    np.testing.assert_allclose(d[0, j], np.linalg.norm(pts[j] - pts[0]))


def test_pad_mesh_already_aligned_is_noop():
    """A mesh whose shapes already sit on the bucket boundaries must pad to
    itself (regression: the zero-pad path returned read-only views and the
    inert-row writes crashed with 'assignment destination is read-only')."""
    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.geometry.mesh import pad_mesh

    mesh = synthetic.plane_patch(nx=8, ny=8, lx=4.0, ly=4.0)
    padded = pad_mesh(mesh, vertex_multiple=1, triangle_multiple=1,
                      table_multiple=1, edge_multiple=1)
    assert padded.n_vertices == mesh.n_vertices
    assert padded.n_triangles == mesh.n_triangles
    assert not padded.is_padded
    np.testing.assert_array_equal(np.asarray(padded.points),
                                  np.asarray(mesh.points))
    np.testing.assert_array_equal(np.asarray(padded.triangles),
                                  np.asarray(mesh.triangles))


def test_pad_mesh_parity_across_ops():
    """pad_mesh (fixed-shape program reuse): FEM solve,
    detection, streamlines, and winding give identical results on the padded
    mesh, with padding masked out."""
    import jax.numpy as jnp
    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.geometry.mesh import pad_mesh
    from manifold_flow_tpu.ops import singularity, streamline, winding
    from manifold_flow_tpu.ops.recombine import velocity_to_world
    from manifold_flow_tpu.solve.api import compute_velocity_fields

    mesh = synthetic.plane_patch(
        nx=13, ny=13, lx=6.0, ly=6.0,
        height=lambda x, y: 0.3 * np.sin(x) * np.cos(y))
    padded = pad_mesh(mesh, vertex_multiple=64, triangle_multiple=128)
    n, m = mesh.n_vertices, mesh.n_triangles
    np_, mp = padded.n_vertices, padded.n_triangles
    assert np_ % 64 == 0 and mp % 128 == 0 and np_ > n and mp > m
    assert padded.valid_vertices == n and padded.valid_triangles == m
    # Padding contributes nothing to geometry sums.
    np.testing.assert_allclose(
        float(jnp.sum(padded.areas)), float(jnp.sum(mesh.areas)), rtol=1e-12)
    # Real-vertex adjacency unchanged.
    deg = np.asarray(padded.vertex_degree[:n])
    np.testing.assert_array_equal(deg, np.asarray(mesh.vertex_degree))

    pot, times, truth = synthetic.two_source_movie(
        mesh, sources=((1.5, 1.5), (4.5, 4.5)), n_frames=5)
    pot_pad = np.zeros((pot.shape[0], np_), pot.dtype)
    pot_pad[:, :n] = pot

    ref = compute_velocity_fields(mesh, jnp.asarray(pot), jnp.asarray(times),
                                  method="cg", tol=1e-11)
    res = compute_velocity_fields(padded, jnp.asarray(pot_pad),
                                  jnp.asarray(times), method="cg", tol=1e-11)
    vk = np.asarray(res.v_k)
    np.testing.assert_allclose(vk[:, :n], np.asarray(ref.v_k)[:, :n],
                               atol=1e-8)
    np.testing.assert_allclose(vk[:, np_: np_ + n],
                               np.asarray(ref.v_k)[:, n:], atol=1e-8)
    assert not np.any(vk[:, n:np_]) and not np.any(vk[:, np_ + n:])

    v3 = np.asarray(velocity_to_world(ref.v_k, mesh.basis))
    v3_pad = np.zeros((v3.shape[0], np_, 3), v3.dtype)
    v3_pad[:, :n] = v3

    f_ref = singularity.detect(mesh, jnp.asarray(v3))
    f_pad = singularity.detect(padded, jnp.asarray(v3_pad))
    np.testing.assert_array_equal(np.asarray(f_pad.vertex_mask[:, :n]),
                                  np.asarray(f_ref.vertex_mask))
    assert not np.any(np.asarray(f_pad.vertex_mask[:, n:]))
    np.testing.assert_array_equal(np.asarray(f_pad.interior_mask[:, :m]),
                                  np.asarray(f_ref.interior_mask))
    assert not np.any(np.asarray(f_pad.interior_mask[:, m:]))

    sl_ref = streamline.trace(mesh, jnp.asarray(v3[2]), max_steps=64)
    sl_pad = streamline.trace(padded, jnp.asarray(v3_pad[2]), max_steps=64)
    np.testing.assert_array_equal(np.asarray(sl_pad.lengths[:n]),
                                  np.asarray(sl_ref.lengths))
    assert np.all(np.asarray(sl_pad.lengths[n:]) == 1)
    lines_ref = streamline.compact(mesh, sl_ref, min_length=4)
    lines_pad = streamline.compact(padded, sl_pad, min_length=4)
    assert len(lines_ref) == len(lines_pad)

    q = jnp.asarray(np.asarray(truth))
    valid = jnp.ones(len(truth), dtype=bool)
    w_ref = winding.analyze_singularities(mesh, jnp.asarray(v3[2]), q, valid,
                                          max_level=5)
    w_pad = winding.analyze_singularities(padded, jnp.asarray(v3_pad[2]), q,
                                          valid, max_level=5)
    np.testing.assert_array_equal(np.asarray(w_pad.counts),
                                  np.asarray(w_ref.counts))
    np.testing.assert_array_equal(np.asarray(w_pad.types),
                                  np.asarray(w_ref.types))
