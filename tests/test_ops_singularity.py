"""Singularity detection/classification parity vs the reference-style oracle."""

import jax.numpy as jnp
import numpy as np

from manifold_flow_tpu.geometry import synthetic
from manifold_flow_tpu.ops import singularity
from manifold_flow_tpu.ops.recombine import velocity_to_world
from manifold_flow_tpu.solve.api import compute_velocity_fields
from tests.oracle import analysis_impl as oracle


def _field(mesh, n_frames=4):
    pot, times, truth = synthetic.two_source_movie(mesh, n_frames=n_frames)
    res = compute_velocity_fields(mesh, jnp.asarray(pot), jnp.asarray(times),
                                  method="cg", tol=1e-12)
    v3 = velocity_to_world(res.v_k, mesh.basis)
    return np.asarray(v3), truth


def test_detection_matches_oracle():
    # Generic (bumpy) mesh: on a perfectly symmetric flat grid the field
    # zeros land exactly on triangle edges and the accept/reject decision
    # flips on 1e-15 rounding between np.linalg.lstsq and the closed-form
    # normal equations; a generic surface has strictly-interior zeros.
    mesh = synthetic.plane_patch(
        nx=16, ny=16, lx=10.0, ly=10.0,
        height=lambda x, y: 0.3 * np.sin(0.9 * x) * np.cos(0.7 * y))
    v3, _ = _field(mesh)
    field = singularity.detect(mesh, jnp.asarray(v3), eps=1e-4)
    pts = np.asarray(mesh.points)
    tris = np.asarray(mesh.triangles)
    for k in range(v3.shape[0]):
        want_v, want_i, want_vmax = oracle.find_singularities_np(
            pts, tris, v3[k], 1e-4)
        got_v = np.where(np.asarray(field.vertex_mask[k]))[0].tolist()
        assert got_v == want_v
        got_i = np.where(np.asarray(field.interior_mask[k]))[0].tolist()
        assert got_i == [m for m, *_ in want_i]
        np.testing.assert_allclose(float(field.v_max[k]), want_vmax)
        for (m, lam, mu, p) in want_i:
            np.testing.assert_allclose(
                np.asarray(field.interior_bary[k, m]), [lam, mu],
                rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(
                np.asarray(field.interior_point[k, m]), p,
                rtol=1e-8, atol=1e-10)


def test_detection_finds_two_sources():
    """End-to-end: the two-source benchmark recovers both emitters
    (the reference's simulated-data gate, SURVEY.md §4).

    Generic (bumpy) surface for the same reason as above: on the perfectly
    symmetric flat grid the emitters sit exactly on vertices and the
    detection decision flips on last-ulp rounding differences."""
    mesh = synthetic.plane_patch(
        nx=24, ny=24, lx=10.0, ly=10.0,
        height=lambda x, y: 0.15 * np.sin(0.8 * x) * np.cos(0.6 * y))
    v3, truth = _field(mesh, n_frames=4)
    field = singularity.detect(mesh, jnp.asarray(v3), eps=0.02)
    pts, kinds, ids = singularity.compact_frame(mesh, field, 1)
    assert len(pts) >= 2
    # Each true source has a detection within 1.5 grid cells.
    cell = 10.0 / 23
    for t in truth:
        d = np.linalg.norm(pts - t, axis=-1).min()
        assert d <= 1.5 * cell, f"source at {t} missed (nearest {d})"


def test_vertex_jacobian_matches_oracle():
    mesh = synthetic.plane_patch(nx=12, ny=12, lx=6.0, ly=6.0,
                                 height=lambda x, y: 0.1 * x * y)
    rng = np.random.default_rng(3)
    v3 = rng.normal(size=(2, mesh.n_vertices, 3))
    vmax = np.linalg.norm(v3, axis=-1).max(axis=-1)
    jv = np.asarray(singularity.vertex_jacobians(
        mesh, jnp.asarray(v3), jnp.asarray(vmax)))
    pts = np.asarray(mesh.points)
    e = np.asarray(mesh.basis)
    vn = np.asarray(mesh.vertex_neighbors)
    deg = np.asarray(mesh.vertex_degree)
    for k in (0, 1):
        for i in (0, 25, 77, 143):
            nbs = vn[i, : deg[i]]
            want = oracle.vertex_jacobian_np(
                pts, nbs, v3[k], vmax[k], e[i, 0], e[i, 1], i)
            np.testing.assert_allclose(jv[k, i], want, rtol=1e-9, atol=1e-11)


def test_classification_codes():
    # Canonical 2x2 Jacobians.
    node = jnp.asarray([[2.0, 0.0], [0.0, 1.0]])       # det>0, tr^2>4det
    focus = jnp.asarray([[0.1, -1.0], [1.0, 0.1]])     # det>0, tr^2<4det
    saddle = jnp.asarray([[1.0, 0.0], [0.0, -1.0]])    # det<0
    degen = jnp.asarray([[1.0, 0.0], [0.0, 0.0]])      # det==0
    jac = jnp.stack([node, focus, saddle, degen])
    codes = np.asarray(singularity.classify_jacobian(jac))
    assert [singularity.CLASS_NAMES[c] for c in codes] == [
        "Node", "Focus", "Saddle", "Indeterminate"]
    for j, name in [(node, "Node"), (focus, "Focus"), (saddle, "Saddle")]:
        assert oracle.classify_np(np.asarray(j)) == name


def test_classify_two_source_centers_are_nodes():
    """Flow out of a wave source has positive-definite Jacobian -> Node."""
    mesh = synthetic.plane_patch(nx=24, ny=24, lx=10.0, ly=10.0)
    v3, truth = _field(mesh, n_frames=4)
    field = singularity.detect(mesh, jnp.asarray(v3), eps=0.02)
    codes_v, codes_i = singularity.classify(mesh, jnp.asarray(v3), field)
    cv = np.asarray(codes_v[1])
    vm = np.asarray(field.vertex_mask[1])
    pts = np.asarray(mesh.points)
    for t in truth:
        # The singular vertex nearest this source should classify Node/Focus.
        cand = np.where(vm)[0]
        if len(cand) == 0:
            continue
        i = cand[np.argmin(np.linalg.norm(pts[cand] - t, axis=-1))]
        assert singularity.CLASS_NAMES[cv[i]] in ("Node", "Focus")


def test_classify_detected_matches_full():
    """Candidate-compacted classification equals the dense path at every
    detected candidate."""
    import jax.numpy as jnp

    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.ops import singularity

    mesh = synthetic.plane_patch(
        nx=16, ny=16, lx=8.0, ly=8.0,
        height=lambda x, y: 0.5 * np.sin(x) * np.cos(y))
    pot, times, _ = synthetic.two_source_movie(mesh, n_frames=5)
    from manifold_flow_tpu.solve.api import compute_velocity_fields
    from manifold_flow_tpu.ops.recombine import velocity_to_world

    res = compute_velocity_fields(mesh, jnp.asarray(pot), jnp.asarray(times),
                                  method="cg", tol=1e-10)
    v3 = velocity_to_world(res.v_k, res.e)
    field = singularity.detect(mesh, v3, eps=0.02)
    codes_v, codes_i = singularity.classify(mesh, v3, field)
    det = singularity.classify_detected(mesh, v3, field, capacity=64)
    cv, ci = np.asarray(codes_v), np.asarray(codes_i)
    for k in range(v3.shape[0]):
        for ids, valid, codes, dense in (
                (det.vertex_ids, det.vertex_valid, det.vertex_codes, cv),
                (det.interior_ids, det.interior_valid, det.interior_codes,
                 ci)):
            row = np.asarray(valid[k])
            for i in np.where(row)[0]:
                assert int(np.asarray(codes[k, i])) == int(
                    dense[k, int(np.asarray(ids[k, i]))])
    # Every detected candidate is covered at this capacity.
    assert int(np.asarray(field.vertex_mask).sum(axis=1).max()) <= 64
    assert int(np.asarray(field.interior_mask).sum(axis=1).max()) <= 64


def test_compact_all_matches_full_mask_fetch():
    """The device-side compaction (compact_detected) reproduces exactly the
    lists a host-side np.where over the full masks produces — same ids,
    same order (vertices first, ascending), same interior coordinates."""
    mesh = synthetic.plane_patch(
        nx=16, ny=16, lx=10.0, ly=10.0,
        height=lambda x, y: 0.3 * np.sin(0.9 * x) * np.cos(0.7 * y))
    v3, _ = _field(mesh)
    field = singularity.detect(mesh, jnp.asarray(v3), eps=1e-4)
    got = singularity.compact_all(mesh, field)
    vm = np.asarray(field.vertex_mask)
    im = np.asarray(field.interior_mask)
    ipts = np.asarray(field.interior_point)
    pts = np.asarray(mesh.points)
    assert len(got) == vm.shape[0]
    for k, (rows, kinds, ids) in enumerate(got):
        vid = np.where(vm[k])[0]
        mid = np.where(im[k])[0]
        assert ids == list(vid) + list(mid)
        assert kinds == ["vertex"] * len(vid) + ["interior"] * len(mid)
        np.testing.assert_allclose(
            rows, np.concatenate([pts[vid], ipts[k][mid]], axis=0))


def test_compact_all_centers_match_host_snap():
    """with_centers=True emits each singularity's snapped center vertex —
    identical to a host-side nearest-vertex argmin (vertex candidates snap
    to themselves, interior points to their nearest real vertex)."""
    mesh = synthetic.plane_patch(
        nx=16, ny=16, lx=10.0, ly=10.0,
        height=lambda x, y: 0.3 * np.sin(0.9 * x) * np.cos(0.7 * y))
    v3, _ = _field(mesh)
    field = singularity.detect(mesh, jnp.asarray(v3), eps=1e-4)
    got = singularity.compact_all(mesh, field, with_centers=True)
    pts = np.asarray(mesh.points)
    any_interior = False
    for rows, kinds, ids, centers in got:
        assert len(centers) == len(ids)
        for row, kind, idx, c in zip(rows, kinds, ids, centers):
            if kind == "vertex":
                assert int(c) == int(idx)
            else:
                any_interior = True
                want = int(((pts - row) ** 2).sum(-1).argmin())
                assert int(c) == want
    assert any_interior  # the fixture must actually exercise the snap


def test_detection_counts_empty_movie():
    """A degenerate 0-frame movie (single-frame input upstream) yields zero
    counts instead of a reduction-over-empty-axis error."""
    mesh = synthetic.plane_patch(nx=6, ny=6, lx=4.0, ly=4.0)
    v0 = jnp.zeros((0, mesh.n_vertices, 3))
    field, counts = singularity.detect_with_counts(mesh, v0)
    assert [int(c) for c in np.asarray(counts)] == [0, 0]
    assert field.vertex_mask.shape[0] == 0


def test_compact_capacity_buckets_to_eight():
    mesh = synthetic.plane_patch(
        nx=16, ny=16, lx=10.0, ly=10.0,
        height=lambda x, y: 0.3 * np.sin(0.9 * x) * np.cos(0.7 * y))
    v3, _ = _field(mesh)
    field = singularity.detect(mesh, jnp.asarray(v3), eps=1e-4)
    cap = singularity.compact_capacity(field)
    assert cap % 8 == 0
    vc, ic = singularity.detection_counts(field)
    assert cap >= max(int(vc), int(ic), 1)
