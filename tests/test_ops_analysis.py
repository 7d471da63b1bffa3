"""Parity tests for winding numbers, wave speeds, SVD, RBF, phases,
streamlines."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.interpolate
import scipy.signal

from manifold_flow_tpu.geometry import synthetic, topology
from manifold_flow_tpu.ops import (
    interpolate,
    phase,
    singularity,
    streamline,
    svd,
    validation,
    wavespeed,
    winding,
)
from manifold_flow_tpu.ops.recombine import (
    velocity_to_complex,
    velocity_to_world,
    world_speed,
)
from manifold_flow_tpu.solve.api import compute_velocity_fields
from tests.oracle import analysis_impl as oracle


@pytest.fixture(scope="module")
def source_setup():
    mesh = synthetic.plane_patch(nx=20, ny=20, lx=10.0, ly=10.0)
    pot, times, truth = synthetic.two_source_movie(mesh, n_frames=5)
    res = compute_velocity_fields(mesh, jnp.asarray(pot), jnp.asarray(times),
                                  method="cg", tol=1e-12)
    v3 = velocity_to_world(res.v_k, mesh.basis)
    return mesh, pot, times, truth, res, np.asarray(v3)


# ---------------------------------------------------------------- winding --
def test_ring_winding_matches_oracle(source_setup):
    mesh, _, _, truth, _, v3 = source_setup
    center = int(topology.closest_vertex(mesh.points, jnp.asarray(truth[0]))[()]
                 ) if truth[0].ndim else 0
    center = int(np.argmin(
        np.linalg.norm(np.asarray(mesh.points) - truth[0], axis=-1)))
    prof = np.asarray(winding.winding_profile(
        mesh, jnp.asarray(v3[2]), jnp.int32(center), max_level=6))
    levels = np.asarray(topology.bfs_levels(
        mesh.vertex_neighbors, jnp.int32(center), 6))
    e = np.asarray(mesh.basis)
    pts = np.asarray(mesh.points)
    for lvl in range(1, 7):
        ring = np.where(levels == lvl)[0]
        want = oracle.ring_winding_np(
            pts, v3[2], e[center, 0], e[center, 1], center, ring)
        np.testing.assert_allclose(prof[lvl - 1], want, rtol=1e-9, atol=1e-12)


def test_winding_radial_and_saddle_fields():
    """Analytic fields with known index: source (+1 every ring), saddle (-1),
    and a vortex-free shear field (no match -> type 0, count 0)."""
    mesh = synthetic.plane_patch(nx=21, ny=21, lx=10.0, ly=10.0)
    pts = np.asarray(mesh.points)
    center_pt = np.array([5.0, 5.0, 0.0])
    rel = pts - center_pt

    radial = np.zeros_like(pts)
    radial[:, :2] = rel[:, :2]
    saddle = np.zeros_like(pts)
    saddle[:, 0] = rel[:, 0]
    saddle[:, 1] = -rel[:, 1]
    shear = np.zeros_like(pts)
    shear[:, 0] = 1.0 + 0.1 * rel[:, 1]

    q = jnp.asarray(center_pt[None])
    valid = jnp.ones(1, dtype=bool)
    max_level = 6
    for field, want_type, want_count in [
        (radial, 1, max_level), (saddle, -1, max_level), (shear, 0, 0)]:
        r = winding.analyze_singularities(
            mesh, jnp.asarray(field), q, valid, max_level=max_level)
        assert int(r.types[0]) == want_type, (want_type, np.asarray(r))
        assert int(r.counts[0]) == want_count, (want_count, np.asarray(r))


def test_winding_movie_matches_per_frame(source_setup):
    """analyze_singularities_movie (unique-center dedup, one program) must
    equal per-frame analyze_singularities on every (frame, slot)."""
    mesh, _, _, truth, _, v3 = source_setup
    t, s = 3, 4
    rng = np.random.default_rng(3)
    pts = np.zeros((t, s, 3))
    valid = np.zeros((t, s), dtype=bool)
    for k in range(t):
        n_k = [2, 0, 3][k]  # includes an all-invalid frame
        pts[k, :n_k] = np.asarray(truth)[:1] + rng.normal(0, 0.4, (n_k, 3))
        valid[k, :n_k] = True
    movie = winding.analyze_singularities_movie(
        mesh, jnp.asarray(v3[:t]), pts, valid, max_level=6)
    for k in range(t):
        ref = winding.analyze_singularities(
            mesh, jnp.asarray(v3[k]), jnp.asarray(pts[k]),
            jnp.asarray(valid[k]), max_level=6)
        np.testing.assert_array_equal(np.asarray(movie.counts[k]),
                                      np.asarray(ref.counts))
        np.testing.assert_array_equal(np.asarray(movie.types[k]),
                                      np.asarray(ref.types))
        np.testing.assert_allclose(np.asarray(movie.winding_numbers[k]),
                                   np.asarray(ref.winding_numbers),
                                   rtol=1e-6, atol=1e-9)


def test_winding_movie_grid_matches_slots(source_setup, monkeypatch):
    """The two movie formulations (grid over unique centers x frames vs
    per-slot) must agree; the dispatcher picks by unique-center count."""
    mesh, _, _, truth, _, v3 = source_setup
    pts = np.asarray(truth)[None].repeat(3, axis=0)
    valid = np.ones(pts.shape[:2], dtype=bool)
    grid = winding.analyze_singularities_movie(
        mesh, jnp.asarray(v3[:3]), pts, valid, max_level=6)
    monkeypatch.setattr(winding, "_GRID_CHASE_RATIO", 0)
    slots = winding.analyze_singularities_movie(
        mesh, jnp.asarray(v3[:3]), pts, valid, max_level=6)
    np.testing.assert_array_equal(np.asarray(grid.counts),
                                  np.asarray(slots.counts))
    np.testing.assert_array_equal(np.asarray(grid.types),
                                  np.asarray(slots.types))
    np.testing.assert_allclose(np.asarray(grid.winding_numbers),
                               np.asarray(slots.winding_numbers),
                               rtol=1e-6, atol=1e-9)


def test_winding_movie_chunked_grid_matches(source_setup, monkeypatch):
    """When the (U, T, N) grid exceeds the memory cap, the center axis
    chunks across device calls instead of falling to the chase-class slots
    path — results identical to the one-shot grid."""
    mesh, _, _, truth, _, v3 = source_setup
    rng = np.random.default_rng(9)
    s = 8  # enough scattered queries that > 8 distinct centers snap
    base = np.asarray(truth)[:1]
    pts = base + rng.normal(0, 1.2, (3, s, 3))
    valid = np.ones((3, s), dtype=bool)
    # Sanity: the scenario really exercises > 1 chunk of 8 centers.
    mpts = np.asarray(mesh.points)
    d2 = ((pts.reshape(-1, 1, 3) - mpts[None]) ** 2).sum(-1)
    n_unique = len(np.unique(d2.argmin(axis=1)))
    assert n_unique > 8, n_unique
    want = winding.analyze_singularities_movie(
        mesh, jnp.asarray(v3[:3]), pts, valid, max_level=6)
    # Cap small enough to force chunks of 8 centers each.
    monkeypatch.setattr(winding, "_GRID_MAX_ELEMS",
                        8 * 3 * mesh.n_vertices)
    got = winding.analyze_singularities_movie(
        mesh, jnp.asarray(v3[:3]), pts, valid, max_level=6)
    np.testing.assert_array_equal(np.asarray(want.counts),
                                  np.asarray(got.counts))
    np.testing.assert_array_equal(np.asarray(want.types),
                                  np.asarray(got.types))
    np.testing.assert_allclose(np.asarray(want.winding_numbers),
                               np.asarray(got.winding_numbers),
                               rtol=1e-6, atol=1e-9)


def test_winding_chunk_math_at_long_trial_scale():
    """Pin the grid-chunk arithmetic at the reference's upper frame count:
    T=391 frames at the 12.5k bench mesh leaves the center-axis chunk at
    EXACTLY 8 — its floor, still >= the minimum bucket so the chunked grid
    (not the chase-class slots fallback) runs. One more
    vertex-count doubling drops the chunk below 8 and the dispatcher must
    fall back to slots; the 3.1k/T=391 case chunks at 48."""
    cap = winding._GRID_MAX_ELEMS

    def chunk(t, n):
        return (cap // (t * n)) // 8 * 8

    assert chunk(391, 12544) == 8          # long trial, 12.5k mesh: floor
    assert chunk(97, 12544) == 48          # r4 production case
    assert chunk(391, 3136) == 48          # long trial, reference mesh
    assert chunk(391, 2 * 12544) < 8       # beyond the cap -> slots path
    # The dispatcher's exact condition (ops/winding.py): grid runs only
    # while a chunk of >= 8 centers fits the memory cap.
    for t, n in ((391, 12544), (97, 12544), (391, 3136)):
        assert chunk(t, n) >= 8
    assert not chunk(391, 2 * 12544) >= 8


def test_winding_movie_chunk_floor_matches(source_setup, monkeypatch):
    """At the chunk floor (exactly 8 centers per chunk — the T=391 x 12.5k
    configuration's arithmetic), the chunked grid still matches the
    one-shot grid; one notch below the floor, the slots fallback runs and
    matches too."""
    mesh, _, _, truth, _, v3 = source_setup
    rng = np.random.default_rng(11)
    pts = np.asarray(truth)[:1] + rng.normal(0, 1.2, (3, 10, 3))
    valid = np.ones((3, 10), dtype=bool)
    want = winding.analyze_singularities_movie(
        mesh, jnp.asarray(v3[:3]), pts, valid, max_level=6)
    t, n = 3, mesh.n_vertices
    # chunk == 8 exactly (the floor): 8 <= cap/(t*n) < 16.
    monkeypatch.setattr(winding, "_GRID_MAX_ELEMS", 8 * t * n)
    got = winding.analyze_singularities_movie(
        mesh, jnp.asarray(v3[:3]), pts, valid, max_level=6)
    np.testing.assert_array_equal(np.asarray(want.counts),
                                  np.asarray(got.counts))
    np.testing.assert_allclose(np.asarray(want.winding_numbers),
                               np.asarray(got.winding_numbers),
                               rtol=1e-6, atol=1e-9)
    # chunk < 8: the dispatcher must take the memory-safe slots path.
    monkeypatch.setattr(winding, "_GRID_MAX_ELEMS", 7 * t * n)
    slots = winding.analyze_singularities_movie(
        mesh, jnp.asarray(v3[:3]), pts, valid, max_level=6)
    np.testing.assert_array_equal(np.asarray(want.counts),
                                  np.asarray(slots.counts))
    np.testing.assert_allclose(np.asarray(slots.winding_numbers),
                               np.asarray(want.winding_numbers),
                               rtol=1e-6, atol=1e-9)


def test_winding_movie_precomputed_centers_match(source_setup):
    """Passing precomputed snapped centers (the detection stage's device
    output) yields results identical to the host-snap path."""
    mesh, _, _, truth, _, v3 = source_setup
    t, s = 3, 4
    rng = np.random.default_rng(5)
    pts = np.zeros((t, s, 3))
    valid = np.zeros((t, s), dtype=bool)
    for k in range(t):
        n_k = [1, 3, 2][k]
        pts[k, :n_k] = np.asarray(truth)[:1] + rng.normal(0, 0.4, (n_k, 3))
        valid[k, :n_k] = True
    mpts = np.asarray(mesh.points)
    d2 = ((pts.reshape(-1, 1, 3) - mpts[None]) ** 2).sum(-1)
    centers = d2.argmin(axis=1).astype(np.int32).reshape(t, s)
    host = winding.analyze_singularities_movie(
        mesh, jnp.asarray(v3[:t]), pts, valid, max_level=6)
    pre = winding.analyze_singularities_movie(
        mesh, jnp.asarray(v3[:t]), pts, valid, max_level=6,
        centers=centers)
    np.testing.assert_array_equal(np.asarray(host.counts),
                                  np.asarray(pre.counts))
    np.testing.assert_array_equal(np.asarray(host.types),
                                  np.asarray(pre.types))
    np.testing.assert_allclose(np.asarray(host.winding_numbers),
                               np.asarray(pre.winding_numbers),
                               rtol=1e-6, atol=1e-9)


def test_winding_movie_empty():
    mesh = synthetic.plane_patch(nx=8, ny=8, lx=4.0, ly=4.0)
    v = jnp.zeros((2, mesh.n_vertices, 3))
    r = winding.analyze_singularities_movie(
        mesh, v, np.zeros((2, 0, 3)), np.zeros((2, 0), bool), max_level=4)
    assert r.counts.shape == (2, 0)
    r2 = winding.analyze_singularities_movie(
        mesh, v, np.zeros((2, 3, 3)), np.zeros((2, 3), bool), max_level=4)
    assert np.all(np.asarray(r2.counts) == 0)


def test_winding_profile_interference_is_local(source_setup):
    """At a two-source interference field only ring 1 is reliably +1 — the
    op must report type +1 with a small persistence count, not force +1."""
    mesh, _, _, truth, _, v3 = source_setup
    result = winding.analyze_singularities(
        mesh, jnp.asarray(v3[2]), jnp.asarray(truth),
        jnp.ones(len(truth), dtype=bool), max_level=8)
    types = np.asarray(result.types)
    counts = np.asarray(result.counts)
    assert np.all(types == 1), types
    assert np.all(counts >= 1), counts


# -------------------------------------------------------------- wavespeed --
def test_vertex_gradients_match_oracle(source_setup):
    mesh, pot, _, _, _, _ = source_setup
    got = np.asarray(wavespeed.vertex_gradients(mesh, jnp.asarray(pot[:2])))
    want = oracle.vertex_gradients_np(
        np.asarray(mesh.points), np.asarray(mesh.triangles), pot[:2],
        np.asarray(mesh.areas), np.asarray(mesh.vertex_cells))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


def test_wave_speed_plane_wave():
    """For I = cos(k.x - w t): |dI/dt| / |grad I| = w/|k| everywhere."""
    mesh = synthetic.plane_patch(nx=24, ny=24, lx=12.0, ly=12.0)
    # Long wavelength relative to the grid: the P1 gradient magnitude has a
    # sinc-like discretization factor (~1 - (kh)^2/6), so keep kh small.
    omega, kvec = 1.0, (0.4, 0.2, 0.0)
    pot, times = synthetic.plane_wave_movie(
        mesh, n_frames=12, wave_vector=kvec, omega=omega, dt=0.05)
    ws = np.asarray(wavespeed.wave_velocity_amplitude(
        mesh, jnp.asarray(pot), 0.05))
    pts = np.asarray(mesh.points)
    interior = ((pts[:, 0] > 2) & (pts[:, 0] < 10)
                & (pts[:, 1] > 2) & (pts[:, 1] < 10))
    expected = omega / np.linalg.norm(kvec)
    med = np.median(np.abs(ws[5, interior]))
    assert abs(med - expected) / expected < 0.03, (med, expected)


def test_phase_gradient_wraps():
    data = jnp.asarray(np.array([[3.1, -3.1], [-3.1, 3.1], [3.0, -3.0]]))
    g = np.asarray(phase.temporal_gradient_phase(data, 1.0))
    # 3.1 -> -3.1 crosses the wrap: true step is +~0.083, not -6.2.
    assert abs(g[0, 0] - (2 * np.pi - 6.2)) < 1e-9
    assert g.shape == data.shape


def test_hilbert_matches_scipy():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(50, 6))
    got = np.asarray(phase.hilbert(jnp.asarray(x), axis=0))
    want = scipy.signal.hilbert(x, axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)
    got_last = np.asarray(phase.hilbert(jnp.asarray(x[:, :5]), axis=-1))
    want_last = scipy.signal.hilbert(x[:, :5])  # scipy default axis=-1
    np.testing.assert_allclose(got_last, want_last, rtol=1e-9, atol=1e-10)


# -------------------------------------------------------------------- svd --
def test_svd_complex_matches_numpy(source_setup):
    _, _, _, _, res, _ = source_setup
    v_k = np.asarray(res.v_k)
    modes = svd.decompose_complex(jnp.asarray(v_k), n_modes=4)
    n = v_k.shape[1] // 2
    movie = v_k[:, :n] + 1j * v_k[:, n:]
    u, s, vt = np.linalg.svd(movie, full_matrices=False)
    np.testing.assert_allclose(np.asarray(modes.sigma), s[:4], rtol=1e-9)
    # Reconstruction through the kept modes matches numpy's.
    rec_got = np.asarray(modes.u) @ np.diag(np.asarray(modes.sigma)) @ np.asarray(modes.vt)
    rec_want = u[:, :4] @ np.diag(s[:4]) @ vt[:4]
    np.testing.assert_allclose(rec_got, rec_want, rtol=1e-7, atol=1e-9)
    # Sign convention: kept temporal modes have non-negative mean real part.
    assert np.all(np.mean(np.real(np.asarray(modes.u)), axis=0) >= -1e-12)


def _svd_complex_vs_numpy(movie, k):
    v_k = np.concatenate([movie.real, movie.imag], axis=1)
    modes = svd.decompose_complex(jnp.asarray(v_k), k)
    u_ref, s_ref, vt_ref = np.linalg.svd(movie, full_matrices=False)
    return (np.asarray(modes.u), np.asarray(modes.sigma), np.asarray(modes.vt),
            u_ref, s_ref, vt_ref)


def test_svd_complex_degenerate_singular_values():
    """Repeated singular values: the kept temporal modes are an arbitrary
    basis of each degenerate group, so only gauge-free quantities are
    compared with numpy — singular values, orthonormality and the rank-k
    reconstruction."""
    rng = np.random.default_rng(7)
    t, n, k = 12, 40, 6
    uq, _ = np.linalg.qr(rng.normal(size=(t, t))
                         + 1j * rng.normal(size=(t, t)))
    vq, _ = np.linalg.qr(rng.normal(size=(n, t))
                         + 1j * rng.normal(size=(n, t)))
    sig = np.array([5.0, 3.0, 3.0, 3.0, 2.0, 2.0] + [1.0] * (t - 6))
    movie = (uq * sig) @ vq.conj().T
    u, s, vt, u_ref, s_ref, vt_ref = _svd_complex_vs_numpy(movie, k)
    np.testing.assert_allclose(s, s_ref[:k], rtol=1e-12)
    np.testing.assert_allclose(u.conj().T @ u, np.eye(k), atol=1e-12)
    rec_got = u @ np.diag(s) @ vt
    rec_want = u_ref[:, :k] @ np.diag(s_ref[:k]) @ vt_ref[:k]
    np.testing.assert_allclose(rec_got, rec_want,
                               atol=1e-12 * np.abs(rec_want).max())
    assert np.all(np.mean(np.real(u), axis=0) >= -1e-12)


def test_svd_complex_rank_deficient():
    """A rank-3 movie: all min(T, N) modes come back (n_modes=None), the
    singular values past the rank are numerically zero, every factor is
    finite, and the full reconstruction is exact."""
    rng = np.random.default_rng(8)
    t, n, rank = 10, 30, 3
    movie = ((rng.normal(size=(t, rank)) + 1j * rng.normal(size=(t, rank)))
             @ (rng.normal(size=(rank, n)) + 1j * rng.normal(size=(rank, n))))
    u, s, vt, _, s_ref, _ = _svd_complex_vs_numpy(movie, None)
    assert s.shape[0] == min(t, n)
    np.testing.assert_allclose(s[:rank], s_ref[:rank], rtol=1e-12)
    assert s[rank:].max() <= 1e-12 * s[0]
    assert np.all(np.isfinite(u)) and np.all(np.isfinite(vt))
    np.testing.assert_allclose(u @ np.diag(s) @ vt, movie,
                               atol=1e-12 * np.abs(movie).max())


def test_svd_concat_matches_numpy(source_setup):
    """Concatenated-real SVD against numpy.linalg.svd: equal singular
    values, equal rank-k reconstruction, unit temporal modes and the
    non-negative-mean sign convention."""
    _, _, _, _, res, _ = source_setup
    v_k = np.asarray(res.v_k)
    k = 4
    modes = svd.decompose_concat(jnp.asarray(v_k), k)
    u, s, vt = (np.asarray(modes.u), np.asarray(modes.sigma),
                np.asarray(modes.vt))
    u_ref, s_ref, vt_ref = np.linalg.svd(v_k, full_matrices=False)
    np.testing.assert_allclose(s, s_ref[:k], rtol=1e-10)
    rec_got = u @ np.diag(s) @ vt
    rec_want = u_ref[:, :k] @ np.diag(s_ref[:k]) @ vt_ref[:k]
    np.testing.assert_allclose(rec_got, rec_want,
                               atol=1e-10 * np.abs(rec_want).max())
    assert np.all(np.mean(u, axis=0) >= -1e-12)
    np.testing.assert_allclose(np.linalg.norm(u, axis=0), 1.0, rtol=1e-12)


def test_svd_concat_energy(source_setup):
    _, _, _, _, res, _ = source_setup
    modes = svd.decompose_concat(res.v_k)
    pct2 = np.asarray(modes.pct_squared)
    assert abs(pct2.sum() - 100.0) < 0.5
    # Mode energies sorted descending.
    s = np.asarray(modes.sigma)
    assert np.all(np.diff(s) <= 1e-12)
    # Complex reconstruction from concat halves == complex movie modes.
    c = svd.concat_modes_to_complex(modes.vt)
    assert c.shape == (modes.vt.shape[0], res.v_k.shape[1] // 2)


def test_mode_to_world_matches_recombine(source_setup):
    mesh, _, _, _, res, _ = source_setup
    movie = velocity_to_complex(res.v_k)
    w = np.asarray(svd.mode_to_world(movie[0], mesh.basis))
    want = np.asarray(velocity_to_world(res.v_k[:1], mesh.basis))[0]
    np.testing.assert_allclose(w, want, rtol=1e-10, atol=1e-12)


# -------------------------------------------------------------------- rbf --
def test_rbf_matches_scipy():
    rng = np.random.default_rng(11)
    coords = rng.uniform(0, 10, size=(40, 3))
    targets = rng.uniform(0, 10, size=(150, 3))
    values = np.sin(coords[:, 0]) + coords[:, 1] * 0.2
    got = np.asarray(interpolate.rbf_interpolate(
        jnp.asarray(coords), jnp.asarray(values[None]), jnp.asarray(targets)))[0]
    rbf = scipy.interpolate.Rbf(coords[:, 0], coords[:, 1], coords[:, 2], values)
    want = rbf(targets[:, 0], targets[:, 1], targets[:, 2])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_rbf_complex_unit_circle():
    rng = np.random.default_rng(13)
    coords = rng.uniform(0, 10, size=(30, 3))
    targets = coords[:10]
    phases_in = rng.uniform(-np.pi, np.pi, size=(3, 30))
    values = np.exp(1j * phases_in)
    got = np.asarray(interpolate.rbf_interpolate(
        jnp.asarray(coords), jnp.asarray(values), jnp.asarray(targets)))
    # Interpolation at the sample sites reproduces the samples.
    np.testing.assert_allclose(got, values[:, :10], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        np.angle(got), phases_in[:, :10], rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- streamline --
def test_streamlines_follow_plane_flow():
    """Uniform +x flow on a flat patch: streamlines march straight in +x."""
    mesh = synthetic.plane_patch(nx=16, ny=16, lx=8.0, ly=8.0)
    v3 = np.zeros((mesh.n_vertices, 3))
    v3[:, 0] = 1.0
    sl = streamline.trace(mesh, jnp.asarray(v3), max_steps=40)
    lines = streamline.compact(mesh, sl, min_length=5)
    assert len(lines) > 0
    for line in lines[:10]:
        dx = np.diff(line[:, 0])
        dy = np.diff(line[:, 1])
        assert np.all(dx > 0)           # monotone in +x
        assert np.all(np.abs(dy) < 1e-9)  # no drift on a regular grid
    # Left-column seeds walk all the way across the patch.
    max_len = max(len(l) for l in lines)
    assert max_len >= 15


def test_streamlines_stop_at_revisit_and_boundary(source_setup):
    mesh, _, _, _, _, v3 = source_setup
    sl = streamline.trace(mesh, jnp.asarray(v3[2]), max_steps=64)
    verts = np.asarray(sl.vertices)
    lengths = np.asarray(sl.lengths)
    # No repeated vertex within any streamline.
    for i in range(0, verts.shape[0], 37):
        ids = verts[i, : lengths[i]]
        assert len(set(ids.tolist())) == len(ids)


# ------------------------------------------------------------- validation --
def test_validation_scores_two_source(source_setup):
    mesh, _, _, truth, _, v3 = source_setup
    field = singularity.detect(mesh, jnp.asarray(v3), eps=0.02)
    detected = []
    for k in range(v3.shape[0]):
        pts, _, _ = singularity.compact_frame(mesh, field, k)
        detected.append(pts)
    truth_per_frame = [truth] * len(detected)
    report = validation.score_all_frames(
        mesh, detected, truth_per_frame, threshold=2.0,
        turning_point=len(detected))
    assert report.matched >= len(detected)  # quirk: +1 per frame
    assert report.err_max <= 2.0


def test_speed_map(source_setup):
    _, _, _, _, res, v3 = source_setup
    sp = np.asarray(world_speed(jnp.asarray(v3)))
    assert sp.shape == v3.shape[:2]
    np.testing.assert_allclose(sp[0, 0], np.linalg.norm(v3[0, 0]))


def test_winding_scale_map(small_mesh):
    """calculate_scale_values parity (S7:167-183): center = count+1, ring k
    = count-(k-1), later singularities overwrite."""
    import numpy as np
    from manifold_flow_tpu.ops import winding

    pts = np.asarray(small_mesh.points)[[40, 90]]
    s = np.asarray(winding.scale_map(small_mesh, pts, np.array([2, 1])))
    assert s[40] == 3.0 and s[90] == 2.0
    ring1 = np.asarray(small_mesh.vertex_neighbors[40])
    ring1 = ring1[ring1 >= 0]
    assert np.all(s[ring1] >= 1.0)


def test_winding_scale_map_matches_sequential(small_mesh):
    """The batched scale_map equals the reference's sequential overwrite
    loop (S7:167-183) on overlapping singularities."""
    import numpy as np
    from manifold_flow_tpu.geometry import topology
    from manifold_flow_tpu.ops import winding

    pts_all = np.asarray(small_mesh.points)
    centers = [40, 41, 90, 40]          # overlapping rings + repeated center
    counts = np.array([3, 2, 1, 0])
    pts = pts_all[centers]

    # Sequential oracle (the reference's loop order: center, then rings).
    levels = np.stack([
        np.asarray(topology.bfs_levels(
            small_mesh.vertex_neighbors, np.int32(c), 3)) for c in centers])
    want = np.zeros(pts_all.shape[0])
    for i, c in enumerate(centers):
        want[c] = counts[i] + 1
        ring = (levels[i] >= 1) & (levels[i] <= counts[i])
        want[ring] = counts[i] - (levels[i][ring] - 1)
    got = np.asarray(winding.scale_map(small_mesh, pts, counts))
    np.testing.assert_allclose(got, want)
    # Empty list: all zeros, no device dispatch needed.
    empty = np.asarray(winding.scale_map(
        small_mesh, np.zeros((0, 3)), np.zeros((0,), dtype=np.int32)))
    assert not empty.any()


# --------------------------------------------------------------- quirks ----
def test_nearest_edge_quirk_matches_oracle():
    """_nearest_edge reproduces find_nearest_edge_and_vertices' flat-argmin
    quirk (:318-351) exactly, and true distances when quirks=False."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=(40, 3))
    b = a + rng.normal(size=(40, 3))
    c = a + rng.normal(size=(40, 3))
    w = rng.dirichlet(np.ones(3), size=40)
    p = w[:, :1] * a + w[:, 1:2] * b + w[:, 2:] * c
    for quirk in (False, True):
        got = np.asarray(singularity._nearest_edge(
            jnp.asarray(p), jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
            quirks=quirk))
        want = [oracle.nearest_edge_np(a[i], b[i], c[i], p[i], quirk=quirk)
                for i in range(40)]
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("quirk", [False, True])
def test_streamline_walks_match_reference_rule(source_setup, quirk):
    """Full-walk parity with the reference's greedy rule (S6:51-138) on a
    boundary-heavy curved patch, in both fixed and quirk modes."""
    mesh, _, _, _, _, v3 = source_setup
    v = v3[2]
    sl = streamline.trace(mesh, jnp.asarray(v), max_steps=mesh.n_vertices,
                          quirks=quirk)
    verts = np.asarray(sl.vertices)
    lengths = np.asarray(sl.lengths)
    pts = np.asarray(mesh.points)
    nrm = np.asarray(mesh.normals)
    nb = np.asarray(mesh.vertex_neighbors)
    cells = np.asarray(mesh.vertex_cells)
    tris = np.asarray(mesh.triangles)
    for seed in range(0, mesh.n_vertices, 7):
        want = oracle.streamline_walk_np(
            pts, nrm, nb, cells, tris, v, seed, quirk=quirk)
        assert lengths[seed] == len(want), (seed, lengths[seed], len(want))
        np.testing.assert_array_equal(verts[seed, :len(want)], want)


def test_streamline_adaptive_window_matches_fixed(source_setup):
    """trace_frames_adaptive must equal the full-cap tracer, including when
    the tiny initial window forces the compact escalation retrace (walks
    longer than the window come back through the overlay)."""
    mesh, _, _, _, _, v3 = source_setup
    v = jnp.asarray(v3[:3])
    n = mesh.n_vertices
    full = streamline.trace_frames(mesh, v, max_steps=256)
    fl = np.asarray(full.lengths)
    fv = np.asarray(full.vertices)
    for win in (2, 16, 64):  # 2/16 force the retrace; 64 resolves in one
        ada = streamline.trace_frames_adaptive(mesh, v, max_steps=256,
                                               initial_window=win,
                                               auto_plan=False)
        np.testing.assert_array_equal(np.asarray(ada.lengths), fl)
        av = np.asarray(ada.vertices)
        omap = {}
        if ada.overlay_ids is not None:
            ov = np.asarray(ada.overlay_vertices)
            omap = {int(s): j
                    for j, s in enumerate(np.asarray(ada.overlay_ids))}
            # Escalation only retraces walks the window truncated.
            assert all(fl.ravel()[s] > win + 1 or fl.ravel()[s] == win + 1
                       for s in omap)
        for t in range(fl.shape[0]):
            for i in range(0, n, 11):
                length = fl[t, i]
                flat = t * n + i
                row = ov[omap[flat]] if flat in omap else av[t, i]
                np.testing.assert_array_equal(row[:length],
                                              fv[t, i, :length])
        if win == 2:
            assert omap, "window 2 must have produced overlay retraces"


@pytest.mark.parametrize("quirk", [False, True])
def test_streamline_boundary_fast_path_matches_full(source_setup, quirk):
    """The boundary-row fast path (shared-cell/triangle tests evaluated only
    on non-interior vertices) must equal the full evaluation exactly."""
    mesh, _, _, _, _, v3 = source_setup
    v = jnp.asarray(v3[:2])
    with_b = streamline._trace_frames_graph(
        mesh, v, max_steps=64, quirks=quirk,
        boundary=streamline.boundary_indices(mesh))[0]
    full = streamline._trace_frames_graph(
        mesh, v, max_steps=64, quirks=quirk, boundary=None)[0]
    np.testing.assert_array_equal(np.asarray(with_b.lengths),
                                  np.asarray(full.lengths))
    np.testing.assert_array_equal(np.asarray(with_b.vertices),
                                  np.asarray(full.vertices))


def test_streamline_stage_overlay_polylines(source_setup):
    """The pipeline stage must stitch overlay walks into full polylines: a
    tiny initial window and a permissive min length give the same line set
    as the fixed full-cap tracer."""
    from manifold_flow_tpu.pipeline.config import PipelineConfig

    mesh, _, _, _, _, v3 = source_setup
    v = jnp.asarray(v3[:2])
    full = streamline.trace_frames(mesh, v, max_steps=256)
    want = {
        t: streamline.compact(
            mesh,
            streamline.Streamlines(vertices=np.asarray(full.vertices)[t],
                                   lengths=np.asarray(full.lengths)[t]),
            min_length=4)
        for t in range(2)
    }
    ada = streamline.trace_frames_adaptive(mesh, v, max_steps=256,
                                           initial_window=2,
                                           auto_plan=False)
    n = mesh.n_vertices
    ov_ids = np.asarray(ada.overlay_ids)
    ov_v = np.asarray(ada.overlay_vertices)[: len(ov_ids)]
    for t in range(2):
        m = (ov_ids // n) == t
        sl = streamline.Streamlines(
            vertices=np.asarray(ada.vertices)[t],
            lengths=np.asarray(ada.lengths)[t],
            overlay_ids=ov_ids[m] % n, overlay_vertices=ov_v[m])
        got = streamline.compact(mesh, sl, min_length=4)
        assert len(got) == len(want[t])
        for a, b in zip(got, want[t]):
            np.testing.assert_array_equal(a, b)


def test_compact_frames_matches_per_frame_compact(source_setup):
    """compact_frames (filtered device fetch) returns exactly the per-frame
    compact() line sets, overlay stitching included."""
    mesh, _, _, _, _, v3 = source_setup
    v = jnp.asarray(v3[:2])
    ada = streamline.trace_frames_adaptive(mesh, v, max_steps=256,
                                           initial_window=2,
                                           auto_plan=False)
    got = streamline.compact_frames(mesh, ada, min_length=4)
    n = mesh.n_vertices
    ov_ids = np.asarray(ada.overlay_ids)
    ov_v = np.asarray(ada.overlay_vertices)[: len(ov_ids)]
    for t in range(2):
        m = (ov_ids // n) == t
        sl = streamline.Streamlines(
            vertices=np.asarray(ada.vertices)[t],
            lengths=np.asarray(ada.lengths)[t],
            overlay_ids=ov_ids[m] % n, overlay_vertices=ov_v[m])
        want = streamline.compact(mesh, sl, min_length=4)
        assert len(got[t]) == len(want)
        for a, b in zip(got[t], want):
            np.testing.assert_array_equal(a, b)

    # No-overlay movies take the pure base-row path.
    full = streamline.trace_frames(mesh, v, max_steps=256)
    got_full = streamline.compact_frames(mesh, full, min_length=4)
    for t in range(2):
        want = streamline.compact(
            mesh,
            streamline.Streamlines(vertices=np.asarray(full.vertices)[t],
                                   lengths=np.asarray(full.lengths)[t]),
            min_length=4)
        assert len(got_full[t]) == len(want)
        for a, b in zip(got_full[t], want):
            np.testing.assert_array_equal(a, b)


def test_streamline_quirk_changes_boundary_walks():
    """The two modes must actually differ somewhere on a boundary-heavy
    random field (otherwise the quirk flag tests nothing) — and the quirk
    walks still match the reference-rule oracle."""
    mesh = synthetic.plane_patch(nx=20, ny=20, lx=10.0, ly=10.0)
    rng = np.random.default_rng(4)
    v = rng.normal(size=(mesh.n_vertices, 3))
    v[:, 2] = 0.0
    a = streamline.trace(mesh, jnp.asarray(v),
                         max_steps=mesh.n_vertices, quirks=False)
    b = streamline.trace(mesh, jnp.asarray(v),
                         max_steps=mesh.n_vertices, quirks=True)
    la, lb = np.asarray(a.lengths), np.asarray(b.lengths)
    assert not np.array_equal(la, lb)
    verts_b = np.asarray(b.vertices)
    for seed in np.where(la != lb)[0]:
        want = oracle.streamline_walk_np(
            np.asarray(mesh.points), np.asarray(mesh.normals),
            np.asarray(mesh.vertex_neighbors), np.asarray(mesh.vertex_cells),
            np.asarray(mesh.triangles), v, int(seed), quirk=True)
        assert lb[seed] == len(want)
        np.testing.assert_array_equal(verts_b[seed, :len(want)], want)


def test_streamline_planned_schedule_matches(source_setup, monkeypatch):
    """Second trace of a mesh runs the stats-planned schedule (fused
    device-side seed compaction + pipelined retrace when escalations are
    expected) — results identical to the full-cap tracer."""
    mesh, _, _, _, _, v3 = source_setup
    v = jnp.asarray(v3[:3])
    monkeypatch.setattr(streamline, "_STATS_CACHE", {})
    # Zero the dispatch-equivalent constant so the gather-traffic model
    # picks a genuine two-pass schedule at unit-test scale (with it, one
    # dispatch outweighs every gather at 1.2k seeds and the plan collapses
    # to a single wide pass — correct on hardware, untestable here).
    monkeypatch.setattr(streamline, "_DISPATCH_GATHER_EQUIV", 0.0)
    full = streamline.trace_frames(mesh, v, max_steps=256)
    fl = np.asarray(full.lengths)
    p0: dict = {}
    streamline.trace_frames_adaptive(mesh, v, max_steps=256,
                                     initial_window=4, plan_out=p0)
    assert not p0["planned"]
    plan: dict = {}
    ada = streamline.trace_frames_adaptive(mesh, v, max_steps=256,
                                           plan_out=plan)
    assert plan["planned"]
    np.testing.assert_array_equal(np.asarray(ada.lengths), fl)
    # Line-set parity through the public compaction path.
    want = streamline.compact_frames(mesh, full, min_length=4)
    got = streamline.compact_frames(mesh, ada, min_length=4)
    for a_f, b_f in zip(want, got):
        assert len(a_f) == len(b_f)
        for a, b in zip(a_f, b_f):
            np.testing.assert_array_equal(a, b)


def test_streamline_planned_capacity_overflow(source_setup, monkeypatch):
    """Stats that underestimate the escalation count force the pipelined
    pass's seed capacity to overflow; the uncovered tail must escalate
    through the host loop with exact parity."""
    mesh, _, _, _, _, v3 = source_setup
    v = jnp.asarray(v3[:3])
    n = mesh.n_vertices
    full = streamline.trace_frames(mesh, v, max_steps=256)
    fl = np.asarray(full.lengths)
    # Fake histogram: claims almost every walk resolves by 8, a few reach
    # 100 — plans a small w1 with a tiny escalation cap, while the real
    # field escalates far more seeds.
    hist = np.zeros(101, np.int64)
    hist[4] = 3 * n - 12
    hist[100] = 12
    key = (id(mesh.vertex_neighbors), False)
    monkeypatch.setattr(streamline, "_STATS_CACHE",
                        {key: (mesh.vertex_neighbors, 3 * n, hist)})
    # At unit-test scale the dispatch-equivalent constant makes a single
    # wide pass always win; zero it so the planner picks the two-pass
    # pipelined schedule this test exists to exercise.
    monkeypatch.setattr(streamline, "_DISPATCH_GATHER_EQUIV", 0.0)
    plan: dict = {}
    ada = streamline.trace_frames_adaptive(mesh, v, max_steps=256,
                                           plan_out=plan)
    assert plan["planned"] and plan["cap"] > 0
    # The scenario must actually overflow the planned capacity.
    true_escal = int((fl > plan["w1"]).sum())
    assert true_escal > plan["cap"], (true_escal, plan)
    np.testing.assert_array_equal(np.asarray(ada.lengths), fl)
    want = streamline.compact_frames(mesh, full, min_length=4)
    got = streamline.compact_frames(mesh, ada, min_length=4)
    for a_f, b_f in zip(want, got):
        assert len(a_f) == len(b_f)
        for a, b in zip(a_f, b_f):
            np.testing.assert_array_equal(a, b)


def test_compact_frames_all_overlay(source_setup):
    """When every qualifying walk lives in the overlay (tiny first window,
    min_length above it), the base gather is skipped entirely and the
    overlay-only source path must still produce exact per-frame lines."""
    mesh, _, _, _, _, v3 = source_setup
    v = jnp.asarray(v3[:2])
    ada = streamline.trace_frames_adaptive(mesh, v, max_steps=256,
                                           initial_window=2,
                                           auto_plan=False)
    full = streamline.trace_frames(mesh, v, max_steps=256)
    # min_length 4 > window 2: every qualifying walk was escalated.
    got = streamline.compact_frames(mesh, ada, min_length=4)
    want = streamline.compact_frames(mesh, full, min_length=4)
    fl = np.asarray(full.lengths)
    assert (fl[fl >= 4] > 3).all()
    for a_f, b_f in zip(got, want):
        assert len(a_f) == len(b_f)
        for a, b in zip(a_f, b_f):
            np.testing.assert_array_equal(a, b)
