"""Solver parity vs the scipy spsolve oracle (the golden-RMSE gate,
SURVEY.md §4 test plan (b)) and solver cross-checks."""

import jax.numpy as jnp
import numpy as np
import pytest

from manifold_flow_tpu.fem import assembly
from manifold_flow_tpu.fem.operator import make_operator
from manifold_flow_tpu.solve.api import build_rhs, compute_velocity_fields
from tests.oracle import reference_impl as ref


def _oracle(mesh, pot, times, lam=0.01):
    return ref.velocity_fields_np(
        np.asarray(mesh.points), np.asarray(mesh.triangles),
        np.asarray(mesh.normals), pot, times, lam,
    )


def test_dense_a2_matches_oracle(curved_mesh):
    e = ref.orthonormal_basis_np(np.asarray(curved_mesh.normals))
    gw = ref.hat_gradients_np(
        np.asarray(curved_mesh.points), np.asarray(curved_mesh.triangles))
    ar = ref.triangle_areas_np(
        np.asarray(curved_mesh.points), np.asarray(curved_mesh.triangles))
    want = ref.assemble_a2_np(
        np.asarray(curved_mesh.triangles), ar, e, gw).toarray()
    got = np.asarray(assembly.dense_a2(curved_mesh))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


def test_frame_assembly_matches_oracle(curved_mesh, wave_movie):
    pot, times = wave_movie
    e = ref.orthonormal_basis_np(np.asarray(curved_mesh.normals))
    gw = ref.hat_gradients_np(
        np.asarray(curved_mesh.points), np.asarray(curved_mesh.triangles))
    ar = ref.triangle_areas_np(
        np.asarray(curved_mesh.points), np.asarray(curved_mesh.triangles))
    a1_want, f_want = ref.assemble_frame_np(
        pot[0], pot[1], times[1] - times[0],
        np.asarray(curved_mesh.triangles), gw, e, ar,
    )
    op = make_operator(curved_mesh, jnp.asarray(pot), 0.01)
    f_got = build_rhs(curved_mesh, op, jnp.asarray(pot), jnp.asarray(times))
    np.testing.assert_allclose(np.asarray(f_got[0]), f_want,
                               rtol=1e-9, atol=1e-12)
    # Dense a1 blocks scatter to the oracle matrix.
    b1 = assembly.a1_blocks(curved_mesh, op.g[:1])
    a1_got = np.asarray(assembly.scatter_dense(curved_mesh, b1[0]))
    np.testing.assert_allclose(a1_got, a1_want.toarray(),
                               rtol=1e-9, atol=1e-12)


def test_matvec_matches_dense(curved_mesh, wave_movie):
    pot, times = wave_movie
    op = make_operator(curved_mesh, jnp.asarray(pot), 0.01)
    nd = curved_mesh.n_dof
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(pot.shape[0] - 1, nd)))
    y = np.asarray(op.matvec(x))
    a2d = np.asarray(assembly.dense_a2(curved_mesh))
    b1 = np.asarray(
        assembly.scatter_dense(curved_mesh, assembly.a1_blocks(curved_mesh, op.g)))
    for k in range(x.shape[0]):
        want = (b1[k] + 0.01 * a2d) @ np.asarray(x[k])
        np.testing.assert_allclose(y[k], want, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("method", ["cg", "cholesky"])
def test_velocity_fields_match_spsolve(curved_mesh, wave_movie, method):
    pot, times = wave_movie
    want, _ = _oracle(curved_mesh, pot, times)
    res = compute_velocity_fields(
        curved_mesh, jnp.asarray(pot), jnp.asarray(times),
        method=method, tol=1e-12, refine_steps=3,
    )
    got = np.asarray(res.v_k)
    scale = np.maximum(np.abs(want).max(), 1e-30)
    rmse = np.sqrt(np.mean((got - want) ** 2)) / scale
    assert rmse < 1e-7, f"{method} normalized RMSE {rmse}"
    assert bool(np.all(np.asarray(res.converged)))


def test_cg_agrees_with_cholesky(curved_mesh, wave_movie):
    pot, times = wave_movie
    r1 = compute_velocity_fields(curved_mesh, jnp.asarray(pot),
                                 jnp.asarray(times), method="cg", tol=1e-12)
    r2 = compute_velocity_fields(curved_mesh, jnp.asarray(pot),
                                 jnp.asarray(times), method="cholesky",
                                 refine_steps=3)
    np.testing.assert_allclose(np.asarray(r1.v_k), np.asarray(r2.v_k),
                               rtol=1e-6, atol=1e-9)


def test_refined_reaches_float64_accuracy(curved_mesh, wave_movie):
    """Mixed-precision refinement (f32 inner PCG + f64 residuals) must land
    at SuperLU-level accuracy — the bench accuracy gate (solve.refine)."""
    pot, times = wave_movie
    want, _ = _oracle(curved_mesh, pot, times)
    res = compute_velocity_fields(
        curved_mesh, jnp.asarray(pot, jnp.float64),
        jnp.asarray(times, jnp.float64), method="refined", tol=1e-9)
    got = np.asarray(res.v_k)
    scale = np.maximum(np.abs(want).max(), 1e-30)
    rmse = np.sqrt(np.mean((got - want) ** 2)) / scale
    # The adaptive outer loop exits at the requested tol (1e-9 relative
    # residual); conditioning amplifies that into the solution by ~1e1-1e2.
    assert rmse < 1e-7, f"refined normalized RMSE {rmse}"
    assert bool(np.all(np.asarray(res.converged)))


def test_refined_anchor_warm_start_matches(curved_mesh, wave_movie):
    """The temporal warm start (anchor solve + interpolation) must converge
    to the same solution as the cold start, with the outer residual check
    still enforced (solve.refine.solve_refined anchor_stride)."""
    pot, times = wave_movie
    base = compute_velocity_fields(
        curved_mesh, jnp.asarray(pot, jnp.float64),
        jnp.asarray(times, jnp.float64), method="refined", tol=1e-9)
    warm = compute_velocity_fields(
        curved_mesh, jnp.asarray(pot, jnp.float64),
        jnp.asarray(times, jnp.float64), method="refined", tol=1e-9,
        anchor_stride=2)
    assert bool(np.all(np.asarray(warm.converged)))
    scale = np.abs(np.asarray(base.v_k)).max()
    assert np.max(np.abs(np.asarray(warm.v_k) - np.asarray(base.v_k))) \
        < 1e-7 * scale


def test_refined_inner_tol_accuracy_unchanged(curved_mesh, wave_movie):
    """inner_tol only changes inner-iteration counts, not the delivered
    accuracy: the outer DF-residual loop enforces tol either way."""
    pot, times = wave_movie
    want, _ = _oracle(curved_mesh, pot, times)
    scale = np.maximum(np.abs(want).max(), 1e-30)
    for it in (1e-5, 1e-3, (3e-3, 3e-3, 1e-3)):
        res = compute_velocity_fields(
            curved_mesh, jnp.asarray(pot, jnp.float64),
            jnp.asarray(times, jnp.float64), method="refined", tol=1e-9,
            inner_tol=it)
        rmse = np.sqrt(np.mean((np.asarray(res.v_k) - want) ** 2)) / scale
        assert rmse < 1e-7, (it, rmse)
        assert bool(np.all(np.asarray(res.converged)))


def test_refined_rejects_float32_inputs(curved_mesh, wave_movie):
    pot, times = wave_movie
    with pytest.raises(ValueError, match="float64"):
        compute_velocity_fields(
            curved_mesh, jnp.asarray(pot, jnp.float32),
            jnp.asarray(times, jnp.float32), method="refined")


def test_plane_wave_velocity_direction(curved_mesh):
    """On a traveling plane wave the recovered flow points along +k."""
    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.geometry.tangent import recombine_tangent

    mesh = synthetic.plane_patch(nx=16, ny=16, lx=8.0, ly=8.0)
    pot, times = synthetic.plane_wave_movie(
        mesh, n_frames=4, wave_vector=(1.0, 0.0, 0.0), omega=2.0, dt=0.01)
    res = compute_velocity_fields(mesh, jnp.asarray(pot), jnp.asarray(times),
                                  method="cg", tol=1e-11)
    coeffs = jnp.stack(
        [res.v_k[:, : mesh.n_vertices], res.v_k[:, mesh.n_vertices:]], axis=-1)
    v3 = np.asarray(recombine_tangent(coeffs, mesh.basis))  # (T-1, N, 3)
    # Interior vertices only (away from patch boundary).
    pts = np.asarray(mesh.points)
    interior = (
        (pts[:, 0] > 2) & (pts[:, 0] < 6) & (pts[:, 1] > 2) & (pts[:, 1] < 6))
    vx = v3[0, interior, 0]
    vy = v3[0, interior, 1]
    # Wave moves in +x at speed omega/|k| = 2; optical flow should be
    # dominantly +x. (FEM flow is the minimum-norm explanation, so allow
    # amplitude spread but require direction.)
    assert np.mean(vx) > 0
    assert np.abs(np.mean(vy)) < 0.2 * np.abs(np.mean(vx))


def test_frame_chunked_solve_matches_unchunked(curved_mesh):
    """frame_chunk solves a long movie as overlapping windows in one
    lax.map program; frames are independent, so results match the one-shot
    batched solve to solver tolerance (incl. the shifted last window whose
    overlap frames re-solve and drop)."""
    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.solve.api import compute_velocity_fields

    pot, times = synthetic.plane_wave_movie(curved_mesh, n_frames=12)
    pot, times = jnp.asarray(pot), jnp.asarray(times)
    want = compute_velocity_fields(curved_mesh, pot, times, method="cg",
                                   tol=1e-12, frame_chunk=None)
    got = compute_velocity_fields(curved_mesh, pot, times, method="cg",
                                  tol=1e-12, frame_chunk=4)
    assert got.v_k.shape == want.v_k.shape
    assert bool(jnp.all(got.converged))
    np.testing.assert_allclose(np.asarray(got.v_k), np.asarray(want.v_k),
                               rtol=1e-8, atol=1e-10)
    # refined path chunks too
    want_r = compute_velocity_fields(curved_mesh, pot, times,
                                     method="refined", tol=1e-8,
                                     frame_chunk=None)
    got_r = compute_velocity_fields(curved_mesh, pot, times,
                                    method="refined", tol=1e-8,
                                    frame_chunk=4)
    # f32 inner solves take different trajectories per chunk grouping;
    # agreement is at the refined solver's delivered accuracy (~1e-5 gate).
    np.testing.assert_allclose(np.asarray(got_r.v_k), np.asarray(want_r.v_k),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("bad", [0, -4, np.int64(0), 2.5, "4", True])
def test_frame_chunk_rejects_non_positive_or_non_int(curved_mesh, bad):
    """frame_chunk is 'auto', None or a positive int; anything else (a
    non-positive int above all, which used to slip through) is a
    ValueError rather than a silent unchunked solve."""
    from manifold_flow_tpu.geometry import synthetic

    pot, times = synthetic.plane_wave_movie(curved_mesh, n_frames=6)
    with pytest.raises(ValueError, match="frame_chunk"):
        compute_velocity_fields(curved_mesh, jnp.asarray(pot),
                                jnp.asarray(times), method="cg",
                                frame_chunk=bad)


def test_refined_residual_is_native_f64(curved_mesh):
    """The refined solve reports its residual |f - A x| from a native f64
    matvec (fem.operator), equal to the SciPy-assembled residual of the
    returned solution, and converges below tol * |f| per frame."""
    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.solve.refine import solve_refined

    pot, times = synthetic.plane_wave_movie(curved_mesh, n_frames=5)
    res = solve_refined(curved_mesh, jnp.asarray(pot), jnp.asarray(times),
                        lambda_=0.01, tol=1e-10)
    assert bool(jnp.all(res.converged))
    assert int(res.outer_steps) >= 2
    mesh = curved_mesh
    pts, tris = np.asarray(mesh.points), np.asarray(mesh.triangles)
    e = ref.orthonormal_basis_np(np.asarray(mesh.normals))
    grad_w = ref.hat_gradients_np(pts, tris)
    areas = ref.triangle_areas_np(pts, tris)
    a2 = ref.assemble_a2_np(tris, areas, e, grad_w)
    x = np.asarray(res.x)
    for k in range(x.shape[0]):
        a1, f = ref.assemble_frame_np(pot[k], pot[k + 1],
                                      times[k + 1] - times[k], tris, grad_w,
                                      e, areas)
        r = np.linalg.norm(f - (a1 + 0.01 * a2) @ x[k])
        assert r <= 1e-10 * np.linalg.norm(f) * (1 + 1e-6)
        np.testing.assert_allclose(float(res.residual[k]), r,
                                   rtol=1e-3, atol=1e-14 * np.linalg.norm(f))
