"""Platform plumbing: the compile-cache location and the f32 contraction
precision the GPU path relies on."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manifold_flow_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_respects_env_var(monkeypatch, tmp_path,
                                        restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set the helper sets no directory of
    its own: JAX's own reading of the variable stands."""
    marker = str(tmp_path / "not-set-by-the-helper")
    jax.config.update("jax_compilation_cache_dir", marker)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    got = compile_cache.configure_compile_cache()
    assert got == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == marker


def test_compile_cache_defaults_to_checkout_dir(monkeypatch,
                                                restore_cache_config):
    """Without the variable the cache lands in <checkout>/.jax_cache, a
    fixed path (the path is part of the cache key) that git ignores."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.configure_compile_cache()
    root = Path(__file__).resolve().parents[1]
    assert Path(got) == root / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == got
    ignored = (root / ".gitignore").read_text().splitlines()
    assert ".jax_cache/" in ignored


def _dot_precisions(jaxpr):
    """Every dot_general's precision in a (closed) jaxpr, sub-jaxprs too."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    out += _dot_precisions(getattr(inner, "jaxpr", inner))
    return out


def test_solver_f32_contractions_pin_highest_precision(curved_mesh):
    """The refined solver's f32 inner operator (assembly of the per-frame
    factors + matvec) and the two-level coarse correction contract at
    Precision.HIGHEST: on a GPU the default f32 dot may run in TF32 (~3
    digits), below what the f32 PCG needs."""
    from manifold_flow_tpu.fem.operator import make_operator
    from manifold_flow_tpu.geometry import synthetic
    from manifold_flow_tpu.solve import coarse

    mesh32 = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if hasattr(a, "dtype") and a.dtype == jnp.float64 else a,
        curved_mesh)
    pot, _ = synthetic.plane_wave_movie(curved_mesh, n_frames=4)
    pot = jnp.asarray(pot, jnp.float32)
    x = jnp.ones((3, curved_mesh.n_dof), jnp.float32)
    tables = coarse.build_tables(curved_mesh, passes=1)

    def inner(p, v):
        op = make_operator(mesh32, p, 0.01)
        pre = coarse.make_two_level(mesh32, op.g, op.lambda_, tables)
        return pre.apply(op.matvec(v))

    precs = _dot_precisions(jax.make_jaxpr(inner)(pot, x).jaxpr)
    assert len(precs) >= 4
    highest = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None, "a contraction runs at default precision"
        assert tuple(p) == (highest, highest), p
    # The pinned path still computes the same operator.
    op64 = make_operator(curved_mesh, jnp.asarray(pot, jnp.float64), 0.01)
    want = np.asarray(op64.matvec(x.astype(jnp.float64)))
    got = np.asarray(make_operator(mesh32, pot, 0.01).matvec(x))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
