"""Property tests pinning the butterfly-subdivision stencils.

The reference subdivides with VTK's vtkButterflySubdivisionFilter
(S1_reconstruct_surface.py:94), which this image cannot run — so instead of
golden parity these tests pin geometry/reconstruct.py to the PUBLISHED
modified-butterfly scheme (Zorin, Schroeder & Sweldens 1996; the scheme VTK
implements): exact stencil weights for the regular interior rule
(1/2, 1/8, -1/16), the boundary 4-point rule (9/16, -1/16), the
valence-k extraordinary-vertex rule (3/4 center + s_j ring), interpolation
(old vertices never move), affine invariance (every stencil sums to 1), and
the scheme's high-order convergence on a sphere.

Weight extraction trick: butterfly_subdivide is linear in the coordinate
array and indifferent to its width, so running it on the identity matrix
returns every midpoint's stencil weights as a row.
"""

from __future__ import annotations

import numpy as np
import pytest

from manifold_flow_tpu.geometry.reconstruct import butterfly_subdivide


# ---------------------------------------------------------------- helpers --
def lattice(nx: int, ny: int):
    """Planar triangular lattice with consistent diagonals: interior
    vertices have valence 6 — the regular butterfly configuration."""
    idx = lambda i, j: j * nx + i  # noqa: E731
    # AFFINE image of the regular triangular lattice (shear, not a per-row
    # zigzag): polynomial-reproduction properties are affine-invariant.
    pts = np.array([[i + 0.5 * j, j * 0.82, 0.0]
                    for j in range(ny) for i in range(nx)])
    tris = []
    for j in range(ny - 1):
        for i in range(nx - 1):
            a, b = idx(i, j), idx(i + 1, j)
            c, d = idx(i, j + 1), idx(i + 1, j + 1)
            tris += [[a, b, d], [a, d, c]]
    return pts, np.asarray(tris, np.int64)


def icosphere(levels: int):
    """Unit-sphere mesh: icosahedron + `levels` rounds of midpoint split +
    reprojection. Original 12 vertices keep valence 5 (extraordinary);
    every inserted vertex has valence 6."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
                 dtype=np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    for _ in range(levels):
        mid = {}
        pts = [v]

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                mid[key] = len(v) + len(mid)
                m = 0.5 * (v[a] + v[b])
                pts.append((m / np.linalg.norm(m))[None])
            return mid[key]

        out = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v = np.concatenate(pts, axis=0)
        f = np.asarray(out, np.int64)
    return v, f


def edge_list(tris):
    """Edges in butterfly_subdivide's insertion order (sorted (min,max))."""
    es = {tuple(sorted((tri[i], tri[(i + 1) % 3]))) for tri in tris
          for i in range(3)}
    return sorted(es)


def stencil_weights(tris, n):
    """{edge: {vertex: weight}} via identity-matrix extraction."""
    w, _ = butterfly_subdivide(np.eye(n), tris, n_subdiv=1)
    out = {}
    for k, e in enumerate(edge_list(tris)):
        row = w[n + k]
        nz = np.flatnonzero(np.abs(row) > 1e-14)
        out[e] = {int(i): row[i] for i in nz}
    return out


def valences(tris, n):
    val = np.zeros(n, np.int64)
    for e in edge_list(tris):
        val[e[0]] += 1
        val[e[1]] += 1
    return val


def boundary_vertices(tris):
    cnt = {}
    for tri in tris:
        for i in range(3):
            e = tuple(sorted((tri[i], tri[(i + 1) % 3])))
            cnt[e] = cnt.get(e, 0) + 1
    bd = set()
    for e, c in cnt.items():
        if c == 1:
            bd.update(e)
    return bd


# ------------------------------------------------------------------ tests --
def test_interpolating_old_vertices_fixed():
    pts, tris = lattice(6, 6)
    rng = np.random.default_rng(0)
    pts = pts + 0.05 * rng.standard_normal(pts.shape)
    new_pts, _ = butterfly_subdivide(pts, tris, n_subdiv=2)
    np.testing.assert_array_equal(new_pts[: len(pts)], pts)


def test_all_stencils_affine_invariant():
    """Every midpoint stencil sums to exactly 1 (planar meshes stay planar;
    a translation of the input translates the output)."""
    for tris, n in ((lattice(6, 5)[1], 30), (icosphere(1)[1], 42)):
        w = stencil_weights(tris, n)
        for e, row in w.items():
            assert abs(sum(row.values()) - 1.0) < 1e-12, e


def test_regular_interior_weights():
    """Edges between two interior valence-6 vertices use the classic
    8-point butterfly: 1/2 ends, 1/8 wings, -1/16 far wings."""
    pts, tris = lattice(8, 8)
    n = len(pts)
    val = valences(tris, n)
    bd = boundary_vertices(tris)
    w = stencil_weights(tris, n)
    checked = 0
    for (a, b), row in w.items():
        if a in bd or b in bd or val[a] != 6 or val[b] != 6:
            continue
        # The 8 support vertices must be fully interior too (far wings of a
        # near-boundary edge fall back to endpoint substitutes).
        if any(v in bd for v in row):
            continue
        vals = sorted(row.values())
        assert vals == pytest.approx(
            4 * [-1.0 / 16.0] + 2 * [1.0 / 8.0] + 2 * [1.0 / 2.0])
        assert row[a] == pytest.approx(0.5)
        assert row[b] == pytest.approx(0.5)
        checked += 1
    assert checked >= 10


def test_boundary_edge_weights():
    """Boundary edges use the 4-point rule 9/16, 9/16, -1/16, -1/16 with
    the negative weights on the outer boundary neighbors."""
    pts, tris = lattice(7, 5)
    n = len(pts)
    bd = boundary_vertices(tris)
    w = stencil_weights(tris, n)
    cnt = {}
    for tri in tris:
        for i in range(3):
            e = tuple(sorted((tri[i], tri[(i + 1) % 3])))
            cnt[e] = cnt.get(e, 0) + 1
    checked = 0
    for (a, b), row in w.items():
        if cnt[(a, b)] != 1:
            continue
        # Skip corner-adjacent edges (no outer neighbor on one side).
        if len(row) != 4:
            continue
        assert row[a] == pytest.approx(9.0 / 16.0)
        assert row[b] == pytest.approx(9.0 / 16.0)
        outer = [v for v in row if v not in (a, b)]
        assert all(v in bd for v in outer)
        for v in outer:
            assert row[v] == pytest.approx(-1.0 / 16.0)
        checked += 1
    assert checked >= 4


def test_extraordinary_vertex_weights_valence5():
    """Edges touching one valence-5 vertex (closed icosphere) use Zorin's
    k-point rule: 3/4 at the extraordinary vertex and ring weights
    s_j = (1/4 + cos(2 pi j / k) + 1/2 cos(4 pi j / k)) / k, with s_0 on
    the opposite edge endpoint."""
    v, tris = icosphere(1)  # 12 valence-5 originals, 30 valence-6 midpoints
    n = len(v)
    val = valences(tris, n)
    w = stencil_weights(tris, n)
    k = 5
    s = np.array([(0.25 + np.cos(2 * np.pi * j / k)
                   + 0.5 * np.cos(4 * np.pi * j / k)) / k for j in range(k)])
    checked = 0
    for (a, b), row in w.items():
        va, vb = val[a], val[b]
        if {va, vb} != {5, 6}:
            continue
        center, other = (a, b) if va == 5 else (b, a)
        assert row[center] == pytest.approx(0.75)
        assert row[other] == pytest.approx(s[0])
        # Ring weights match the published multiset; s_0 sits on `other`.
        ring_w = sorted(val_ for key, val_ in row.items() if key != center)
        assert ring_w == pytest.approx(sorted(s))
        checked += 1
    assert checked >= 20


def test_cubic_precision_regular_region():
    """The regular butterfly stencil reproduces cubic polynomials exactly on
    a (affine image of the) regular triangular lattice — the property that
    gives the scheme its 4th-order accuracy. Feed z = cubic(x, y); interior
    inserted vertices must carry the cubic's exact value at the inserted
    (x, y) (which is the exact edge midpoint, by linear precision).

    Catches the pre-r5 far-wing lookup bug, under which the wings cancelled
    and the scheme silently degenerated to midpoint (order-2) subdivision."""
    pts, tris = lattice(10, 9)
    x, y = pts[:, 0], pts[:, 1]

    def cubic(x, y):
        return (0.7 * x**3 - 1.3 * x**2 * y + 0.4 * x * y**2 + 0.9 * y**3
                - 2.0 * x * y + 0.8 * x - 1.1 * y + 0.3)

    pts[:, 2] = cubic(x, y)
    n = len(pts)
    bd = boundary_vertices(tris)
    w = stencil_weights(tris, n)
    new_pts, _ = butterfly_subdivide(pts, tris, n_subdiv=1)
    checked = 0
    for k, e in enumerate(edge_list(tris)):
        row = w[e]
        if any(v in bd for v in row):   # full interior support only
            continue
        p = new_pts[n + k]
        assert p[0] == pytest.approx(0.5 * (pts[e[0], 0] + pts[e[1], 0]),
                                     abs=1e-12)
        assert p[2] == pytest.approx(cubic(p[0], p[1]), abs=1e-9)
        checked += 1
    assert checked >= 50


def test_convergence_on_sphere():
    """Inserted midpoints of a unit-sphere mesh converge to the sphere
    clearly faster than midpoint (order-2) subdivision would. The icosphere
    parametrization has derivative kinks across the base icosahedron's
    edges, so the observed order here is ~2.3-2.5, not the regular-region 4
    (that claim is carried by test_cubic_precision_regular_region); the
    assertions pin better-than-order-2 decay plus absolute smallness
    (midpoint subdivision would sit at ~9.5e-3 on the level-2 mesh)."""
    errs = []
    for lv in (2, 3):
        v, f = icosphere(lv)
        new_pts, _ = butterfly_subdivide(v, f, n_subdiv=1)
        d = np.abs(np.linalg.norm(new_pts[len(v):], axis=1) - 1.0)
        errs.append(d.max())
    assert errs[0] < 4e-3            # ~3x under the midpoint rule's error
    assert errs[1] < errs[0] / 4.0   # strictly better than order-2 decay


def test_closed_surface_counts():
    """Subdivision bookkeeping on a closed surface: V' = V + E, F' = 4F,
    and Euler characteristic 2 is preserved."""
    v, f = icosphere(1)
    e = len(edge_list(f))
    nv, nf = butterfly_subdivide(v, f, n_subdiv=1)
    assert len(nv) == len(v) + e
    assert len(nf) == 4 * len(f)
    ne = len(edge_list(nf))
    assert len(nv) - ne + len(nf) == 2
