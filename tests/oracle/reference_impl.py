"""NumPy/SciPy oracle: an independent re-implementation of the reference
algorithms (SEU-dynamical-models/Manifold-based-optical-flow-method) used as
the golden standard in tests. Formula sources are cited per function; code is
vectorized numpy (the reference uses per-element Python loops over scipy LIL
matrices — same math, different construction).

The reference has no test suite (SURVEY.md §4); this oracle substitutes for
it: the framework must reproduce these outputs within tight tolerances.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve


def orthonormal_basis_np(normals: np.ndarray) -> np.ndarray:
    """(N, 2, 3) tangent bases; utils/compute_optical_flow.py:210-235."""
    n = np.asarray(normals, dtype=np.float64)
    out = np.zeros((n.shape[0], 2, 3))
    for i, ni in enumerate(n):
        if ni[0] != 0 or ni[1] != 0:
            e1 = np.array([-ni[1], ni[0], 0.0])
        else:
            e1 = np.array([0.0, -ni[2], ni[1]])
        e2 = np.cross(ni, e1)
        out[i, 0] = e1 / np.linalg.norm(e1)
        out[i, 1] = e2 / np.linalg.norm(e2)
    return out


def hat_gradients_np(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """(M, 3, 3) per-corner hat gradients; utils/compute_optical_flow.py:238-255."""
    p = np.asarray(points, dtype=np.float64)
    out = np.zeros((len(triangles), 3, 3))

    def grad(pi, pj, pk):
        v_jk = pk - pj
        v_ji = pi - pj
        perp = np.dot(v_ji, v_jk) * v_jk / np.dot(v_jk, v_jk)
        v_ih = pj - pi + perp
        return v_ih / np.dot(v_ih, v_ih)

    for m, (a, b, c) in enumerate(triangles):
        out[m, 0] = grad(p[a], p[b], p[c])
        out[m, 1] = grad(p[b], p[a], p[c])
        out[m, 2] = grad(p[c], p[a], p[b])
    return out


def triangle_areas_np(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    p = np.asarray(points, dtype=np.float64)[triangles]
    return 0.5 * np.linalg.norm(
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1
    )


def assemble_a2_np(triangles, areas, e, grad_w) -> sp.csr_matrix:
    """Regularization matrix a2 (2N, 2N).

    Entry [i + N*alpha, j + N*beta] = sum over triangles containing (i, j) of
    (e_i^alpha . e_j^beta)(grad_i . grad_j) * A_T
    (utils/compute_optical_flow.py:60-93, 258-270). All 36 local pairs per
    triangle are accumulated; the term is symmetric in (i,alpha)<->(j,beta),
    matching the reference's upper-triangle + mirror construction.
    """
    n = e.shape[0]
    et = e[triangles]                       # (M, 3, 2, 3)
    gg = np.einsum("mid,mjd->mij", grad_w, grad_w)     # (M, 3, 3)
    ee = np.einsum("miad,mjbd->miajb", et, et)         # (M, 3, 2, 3, 2)
    blocks = ee * gg[:, :, None, :, None] * areas[:, None, None, None, None]
    dof = triangles[:, :, None] + n * np.arange(2)[None, None, :]  # (M, 3, 2)
    rows = np.broadcast_to(dof[:, :, :, None, None], blocks.shape).ravel()
    cols = np.broadcast_to(dof[:, None, None, :, :], blocks.shape).ravel()
    a2 = sp.coo_matrix((blocks.ravel(), (rows, cols)), shape=(2 * n, 2 * n))
    return a2.tocsr()


def assemble_frame_np(i_k, i_k1, dt, triangles, grad_w, e, areas):
    """Per-frame data matrix a1 and RHS f.

    a1[i+Na, j+Nb] = sum_T (grad_M_I . e_i^a)(grad_M_I . e_j^b) * Int(w_i w_j)
    with Int = A/6 (i==j) else A/12 (utils/compute_optical_flow.py:113-141,
    273-285); f[i+Na] = sum_T (e_i^a . grad_M_I) * (2 dI_i + dI_j + dI_k)
    * A/12 with dI = (I_{k+1} - I_k)/dt (compute_f, :288-311).
    """
    n = e.shape[0]
    grad_m = np.einsum("mc,mcd->md", i_k[triangles], grad_w)   # (M, 3)
    et = e[triangles]                                          # (M, 3, 2, 3)
    g = np.einsum("md,mcad->mca", grad_m, et)                  # (M, 3, 2)
    w = (areas[:, None, None] / 12.0) * (np.ones((3, 3)) + np.eye(3))
    blocks = np.einsum("mia,mjb,mij->miajb", g, g, w)
    dof = triangles[:, :, None] + n * np.arange(2)[None, None, :]
    rows = np.broadcast_to(dof[:, :, :, None, None], blocks.shape).ravel()
    cols = np.broadcast_to(dof[:, None, None, :, :], blocks.shape).ravel()
    a1 = sp.coo_matrix((blocks.ravel(), (rows, cols)), shape=(2 * n, 2 * n)).tocsr()

    di = (i_k1 - i_k) / dt
    di_t = di[triangles]                                       # (M, 3)
    s = di_t.sum(axis=1, keepdims=True)                        # (M, 1)
    rhs_loc = g * ((di_t + s) * areas[:, None] / 12.0)[:, :, None]
    f = np.zeros(2 * n)
    np.add.at(f, dof.ravel(), rhs_loc.ravel())
    return a1, f


def velocity_fields_np(points, triangles, normals, potentials, times,
                       lambda_: float = 0.01):
    """End-to-end oracle: (T-1, 2N) velocity DOFs, one spsolve per frame.

    Mirrors worker/compute_velocity_field
    (utils/compute_optical_flow.py:100-194) with I_{k+1} taken from the same
    potentials movie (as in the __main__ path, :364-367).
    """
    e = orthonormal_basis_np(normals)
    grad_w = hat_gradients_np(points, triangles)
    areas = triangle_areas_np(points, triangles)
    a2 = assemble_a2_np(triangles, areas, e, grad_w)
    t = len(times)
    out = np.zeros((t - 1, 2 * e.shape[0]))
    for k in range(t - 1):
        a1, f = assemble_frame_np(
            potentials[k], potentials[k + 1], times[k + 1] - times[k],
            triangles, grad_w, e, areas,
        )
        out[k] = spsolve((a1 + lambda_ * a2).tocsr(), f)
    return out, e


def process_v_k_np(v_k: np.ndarray, e: np.ndarray) -> np.ndarray:
    """(T, 2N) DOFs -> (T, N, 3) world vectors; find_singularity_point.py:28-69."""
    n = e.shape[0]
    v1 = v_k[:, :n]
    v2 = v_k[:, n:]
    return v1[..., None] * e[None, :, 0] + v2[..., None] * e[None, :, 1]
