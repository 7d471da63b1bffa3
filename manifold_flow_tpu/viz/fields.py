"""Velocity-field visualization (C19, SURVEY.md §2).

Matplotlib equivalents of the reference's PyVista plots
(utils/draw_optical_flow_field.py): static glyph (arrow) plots of a velocity
frame over the surface with the scalar field as a colormap and singularities
as red markers (:75-128), GIF animation across frames incl. time-stamped
titles (:132-255), and a true-vs-detected comparison variant (:258-319).
Arrow scaling matches the reference's 'Raw' and 'Scaled' modes (:93-116):
'raw' draws v as-is; 'scaled' normalizes each arrow and scales by the mesh
diagonal. If PyVista is installed, `pyvista_plotter` returns an interactive
glyph plot like the original.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _axes3d(figsize=(9, 8)):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    return fig, ax


def _arrow_lengths(v, points, mode):
    v = np.asarray(v, dtype=float)
    if mode == "raw":
        return v
    if mode == "scaled":
        diag = np.linalg.norm(points.max(0) - points.min(0))
        norms = np.linalg.norm(v, axis=-1, keepdims=True)
        unit = np.where(norms > 0, v / np.where(norms > 0, norms, 1.0), 0.0)
        return unit * (0.02 * diag)
    raise ValueError(f"arrow scaling must be 'raw' or 'scaled'; got {mode!r}")


def plot_velocity_frame(mesh, v_frame, scalars=None, singularities=None,
                        true_singularities=None, scaling: str = "scaled",
                        stride: int = 1, title: str | None = None,
                        elev: float = 40.0, azim: float = -60.0, ax=None,
                        underlay=None):
    """One frame: surface + velocity arrows (+ singularities).

    Args:
      mesh: TriMesh.
      v_frame: (N, 3) world-frame velocities.
      scalars: optional (N,) field (potentials/phases) colored on the surface.
      singularities: optional (S, 3) detected singularity coordinates (red).
      true_singularities: optional (S2, 3) ground-truth markers (blue), the
        reference's true-vs-detected overlay (draw_optical_flow_field.py:258-319).
      scaling: 'raw' | 'scaled' arrow mode (:93-116).
      stride: draw every stride-th vertex arrow.
      underlay: optional list of (verts, faces) translucent context meshes —
        the reference's pial-surface underlay (plot_pial_surfaces,
        S4_...ConcatMatrices .py:147-158); load with `load_pial_surfaces`.
    Returns the matplotlib Figure.
    """
    points = np.asarray(mesh.points)
    tris = np.asarray(mesh.triangles)
    if ax is None:
        fig, ax = _axes3d()
    else:
        fig = ax.figure

    for uverts, ufaces in (underlay or ()):
        uverts = np.asarray(uverts)
        ax.plot_trisurf(uverts[:, 0], uverts[:, 1], uverts[:, 2],
                        triangles=np.asarray(ufaces), color="grey",
                        alpha=0.1, linewidth=0, shade=True)

    colors = None if scalars is None else np.asarray(scalars)
    surf = ax.plot_trisurf(points[:, 0], points[:, 1], points[:, 2],
                           triangles=tris, cmap="viridis", alpha=0.55,
                           linewidth=0.1, edgecolor="gray")
    if colors is not None:
        # Face colors = mean of corner values (matplotlib trisurf is per-face).
        surf.set_array(colors[tris].mean(axis=1))

    arrows = _arrow_lengths(v_frame, points, scaling)[::stride]
    base = points[::stride]
    ax.quiver(base[:, 0], base[:, 1], base[:, 2],
              arrows[:, 0], arrows[:, 1], arrows[:, 2],
              color="black", linewidth=0.6, arrow_length_ratio=0.35)

    if singularities is not None and len(singularities):
        s = np.asarray(singularities)
        ax.scatter(s[:, 0], s[:, 1], s[:, 2], color="red", s=60,
                   depthshade=False, label="detected")
    if true_singularities is not None and len(true_singularities):
        s = np.asarray(true_singularities)
        ax.scatter(s[:, 0], s[:, 1], s[:, 2], color="blue", s=60, marker="^",
                   depthshade=False, label="true")
    if (singularities is not None or true_singularities is not None):
        ax.legend(loc="upper right")
    if title:
        ax.set_title(title)
    ax.view_init(elev=elev, azim=azim)
    lo, hi = points.min(0), points.max(0)
    for uverts, _ in (underlay or ()):
        uverts = np.asarray(uverts)
        lo = np.minimum(lo, uverts.min(0))
        hi = np.maximum(hi, uverts.max(0))
    ax.set_box_aspect(hi - lo + 1e-9)
    return fig


def animate_velocity_fields(mesh, v_world, save_path, scalars=None,
                            singularities_per_frame=None,
                            true_singularities_per_frame=None, times=None,
                            scaling: str = "scaled", stride: int = 1,
                            fps: int = 10, dpi: int = 80, underlay=None):
    """GIF across frames (plot_velocity_fields_and_singularity_points_gif,
    draw_optical_flow_field.py:132-255). `times` adds the reference's
    time-stamped titles (:194-255). Passing `true_singularities_per_frame`
    produces the simulated-data true-vs-detected validation animation
    (plot_velocity_fields_and_singularity_points_and_true_singularity_points
    _gif, draw_optical_flow_field.py:258-319): detected points in red, ground
    truth as blue triangles, per frame."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    v_world = np.asarray(v_world)
    fig, ax = _axes3d()

    def draw(k):
        ax.clear()
        title = (f"t = {times[k]:.4f} s" if times is not None
                 else f"frame {k}")
        sing = (singularities_per_frame[k]
                if singularities_per_frame is not None else None)
        true = (true_singularities_per_frame[k]
                if true_singularities_per_frame is not None else None)
        sc = scalars[k] if scalars is not None else None
        plot_velocity_frame(mesh, v_world[k], scalars=sc, singularities=sing,
                            true_singularities=true,
                            scaling=scaling, stride=stride, title=title,
                            ax=ax, underlay=underlay)

    anim = FuncAnimation(fig, draw, frames=v_world.shape[0], interval=1000 / fps)
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    anim.save(str(save_path), writer=PillowWriter(fps=fps), dpi=dpi)
    plt.close(fig)
    return save_path


def plot_spatial_modes(mesh, modes, n_modes: int = 4, scaling: str = "scaled",
                       stride: int = 1, underlay=None, save_path_fmt=None,
                       elev: float = 40.0, azim: float = -60.0):
    """Render the leading spatial SVD modes as glyph plots (extract_modes +
    calculate_V_k_from_complex, S4_spatiotemporal_decomposition_
    ComplexMatrices .py:49-69,145-162): mode i draws sigma_i * VT_i recombined
    into world vectors over the surface, titled with its energy percentage.

    Accepts modes from either decomposition: complex (K, N) spatial rows or
    the concatenated-real (K, 2N) form (converted via concat_modes_to_complex,
    ConcatMatrices :194-197). `underlay` threads through to the pial-surface
    context plot. Returns the list of figures; `save_path_fmt` (with a
    `{mode}` field) also writes one PNG per mode.
    """
    vt = np.asarray(modes.vt)
    sigma = np.asarray(modes.sigma)
    if not np.iscomplexobj(vt):
        # Concat form (K, 2N) -> complex (K, N) (ConcatMatrices :194-197).
        n = vt.shape[-1] // 2
        vt = vt[..., :n] + 1j * vt[..., n:]
    basis = np.asarray(mesh.basis)
    energy = 100.0 * sigma**2 / np.sum(np.asarray(modes.sigma) ** 2)
    figs = []
    k = min(n_modes, vt.shape[0])
    for i in range(k):
        # calculate_V_k_from_complex (ComplexMatrices:49-69) in host numpy.
        svt = sigma[i] * vt[i]
        world = (np.real(svt)[:, None] * basis[:, 0]
                 + np.imag(svt)[:, None] * basis[:, 1])
        fig = plot_velocity_frame(
            mesh, world, scaling=scaling, stride=stride,
            title=f"mode {i + 1} ({energy[i]:.1f}%)",
            elev=elev, azim=azim, underlay=underlay)
        if save_path_fmt is not None:
            path = Path(str(save_path_fmt).format(mode=i + 1))
            path.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(path, dpi=120)
        figs.append(fig)
    return figs


def load_pial_surfaces(*paths):
    """Load FreeSurfer pial surfaces for the translucent context underlay
    (plot_pial_surfaces, S4_...ConcatMatrices .py:147-158, which uses
    mne.read_surface). Uses MNE when available, else the built-in
    FreeSurfer-binary reader (utils.io.read_freesurfer_surface). Returns a
    list of (verts, faces) suitable for `underlay=`."""
    out = []
    for p in paths:
        try:
            import mne

            verts, faces = mne.read_surface(str(p))
        except ImportError:
            from manifold_flow_tpu.utils.io import read_freesurfer_surface

            verts, faces = read_freesurfer_surface(p)
        out.append((np.asarray(verts), np.asarray(faces)))
    return out


def plot_temporal_modes(times, vt, sigma, n_modes: int = 4, save_path=None):
    """Temporal SVD modes sigma_i * VT_i(t) with energy percentages
    (S4_...ConcatMatrices .py:91-145)."""
    import matplotlib.pyplot as plt

    vt = np.asarray(vt)
    sigma = np.asarray(sigma)
    energy = 100.0 * sigma**2 / np.sum(sigma**2)
    fig, axes = plt.subplots(n_modes, 1, figsize=(8, 2.2 * n_modes),
                             sharex=True)
    axes = np.atleast_1d(axes)
    for i, ax in enumerate(axes[:n_modes]):
        ax.plot(np.asarray(times)[: vt.shape[1]], sigma[i] * vt[i])
        ax.set_ylabel(f"mode {i + 1}\n{energy[i]:.1f}%")
        ax.grid(alpha=0.3)
    axes[-1].set_xlabel("time (s)")
    fig.tight_layout()
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=120)
    return fig


def plot_streamlines(mesh, streamlines, save_path=None, elev=40.0, azim=-60.0):
    """Render S6 streamline polylines over the surface."""
    points = np.asarray(mesh.points)
    fig, ax = _axes3d()
    ax.plot_trisurf(points[:, 0], points[:, 1], points[:, 2],
                    triangles=np.asarray(mesh.triangles), color="lightgray",
                    alpha=0.35, linewidth=0)
    for line in streamlines:
        line = np.asarray(line)
        ax.plot(line[:, 0], line[:, 1], line[:, 2], linewidth=1.2)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect(points.max(0) - points.min(0) + 1e-9)
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=120)
    return fig


def pyvista_plotter(mesh, v_frame, scalars=None, singularities=None,
                    factor: float = 1.0):
    """Interactive PyVista glyph plot like the reference's
    (draw_optical_flow_field.py:75-128). Requires pyvista."""
    try:
        import pyvista as pv
    except ImportError as e:  # pragma: no cover - env without pyvista
        raise ImportError("pyvista_plotter requires PyVista; use "
                          "plot_velocity_frame for the matplotlib path") from e
    points = np.asarray(mesh.points)
    tris = np.asarray(mesh.triangles)
    faces = np.concatenate(
        [np.full((len(tris), 1), 3, dtype=np.int64), tris], axis=1).ravel()
    surf = pv.PolyData(points, faces)
    if scalars is not None:
        surf["field"] = np.asarray(scalars)
    surf["vectors"] = np.asarray(v_frame)
    plotter = pv.Plotter()
    plotter.add_mesh(surf, scalars="field" if scalars is not None else None,
                     opacity=0.8)
    plotter.add_mesh(surf.glyph(orient="vectors", scale="vectors",
                                factor=factor), color="black")
    if singularities is not None and len(singularities):
        plotter.add_points(np.asarray(singularities), color="red",
                           point_size=12)
    return plotter
