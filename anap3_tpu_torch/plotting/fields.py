"""Field renders: vorticity contours + u/v/pressure/|u|/streamline images;
the port's own copy of ``anap3_tpu/plotting/fields.py``.

Replaces both the reference's matplotlib field plots (fields.py:20-210) and
its PyVista off-screen renders (pyvista_fields.py). The reference isolates
streamline rendering in a subprocess with timeout + density fallbacks because
VTK can segfault (pyvista_fields.py:133-161); matplotlib's streamplot cannot
crash the process, so only the density-fallback retry is kept.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
from scipy.interpolate import RectBivariateSpline

from .data_loading import restructure_fields
from .style import pyplot

log = logging.getLogger(__name__)

__all__ = ["plot_vorticity", "generate_field_plots"]


def _resample(x, y, F, n=200):
    """Spline resample onto a uniform grid (needed for non-uniform CGL grids)."""
    xi = np.linspace(x.min(), x.max(), n)
    yi = np.linspace(y.min(), y.max(), n)
    spline = RectBivariateSpline(y, x, F)
    return xi, yi, spline(yi, xi)


def plot_vorticity(fields: dict, Re, solver_name, N, output_dir) -> Path:
    """Filled vorticity contours -> vorticity.pdf (reference fields.py)."""
    plt = pyplot()
    x, y, U, V, _ = restructure_fields(fields)
    xi, yi, Ui = _resample(x, y, U)
    _, _, Vi = _resample(x, y, V)
    dx = xi[1] - xi[0]
    dy = yi[1] - yi[0]
    omega = np.gradient(Vi, dx, axis=1) - np.gradient(Ui, dy, axis=0)
    fig, ax = plt.subplots(figsize=(6.5, 6))
    levels = np.linspace(-5, 5, 41)
    cs = ax.contourf(xi, yi, np.clip(omega, -5, 5), levels=levels, cmap="RdBu_r")
    ax.contour(xi, yi, omega, levels=[-3, -2, -1, 0, 1, 2, 3], colors="k",
               linewidths=0.4, alpha=0.5)
    fig.colorbar(cs, ax=ax, label=r"$\omega$")
    ax.set_aspect("equal")
    ax.set_xlabel("$x$")
    ax.set_ylabel("$y$")
    ax.set_title(f"Vorticity: {solver_name}, $N={N}$, $Re={Re:g}$")
    out = Path(output_dir) / "vorticity.pdf"
    fig.savefig(out)
    plt.close(fig)
    return out


def generate_field_plots(fields: dict, output_dir, dpi: int = 300,
                         resample_n: int = 512, only=None) -> dict:
    """u.png, v.png, pressure.png, vel-mag.png, streamlines.png.

    Render tier matched to the reference's 2400^2 off-screen PyVista
    screenshots (pyvista_fields.py:55-161): 8-inch square axes at dpi=300
    give a ~2400-pixel field image, the data is spline-resampled to a
    512^2 uniform grid, u/v use the paraview-like cool-to-warm diverging
    map, and the streamline plot seeds a uniform grid with unbroken lines
    (the evenly-spaced-streamline look of the PyVista renderer).

    ``only`` (optional set of artifact names) renders just those — the
    PyVista tier's back-fill uses it so a single failed render never
    overwrites the sibling renders that succeeded.
    """
    plt = pyplot()
    output_dir = Path(output_dir)
    wanted = (lambda name: only is None or name in only)
    x, y, U, V, P = restructure_fields(fields)
    xi, yi, Ui = _resample(x, y, U, n=resample_n)
    _, _, Vi = _resample(x, y, V, n=resample_n)
    _, _, Pi = _resample(x, y, P, n=resample_n)
    mag = np.sqrt(Ui**2 + Vi**2)

    out: dict = {}

    def render(name, F, cmap, label):
        fig, ax = plt.subplots(figsize=(8.6, 8))
        im = ax.pcolormesh(xi, yi, F, cmap=cmap, shading="gouraud",
                           rasterized=True)
        fig.colorbar(im, ax=ax, label=label)
        ax.set_aspect("equal")
        ax.set_xlabel("$x$")
        ax.set_ylabel("$y$")
        path = output_dir / f"{name}.png"
        fig.savefig(path, dpi=dpi)
        plt.close(fig)
        out[name] = path

    if wanted("u"):
        render("u", Ui, "coolwarm", "$u$")
    if wanted("v"):
        render("v", Vi, "coolwarm", "$v$")
    if wanted("pressure"):
        render("pressure", Pi, "viridis", "$p$")
    if wanted("vel-mag"):
        render("vel-mag", mag, "magma", r"$|\mathbf{u}|$")

    # Evenly-spaced streamlines: uniform seed grid + unbroken lines where
    # matplotlib supports it (>=3.6), with the density-fallback retries the
    # reference uses for its subprocess-isolated VTK renderer.
    for density, n_seed in ((2.0, 24), (1.2, 16), (0.7, 10)) \
            if wanted("streamlines") else ():
        try:
            fig, ax = plt.subplots(figsize=(8.6, 8))
            sx, sy = np.meshgrid(
                np.linspace(xi.min(), xi.max(), n_seed)[1:-1],
                np.linspace(yi.min(), yi.max(), n_seed)[1:-1])
            seeds = np.column_stack([sx.ravel(), sy.ravel()])
            kwargs = dict(density=density, color=mag, cmap="magma",
                          linewidth=0.8, start_points=seeds)
            try:
                ax.streamplot(xi, yi, Ui, Vi, broken_streamlines=False,
                              **kwargs)
            except TypeError:  # older matplotlib
                ax.streamplot(xi, yi, Ui, Vi, **kwargs)
            ax.set_aspect("equal")
            ax.set_xlim(xi.min(), xi.max())
            ax.set_ylim(yi.min(), yi.max())
            ax.set_xlabel("$x$")
            ax.set_ylabel("$y$")
            path = output_dir / "streamlines.png"
            fig.savefig(path, dpi=dpi)
            plt.close(fig)
            out["streamlines"] = path
            break
        except Exception as exc:
            plt.close("all")
            log.warning("Streamline render failed at density %s: %s", density, exc)

    # streamlines_3d.png — counterpart of the reference's PyVista
    # camera-angle streamline screenshot (stored fixture
    # data/validation/fv/Re*/streamlines_3d.png; pyvista_fields.py renders).
    # Without VTK, the 2D streamline trajectories are lifted
    # onto the speed surface z = |u|(x, y) and drawn from an elevated
    # camera over a translucent surface.
    if wanted("streamlines_3d"):
        try:
            path = _render_streamlines_3d(xi, yi, Ui, Vi, mag, output_dir,
                                          dpi)
            if path is not None:
                out["streamlines_3d"] = path
        except Exception as exc:
            plt.close("all")
            log.warning("3D streamline render failed: %s", exc)
    return out


def _render_streamlines_3d(xi, yi, Ui, Vi, mag, output_dir, dpi) -> Path:
    """Camera-angle 3D streamline render (see generate_field_plots)."""
    plt = pyplot()
    # compute trajectories with a throwaway 2D streamplot on a decimated
    # grid (the integrator's cost scales with grid size; visual fidelity
    # of the 3D view does not need the full 512^2 resample)
    d = max(1, len(xi) // 128)
    fig2d, ax2d = plt.subplots()
    sp = ax2d.streamplot(xi[::d], yi[::d], Ui[::d, ::d], Vi[::d, ::d],
                         density=1.2)
    segments = sp.lines.get_segments()
    plt.close(fig2d)

    zspline = RectBivariateSpline(yi, xi, mag)
    fig = plt.figure(figsize=(9, 7.5))
    ax = fig.add_subplot(projection="3d")
    # translucent speed surface (coarse mesh keeps the file small)
    step = max(1, len(xi) // 96)
    Xs, Ys = np.meshgrid(xi[::step], yi[::step])
    ax.plot_surface(Xs, Ys, mag[::step, ::step], cmap="magma", alpha=0.35,
                    linewidth=0, antialiased=False, rstride=1, cstride=1)
    cmap = plt.get_cmap("magma")
    vmax = max(float(mag.max()), 1e-12)
    for seg in segments:
        x0, y0 = seg[:, 0], seg[:, 1]
        z0 = zspline(y0, x0, grid=False)
        ax.plot(x0, y0, z0 + 0.01 * vmax,
                color=cmap(float(z0.mean()) / vmax), linewidth=0.9)
    ax.view_init(elev=48, azim=-120)
    ax.set_xlabel("$x$")
    ax.set_ylabel("$y$")
    ax.set_zlabel(r"$|\mathbf{u}|$")
    ax.set_box_aspect((1, 1, 0.45))
    path = Path(output_dir) / "streamlines_3d.png"
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path
