"""Optional PyVista GPU-grade field renders.

The port's own copy of ``anap3_tpu/plotting/pyvista_render.py``.

The reference renders its five per-run field artifacts (u.png, v.png,
pressure.png, vel-mag.png, streamlines.png) as 2400^2 off-screen PyVista
screenshots with the streamline pass isolated in a SUBPROCESS (VTK
segfaults must not kill the run — reference
src/shared/plotting/ldc/pyvista_fields.py:55-161,541-589). Without VTK
the production tier is the matplotlib renderer (plotting/fields.py, same
artifact names at the same pixel scale). When
``pyvista`` IS importable, this module supplies the true counterpart:

- off-screen 2400^2 renders with parallel projection over the structured
  grid (the real curvilinear CGL mesh, no resampling);
- the same five artifact names, so downstream tooling (MLflow artifact
  consumers, plotting/data_loading.py fixtures) cannot tell the tiers
  apart;
- the streamline render runs in a subprocess with a hard timeout and
  falls back to the matplotlib streamline pass on any failure.

``generate_field_plots_auto`` is the dispatch used by the orchestrator:
PyVista when available (and not disabled via ANAP3_DISABLE_PYVISTA=1),
matplotlib otherwise.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

WINDOW = 2400  # reference WINDOW_SIZE (pyvista_fields.py:28)


def pyvista_available() -> bool:
    if os.environ.get("ANAP3_DISABLE_PYVISTA", "") == "1":
        return False
    try:
        import pyvista  # noqa: F401

        return True
    except Exception:
        return False


def _structured_grid(x, y, U, V, P):
    """pyvista StructuredGrid over the native (curvilinear) mesh.

    ``U/V/P`` arrive (ny, nx)-shaped indexed [j, i] at (x_i, y_j)
    (plotting/data_loading.restructure_fields) — "xy" meshgrid indexing
    matches, and every array ravels in the same (Fortran) order."""
    import pyvista as pv

    X, Y = np.meshgrid(np.asarray(x, float), np.asarray(y, float),
                       indexing="xy")
    Z = np.zeros_like(X)
    grid = pv.StructuredGrid(X, Y, Z)
    # point arrays in VTK (Fortran) point order
    grid["u"] = np.asarray(U, float).ravel(order="F")
    grid["v"] = np.asarray(V, float).ravel(order="F")
    grid["pressure"] = np.asarray(P, float).ravel(order="F")
    grid["vel-mag"] = np.sqrt(grid["u"] ** 2 + grid["v"] ** 2)
    vec = np.zeros((grid.n_points, 3))
    vec[:, 0] = grid["u"]
    vec[:, 1] = grid["v"]
    grid["velocity"] = vec
    return grid


def _scalar_bar_args(title: str) -> dict:
    return {"vertical": False, "position_x": 0.25, "position_y": 0.02,
            "width": 0.5, "height": 0.04, "title_font_size": 44,
            "label_font_size": 32, "color": "black", "fmt": "%.2f",
            "n_labels": 5, "title": title}


def _render_scalar(grid, name: str, cmap: str, title: str,
                   output_dir: Path) -> Path:
    import pyvista as pv

    plotter = pv.Plotter(off_screen=True, window_size=[WINDOW, WINDOW])
    plotter.add_mesh(grid, scalars=name, cmap=cmap,
                     scalar_bar_args=_scalar_bar_args(title))
    plotter.enable_parallel_projection()
    plotter.view_xy()
    plotter.reset_camera_clipping_range()
    path = output_dir / f"{name}.png"
    plotter.screenshot(path, transparent_background=True)
    plotter.close()
    return path


# Self-contained streamline renderer executed in a SUBPROCESS: VTK's
# streamline tracer is the crash-prone stage (the reference isolates it the
# same way, pyvista_fields.py:133-161). Reads the grid from an .npz.
_STREAM_SCRIPT = r"""
import os, sys
os.environ["PYVISTA_OFF_SCREEN"] = "true"
import numpy as np
import pyvista as pv

npz, out = sys.argv[1], sys.argv[2]
d = np.load(npz)
X, Y = np.meshgrid(d["x"], d["y"], indexing="xy")
grid = pv.StructuredGrid(X, Y, np.zeros_like(X))
u = d["U"].ravel(order="F"); v = d["V"].ravel(order="F")
vec = np.zeros((grid.n_points, 3)); vec[:, 0] = u; vec[:, 1] = v
grid["velocity"] = vec
grid["vel-mag"] = np.sqrt(u * u + v * v)
streams = grid.streamlines_evenly_spaced_2D(
    vectors="velocity", separating_distance=0.4,
    separating_distance_ratio=0.4, step_length=0.3, compute_vorticity=False)
plotter = pv.Plotter(off_screen=True, window_size=[2400, 2400])
plotter.add_mesh(grid, scalars="vel-mag", cmap="magma", opacity=0.35,
                 show_scalar_bar=False)
plotter.add_mesh(streams.tube(radius=0.002), scalars="vel-mag",
                 cmap="magma", scalar_bar_args={
                     "vertical": False, "position_x": 0.25,
                     "position_y": 0.02, "width": 0.5, "height": 0.04,
                     "title_font_size": 44, "label_font_size": 32,
                     "color": "black", "fmt": "%.2f", "n_labels": 5,
                     "title": "|u|"})
plotter.enable_parallel_projection()
plotter.view_xy()
plotter.reset_camera_clipping_range()
plotter.screenshot(out, transparent_background=True)
"""


def _render_streamlines_isolated(x, y, U, V, output_dir: Path,
                                 timeout: int = 120) -> Path | None:
    with tempfile.TemporaryDirectory() as td:
        npz = Path(td) / "fields.npz"
        np.savez(npz, x=np.asarray(x, float), y=np.asarray(y, float),
                 U=np.asarray(U, float), V=np.asarray(V, float))
        script = Path(td) / "render.py"
        script.write_text(_STREAM_SCRIPT)
        out = output_dir / "streamlines.png"
        try:
            proc = subprocess.run(
                [sys.executable, str(script), str(npz), str(out)],
                capture_output=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            log.warning("PyVista streamline subprocess timed out (%ds)",
                        timeout)
            return None
        if proc.returncode != 0 or not out.exists():
            log.warning("PyVista streamline subprocess failed (rc=%s): %s",
                        proc.returncode,
                        proc.stderr.decode(errors="replace")[-400:])
            return None
        return out


def generate_field_plots_pyvista(fields: dict, output_dir) -> dict:
    """The reference's five artifacts via real PyVista off-screen renders."""
    from .data_loading import restructure_fields

    output_dir = Path(output_dir)
    x, y, U, V, P = restructure_fields(fields)
    grid = _structured_grid(x, y, U, V, P)
    out: dict = {}
    for name, cmap, title in (("u", "coolwarm", "u"),
                              ("v", "coolwarm", "v"),
                              ("pressure", "viridis", "p"),
                              ("vel-mag", "magma", "|u|")):
        try:
            out[name] = _render_scalar(grid, name, cmap, title, output_dir)
        except Exception as exc:
            log.warning("PyVista %s render failed: %s", name, exc)
    path = _render_streamlines_isolated(x, y, U, V, output_dir)
    if path is not None:
        out["streamlines"] = path
    return out


def generate_field_plots_auto(fields: dict, output_dir, **kwargs) -> dict:
    """Dispatch: PyVista renders when the library is importable, the
    matplotlib tier otherwise; any missing PyVista artifact (crashed or
    timed-out subprocess included) is back-filled by matplotlib."""
    from .fields import generate_field_plots

    if not pyvista_available():
        return generate_field_plots(fields, output_dir, **kwargs)
    out = generate_field_plots_pyvista(fields, output_dir)
    expected = {"u", "v", "pressure", "vel-mag", "streamlines"}
    # streamlines_3d is always matplotlib's (the reference renders it via
    # a VTK camera angle; the PyVista tier here does not) — back-fill is
    # SELECTIVE so a single failed render never overwrites the sibling
    # PyVista screenshots that succeeded on disk
    missing = (expected - set(out)) | {"streamlines_3d"}
    if missing - {"streamlines_3d"}:
        log.warning("PyVista tier missing %s; back-filling via matplotlib",
                    sorted(missing - {"streamlines_3d"}))
    mpl = generate_field_plots(fields, output_dir, only=missing, **kwargs)
    for k in missing:
        if k in mpl:
            out[k] = mpl[k]
    return out
