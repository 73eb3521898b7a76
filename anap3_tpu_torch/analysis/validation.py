"""Validation against stored truths: FV reference solutions, Botella & Peyret
vortex tables, Saad conserved quantities.

The port's own copy of ``anap3_tpu/analysis/validation.py``, limited to what
``models/base.py`` and the driver (``main.py``: the objectives) call. It carries over the exact error definitions of the
reference:
- relative L2 on interior reference-grid points only, margin 1e-10
  (base.py:970-1054), keys ``u_L2_error[,_regu]`` / ``v_L2_error[,_regu]``;
- Botella comparison rows with percent errors on |psi|, |omega|, x, y for the
  primary/BL/BR vortices (base.py:890-964).

The tables are read with the standard library's ``csv``; matplotlib is
imported only by the heatmaps.
"""

from __future__ import annotations

import csv
import logging
import math
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from ..utils.vts import read_vts

log = logging.getLogger(__name__)

__all__ = [
    "compute_l2_errors_vs_reference",
    "botella_validation_rows",
    "saad_quantities_rows",
    "save_validation_error_heatmaps",
    "fv_l2_objective",
    "botella_vortex_objective",
]


def compute_l2_errors_vs_reference(
    evaluate_at_points: Callable[[np.ndarray, np.ndarray], tuple],
    Re: float,
    Lx: float = 1.0,
    Ly: float = 1.0,
    reference_roots: tuple = (("data/validation/fv", ""), ("data/validation/fv-regu", "_regu")),
    base_dir: Optional[Path] = None,
    heatmap_method: Optional[str] = None,
    heatmap_paths: Optional[list] = None,
) -> Dict[str, float]:
    """Relative L2 errors of (u, v) against stored reference .vts solutions.

    With ``heatmap_method`` set, error-distribution PNGs are saved for the
    non-regularized comparison (appended to ``heatmap_paths``).
    """
    base_dir = Path(base_dir) if base_dir is not None else Path.cwd()
    results: Dict[str, float] = {}
    for ref_root, suffix in reference_roots:
        ref_path = base_dir / ref_root / f"Re{int(Re)}" / "solution.vts"
        if not ref_path.exists():
            log.debug("No reference solution at %s", ref_path)
            continue
        grid = read_vts(ref_path)
        ref_u = np.asarray(grid.point_data["u"], dtype=float)
        ref_v = np.asarray(grid.point_data["v"], dtype=float)
        ref_x = grid.points[:, 0]
        ref_y = grid.points[:, 1]

        cur_u, cur_v = evaluate_at_points(ref_x, ref_y)
        margin = 1e-10
        interior = (
            (ref_x > margin) & (ref_x < Lx - margin)
            & (ref_y > margin) & (ref_y < Ly - margin)
        )
        valid = interior & ~(np.isnan(cur_u) | np.isnan(cur_v))
        if valid.sum() < 0.5 * ref_u.size:
            log.warning("Only %d/%d valid points for %s", valid.sum(), ref_u.size,
                        ref_root)
        if not valid.any():
            # Diverged (all-NaN) solution: empty-mask norms would report a
            # PERFECT 0.0 error. The reference computes without masking and
            # propagates NaN (base.py:970-1054) — do the same.
            u_err = v_err = float("nan")
        else:
            u_err = np.linalg.norm(cur_u[valid] - ref_u[valid]) / (
                np.linalg.norm(ref_u[valid]) + 1e-12
            )
            v_err = np.linalg.norm(cur_v[valid] - ref_v[valid]) / (
                np.linalg.norm(ref_v[valid]) + 1e-12
            )
        results[f"u_L2_error{suffix}"] = float(u_err)
        results[f"v_L2_error{suffix}"] = float(v_err)
        log.info("L2 errors vs %s: u=%.6e v=%.6e", ref_root, u_err, v_err)
        if heatmap_method and not suffix:
            try:
                paths = save_validation_error_heatmaps(
                    ref_x, ref_y, ref_u, ref_v, cur_u, cur_v, Re,
                    heatmap_method)
                if heatmap_paths is not None:
                    heatmap_paths.extend(paths)
            except Exception as exc:
                log.warning("Error-heatmap generation failed: %s", exc)
    return results


def _csv_rows(path: Path) -> list:
    """The rows of a CSV table (header first), without the lines and the
    tails of lines that a ``#`` comments out."""
    with open(path, newline="") as fh:
        lines = [line.split("#", 1)[0] for line in fh]
    return [row for row in csv.reader(lines) if row]


def _load_botella(Re: float, base_dir: Optional[Path] = None) -> Optional[dict]:
    base_dir = Path(base_dir) if base_dir is not None else Path.cwd()
    path = base_dir / "data/validation/botella" / f"botella_Re{int(Re)}_vortex.csv"
    if not path.exists():
        return None
    header, row = _csv_rows(path)[:2]
    return {k: float(v) for k, v in zip(header, row)}


def botella_validation_rows(metrics, Re: float, base_dir=None) -> Optional[list]:
    """Computed-vs-Botella table rows (same columns as base.py:890-964)."""
    ref = _load_botella(Re, base_dir)
    if ref is None:
        log.warning("Reference Botella file not found for Re=%s", Re)
        return None
    rows = []

    def add_row(vortex, metric, computed, reference, fmt=".6f"):
        if reference and reference != 0:
            error_pct = abs(abs(computed) - abs(reference)) / abs(reference) * 100
            ref_str = (f"{reference:{fmt}}" if abs(reference) >= 1e-3
                       else f"{reference:.4e}")
        else:
            error_pct = None
            ref_str = "-"
        comp_str = (f"{computed:{fmt}}" if abs(computed) >= 1e-3
                    else f"{computed:.4e}")
        rows.append({
            "Vortex": vortex,
            "Metric": metric,
            "Computed": comp_str,
            "Botella": ref_str,
            "Error (%)": f"{error_pct:.2f}" if error_pct is not None else "-",
        })

    add_row("Primary", "|ψ|", abs(metrics.psi_min), ref.get("psi_primary"))
    add_row("Primary", "|ω|", abs(metrics.omega_center), ref.get("omega_primary"))
    add_row("Primary", "x", metrics.psi_min_x, ref.get("x_primary"))
    add_row("Primary", "y", metrics.psi_min_y, ref.get("y_primary"))
    add_row("BL", "|ψ|", abs(metrics.psi_BL), ref.get("psi_BL"))
    add_row("BL", "|ω|", abs(metrics.omega_BL), ref.get("omega_BL"))
    add_row("BL", "x", metrics.psi_BL_x, ref.get("x_BL"))
    add_row("BL", "y", metrics.psi_BL_y, ref.get("y_BL"))
    add_row("BR", "|ψ|", abs(metrics.psi_BR), ref.get("psi_BR"))
    add_row("BR", "|ω|", abs(metrics.omega_BR), ref.get("omega_BR"))
    add_row("BR", "x", metrics.psi_BR_x, ref.get("x_BR"))
    add_row("BR", "y", metrics.psi_BR_y, ref.get("y_BR"))
    return rows


def saad_quantities_rows(metrics, Re: float, grid_label: str,
                         base_dir=None) -> Optional[list]:
    """Computed-vs-Saad conserved quantities (energy/enstrophy/palinstrophy).

    The reference carries the Saad tables (data/validation/saad/
    saad_Re1000_quantities.csv) but never tabulates against them; this closes
    that loop. Rows mirror the Botella table format.
    """
    base_dir = Path(base_dir) if base_dir is not None else Path.cwd()
    path = base_dir / "data/validation/saad" / f"saad_Re{int(Re)}_quantities.csv"
    if not path.exists():
        return None
    header, *body = _csv_rows(path)
    ref = dict(zip(header, body[-1]))  # finest grid row (512^2)
    rows = []
    for name, computed, reference in (
        ("Energy", metrics.final_energy, float(ref["Energy"])),
        ("Enstrophy", metrics.final_enstrophy, float(ref["Enstrophy"])),
        ("Palinstrophy", metrics.final_palinstrophy, float(ref["Palinstrophy"])),
    ):
        err = (abs(computed - reference) / abs(reference) * 100
               if reference else None)
        rows.append({
            "Quantity": name,
            "Computed": f"{computed:.6g}",
            f"Saad ({ref['Grid']})": f"{reference:.6g}",
            "Grid": grid_label,
            "Error (%)": f"{err:.2f}" if err is not None else "-",
        })
    return rows


def save_validation_error_heatmaps(ref_x, ref_y, ref_u, ref_v, cur_u, cur_v,
                                   Re, method_name: str,
                                   output_dir="outputs/validation_errors"):
    """Error-distribution PNGs (computed - reference), base.py:1056-1120."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    nx = len(np.unique(ref_x))
    ny = len(np.unique(ref_y))
    try:
        X = np.asarray(ref_x).reshape(nx, ny)
        Y = np.asarray(ref_y).reshape(nx, ny)
        U = (np.asarray(cur_u) - np.asarray(ref_u)).reshape(nx, ny)
        V = (np.asarray(cur_v) - np.asarray(ref_v)).reshape(nx, ny)
    except ValueError:
        log.warning("Could not reshape error field for plotting; skipping")
        return []
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for comp, diff in (("u", U), ("v", V)):
        fig, ax = plt.subplots(figsize=(8, 6))
        vmax = max(np.nanmax(np.abs(diff)), 1e-10)
        im = ax.pcolormesh(X, Y, diff, cmap="RdBu_r", vmin=-vmax, vmax=vmax,
                           shading="auto")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_title(f"{comp} error (computed - reference), Re={int(Re)}")
        ax.set_aspect("equal")
        plt.colorbar(im, ax=ax, label=f"{comp} error")
        path = out_dir / f"{method_name}_Re{int(Re)}_{comp}_error.png"
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def fv_l2_objective(validation_errors: Dict[str, float]) -> float:
    """sqrt(u_err^2 + v_err^2) against the non-regularized FV truth."""
    u_err = validation_errors.get("u_L2_error", float("inf"))
    v_err = validation_errors.get("v_L2_error", float("inf"))
    return math.sqrt(u_err**2 + v_err**2)


def botella_vortex_objective(metrics, Re: float, base_dir=None) -> float:
    """RMS of the primary vortex's relative psi error and its centre's
    location errors against Botella & Peyret. The tables use two schemas:
    Re=100 carries signed psi_min / psi_min_{x,y}, Re=400/1000 carry
    |psi_primary| / {x,y}_primary; both are read."""
    ref = _load_botella(Re, base_dir)
    if ref is None:
        return float("inf")
    psi_ref = ref.get("psi_min")
    if psi_ref is None and ref.get("psi_primary"):
        psi_ref = -abs(ref["psi_primary"])  # the primary vortex is clockwise
    x_ref = ref.get("psi_min_x", ref.get("x_primary"))
    y_ref = ref.get("psi_min_y", ref.get("y_primary"))
    errors = []
    if psi_ref:
        errors.append(abs(metrics.psi_min - psi_ref) / abs(psi_ref))
    if x_ref:
        errors.append(abs(metrics.psi_min_x - x_ref))
    if y_ref:
        errors.append(abs(metrics.psi_min_y - y_ref))
    if not errors:
        return float("inf")
    return math.sqrt(sum(e**2 for e in errors) / len(errors))
