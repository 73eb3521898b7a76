"""Per-run and per-sweep plot orchestration (reference orchestrator.py);
the port's own copy of ``anap3_tpu/plotting/orchestrator.py``, over the
port's tracking store (``utils/tracking``)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from .convergence import plot_convergence
from .data_loading import load_fields_from_vts
from .fields import plot_vorticity
from .pyvista_render import generate_field_plots_auto
from .tracking_utils import (
    artifact_dir_for_run,
    find_sibling_runs,
    load_timeseries,
    upload_plots,
)
from .validation import plot_ghia_comparison, plot_l2_convergence
from ..utils import tracking as T

log = logging.getLogger(__name__)

__all__ = ["generate_plots_for_run", "generate_comparison_plots_for_sweep"]


def generate_plots_for_run(
    run_id: str,
    tracking_uri,
    output_dir,
    solver_name: str,
    N: int,
    Re: float,
    parent_run_id: Optional[str] = None,
    upload_to_tracking: bool = True,
    data_dir: str = "data",
) -> list:
    """convergence.pdf, vorticity.pdf, ghia_comparison.pdf + field PNGs."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    if tracking_uri:
        T.set_tracking_uri(tracking_uri)
    artifact_dir = artifact_dir_for_run(run_id)
    fields = load_fields_from_vts(artifact_dir)
    timeseries = load_timeseries(run_id)

    log.info("Generating plots for %s N=%s Re=%s", solver_name, N, Re)
    plots = []
    plots.append(plot_convergence(timeseries, Re, solver_name, N, output_dir))
    plots.append(plot_vorticity(fields, Re, solver_name, N, output_dir))
    plots.append(plot_ghia_comparison(
        [{"run_id": run_id, "N": N, "Re": Re, "solver": solver_name,
          "status": "FINISHED"}],
        tracking_uri, output_dir, data_dir=data_dir))
    # PyVista GPU renders when the library is importable; the matplotlib
    # tier (same artifact names/pixel scale) otherwise — see
    # plotting/pyvista_render.py
    plots.extend(generate_field_plots_auto(fields, output_dir).values())

    plots = [p for p in plots if p is not None]
    if upload_to_tracking:
        upload_plots(run_id, plots)
    log.info("Generated %d plots for run", len(plots))
    return plots


def generate_comparison_plots_for_sweep(
    parent_run_ids: list,
    tracking_uri,
    output_dir,
    upload_to_tracking: bool = True,
    data_dir: str = "data",
) -> dict:
    """Ghia overlay + 4 L2-convergence PDFs per parent run."""
    if tracking_uri:
        T.set_tracking_uri(tracking_uri)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    results = {}
    for parent_run_id in parent_run_ids:
        siblings = find_sibling_runs(parent_run_id)
        if len(siblings) < 2:
            log.warning("Only %d child run(s) for %s, skipping comparison",
                        len(siblings), parent_run_id[:8])
            continue
        unfinished = [s for s in siblings if s.get("status") != "FINISHED"]
        if unfinished:
            log.warning("%d run(s) not finished; skipping comparison",
                        len(unfinished))
            continue
        parent_dir = output_dir / parent_run_id[:8]
        parent_dir.mkdir(exist_ok=True)
        plots = []
        comparison = plot_ghia_comparison(siblings, tracking_uri, parent_dir,
                                          data_dir=data_dir)
        if comparison:
            plots.append(comparison)
            results[parent_run_id] = comparison
        plots.extend(plot_l2_convergence(siblings, tracking_uri, parent_dir))
        if plots and upload_to_tracking:
            upload_plots(parent_run_id, plots)
    log.info("Generated %d comparison plot(s)", len(results))
    return results
