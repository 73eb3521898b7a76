"""Residual-history plot (reference convergence.py:17-56); the port's own
copy of ``anap3_tpu/plotting/convergence.py``."""

from __future__ import annotations

import logging
from pathlib import Path

from .style import pyplot

log = logging.getLogger(__name__)

__all__ = ["plot_convergence"]

_SERIES = [
    ("rel_iter_residual", "Relative iterate change"),
    ("u_residual", "u residual"),
    ("v_residual", "v residual"),
    ("continuity_residual", "continuity residual"),
]


def plot_convergence(timeseries_df, Re, solver_name, N, output_dir) -> Path | None:
    if timeseries_df is None or timeseries_df.empty:
        log.warning("No time-series data; skipping convergence plot")
        return None
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    for key, label in _SERIES:
        if key in timeseries_df.columns:
            ax.semilogy(timeseries_df.index, timeseries_df[key], label=label)
    ax.set_xlabel("Iteration")
    ax.set_ylabel("Residual")
    ax.set_title(f"Convergence: {solver_name}, $N={N}$, $Re={Re:g}$")
    ax.legend()
    out = Path(output_dir) / "convergence.pdf"
    fig.savefig(out)
    plt.close(fig)
    return out
