"""Streamfunction-based vortex detection (Botella & Peyret benchmark metrics).

The counterpart of ``anap3_tpu/analysis/vortex.py``: the Dirichlet Poisson
solve lap psi = -omega runs through the port's separable direct solver
(ops/poisson.py); the arg-extremum bookkeeping is one-shot numpy host code.

Conventions: the primary vortex is the global minimum of psi; the corner
vortices BR/BL/TL are the maximum of psi in quadrant masks (x, y <> 0.5),
reported only when positive; max vorticity is the extremum of |omega|
with its signed value.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..ops.poisson import SeparablePoisson

__all__ = ["solve_streamfunction", "vortex_metrics_from_fields"]


def solve_streamfunction(poisson: SeparablePoisson,
                         omega_2d: np.ndarray) -> np.ndarray:
    """Solve lap psi = -omega with psi = 0 on all boundaries; ``omega_2d``
    is on the full grid and the result is re-embedded with zero walls."""
    omega_2d = np.asarray(omega_2d)
    psi_int = poisson.solve(-omega_2d[1:-1, 1:-1]).cpu().numpy()
    psi = np.zeros_like(omega_2d)
    psi[1:-1, 1:-1] = psi_int
    return psi


def vortex_metrics_from_fields(psi_2d: np.ndarray, omega_2d: np.ndarray,
                               X: np.ndarray, Y: np.ndarray
                               ) -> Dict[str, float]:
    """All vortex metrics from psi, omega and matching coordinate arrays."""
    psi_2d = np.asarray(psi_2d)
    omega_2d = np.asarray(omega_2d)

    min_idx = np.unravel_index(np.argmin(psi_2d), psi_2d.shape)
    out = {
        "psi_min": float(psi_2d[min_idx]),
        "psi_min_x": float(X[min_idx]),
        "psi_min_y": float(Y[min_idx]),
        "omega_center": float(omega_2d[min_idx]),
    }
    max_idx = np.unravel_index(np.argmax(np.abs(omega_2d)), omega_2d.shape)
    out.update(omega_max=float(omega_2d[max_idx]),
               omega_max_x=float(X[max_idx]),
               omega_max_y=float(Y[max_idx]))

    regions = {
        "BR": (X > 0.5) & (Y < 0.5),
        "BL": (X < 0.5) & (Y < 0.5),
        "TL": (X < 0.5) & (Y > 0.5),
    }
    for name, mask in regions.items():
        masked = np.where(mask, psi_2d, -np.inf)
        idx = np.unravel_index(np.argmax(masked), psi_2d.shape)
        val = psi_2d[idx]
        found = val > 0
        out[f"psi_{name}"] = float(val) if found else 0.0
        out[f"omega_{name}"] = float(omega_2d[idx]) if found else 0.0
        out[f"psi_{name}_x"] = float(X[idx]) if found else 0.0
        out[f"psi_{name}_y"] = float(Y[idx]) if found else 0.0
    return out
