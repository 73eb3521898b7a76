"""Lid corner-singularity treatments.

The port's own copy of ``anap3_tpu/ops/corner.py`` (float64 numpy).

Because boundary profiles never change during a solve, they are evaluated once
on the host at setup and baked into boundary-value arrays that the jitted
steppers apply with masked selects (no per-step BC evaluation, unlike the
reference's per-call handlers in src/solvers/spectral/operators/corner.py).

Formulas carried over exactly:
- "smoothing": cosine ramp of width ``smoothing_width * Lx`` at both lid
  corners (corner.py:88-112),
- "saad"/"polynomial": u = 16 (x/Lx)^2 (1 - x/Lx)^2 — C-infinity regularized
  lid (corner.py:148-169),
- "none": constant lid velocity (FV only; simple_structured.py:262-268).
"""

from __future__ import annotations

import numpy as np

__all__ = ["lid_profile", "CORNER_TREATMENTS"]

CORNER_TREATMENTS = ("none", "smoothing", "saad", "polynomial")


def lid_profile(
    x: np.ndarray,
    method: str = "smoothing",
    smoothing_width: float = 0.15,
    lid_velocity: float = 1.0,
    Lx: float = 1.0,
) -> np.ndarray:
    """u-velocity profile along the lid at coordinates ``x`` (host, float64)."""
    x = np.asarray(x, dtype=float)
    method = method.lower()
    if method == "none":
        return np.full_like(x, lid_velocity)
    if method == "smoothing":
        u = np.full_like(x, lid_velocity)
        if smoothing_width > 0:
            w = smoothing_width * Lx
            left = x < w
            right = x > Lx - w
            u = np.where(left, 0.5 * (1.0 - np.cos(np.pi * x / w)) * lid_velocity, u)
            u = np.where(
                right, 0.5 * (1.0 - np.cos(np.pi * (Lx - x) / w)) * lid_velocity, u
            )
        return u
    if method in ("saad", "polynomial"):
        xi = x / Lx
        return 16.0 * xi**2 * (1.0 - xi) ** 2 * lid_velocity
    raise ValueError(
        f"Unknown corner treatment: {method!r}. Use one of {CORNER_TREATMENTS}."
    )
