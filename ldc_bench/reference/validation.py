"""The validation a run reports, worked out again: relative L2 distances
of (u, v) from the stored FV truth solutions (``data/validation/fv`` and,
with the suffix ``_regu``, ``data/validation/fv-regu``) at the truths'
interior points."""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

from . import spectral
from .vts import read_points

ROOTS = (("data/validation/fv", ""), ("data/validation/fv-regu", "_regu"))


@lru_cache(maxsize=None)
def truth(root: str, re: int):
    """(x, y, u, v) of a stored truth, or None where there is none."""
    path = Path(root) / f"Re{re}" / "solution.vts"
    if not path.exists():
        return None
    points, data = read_points(path)
    return (points[:, 0].copy(), points[:, 1].copy(),
            np.asarray(data["u"], float), np.asarray(data["v"], float))


def bilinear(xc, yc, field, x, y):
    """Bilinear values of a cell-centred field (ny, nx) at points; NaN
    outside the hull of the centres."""
    out = np.full(x.shape, np.nan)
    inside = (x >= xc[0]) & (x <= xc[-1]) & (y >= yc[0]) & (y <= yc[-1])
    i = np.clip(np.searchsorted(xc, x[inside]) - 1, 0, len(xc) - 2)
    j = np.clip(np.searchsorted(yc, y[inside]) - 1, 0, len(yc) - 2)
    tx = (x[inside] - xc[i]) / (xc[i + 1] - xc[i])
    ty = (y[inside] - yc[j]) / (yc[j + 1] - yc[j])
    f = np.asarray(field, np.float64)
    out[inside] = ((1 - ty) * ((1 - tx) * f[j, i] + tx * f[j, i + 1])
                   + ty * ((1 - tx) * f[j + 1, i] + tx * f[j + 1, i + 1]))
    return out


def l2_errors(base: Path, params: dict, evaluate) -> dict:
    """{u_L2_error[_regu], v_L2_error[_regu]} against every stored truth
    of this Re; ``evaluate(x, y)`` gives (u, v) at points."""
    Lx, Ly = float(params.get("Lx", 1.0)), float(params.get("Ly", 1.0))
    out = {}
    for root, suffix in ROOTS:
        t = truth(str(Path(base) / root), int(params["Re"]))
        if t is None:
            continue
        x, y, ref_u, ref_v = t
        cur_u, cur_v = evaluate(x, y)
        ok = ((x > 1e-10) & (x < Lx - 1e-10) & (y > 1e-10) & (y < Ly - 1e-10)
              & np.isfinite(cur_u) & np.isfinite(cur_v))
        for name, cur, ref in (("u", cur_u, ref_u), ("v", cur_v, ref_v)):
            out[f"{name}_L2_error{suffix}"] = float(
                np.linalg.norm(cur[ok] - ref[ok])
                / (np.linalg.norm(ref[ok]) + 1e-12)) if ok.any() else np.nan
    return out


def spectral_evaluator(n: int, params: dict, u, v):
    """(u, v) at scattered points of a tensor grid, by the polynomial
    interpolants of the collocation state."""
    def evaluate(x, y):
        xs, xi = np.unique(x, return_inverse=True)
        ys, yi = np.unique(y, return_inverse=True)
        fu = spectral.evaluate(n, params, u, xs, ys)
        fv = spectral.evaluate(n, params, v, xs, ys)
        return fu[xi, yi], fv[xi, yi]
    return evaluate


def fv_evaluator(params: dict, u, v):
    """(u, v) at points by bilinear interpolation of the cell fields."""
    ny, nx = np.shape(u)
    xc = (np.arange(nx) + 0.5) * float(params.get("Lx", 1.0)) / nx
    yc = (np.arange(ny) + 0.5) * float(params.get("Ly", 1.0)) / ny
    return lambda x, y: (bilinear(xc, yc, u, x, y), bilinear(xc, yc, v, x, y))


def gap(reported: dict, worked: dict) -> float:
    """The largest distance between the reported numbers and those worked
    out here; inf where a key is missing on either side or not finite."""
    if set(reported) != set(worked) or not worked:
        return float("inf")
    d = [abs(float(reported[k]) - worked[k]) for k in worked]
    return float(max(d)) if np.all(np.isfinite(d)) else float("inf")
