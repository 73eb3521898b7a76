"""Field data loading for plotting (reference data_loading.py); the port's
own copy of ``anap3_tpu/plotting/data_loading.py``.

Loads the ``solution.vts`` artifact through the pure-Python VTS reader and
restructures the flat point arrays into 2D grids keyed by unique coordinates.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.vts import read_vts

__all__ = ["load_fields_from_vts", "restructure_fields", "fields_to_dataframe"]


def load_fields_from_vts(artifact_dir) -> dict:
    """Load u/v/pressure (+ coords) from <artifact_dir>/solution.vts."""
    vts_path = Path(artifact_dir) / "solution.vts"
    grid = read_vts(vts_path)
    out = {
        "x": grid.points[:, 0],
        "y": grid.points[:, 1],
        "u": np.asarray(grid.point_data["u"], float),
        "v": np.asarray(grid.point_data["v"], float),
        "pressure": np.asarray(grid.point_data.get("pressure"), float),
    }
    if "vorticity" in grid.point_data:
        out["vorticity"] = np.asarray(grid.point_data["vorticity"], float)
    return out


def restructure_fields(fields: dict):
    """(x_unique, y_unique, U_2d, V_2d, P_2d) with U_2d[j, i] at (x_i, y_j)."""
    x, y = fields["x"], fields["y"]
    x_unique = np.sort(np.unique(x))
    y_unique = np.sort(np.unique(y))
    nx, ny = len(x_unique), len(y_unique)
    order = np.lexsort((x, y))

    def to2d(a):
        return np.asarray(a)[order].reshape(ny, nx)

    return x_unique, y_unique, to2d(fields["u"]), to2d(fields["v"]), \
        to2d(fields["pressure"])


def fields_to_dataframe(fields: dict):
    import pandas as pd

    return pd.DataFrame({k: v for k, v in fields.items()})
