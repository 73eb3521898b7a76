"""Tracking-store helpers for plotting (reference mlflow_utils.py); the
port's own copy of ``anap3_tpu/plotting/tracking_utils.py``.

Sibling discovery by parent-run tag, artifact access, and metric-history
DataFrames, implemented against utils.tracking's file store.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List

from ..utils import tracking as T

log = logging.getLogger(__name__)

__all__ = [
    "find_sibling_runs",
    "artifact_dir_for_run",
    "load_timeseries",
    "upload_plots",
]


def find_sibling_runs(parent_run_id: str, tracking_uri=None) -> List[dict]:
    """Child runs of a parent, as dicts with run_id/N/Re/solver/status."""
    if tracking_uri:
        T.set_tracking_uri(tracking_uri)
    runs = T.search_runs(parent_run_id=parent_run_id)
    out = []
    for r in runs:
        params = r["params"]
        out.append({
            "run_id": r["run_id"],
            "run_name": r["run_name"],
            "status": r["status"],
            "N": int(float(params.get("nx", 0))),
            "Re": float(params.get("Re", 0)),
            "solver": r["tags"].get("solver", params.get("name", "unknown")),
            "metrics": r["metrics"],
        })
    return out


def artifact_dir_for_run(run_id: str, tracking_uri=None) -> Path:
    if tracking_uri:
        T.set_tracking_uri(tracking_uri)
    return T._run_dir(run_id) / "artifacts"


def load_timeseries(run_id: str, tracking_uri=None,
                    keys=("rel_iter_residual", "u_residual", "v_residual",
                          "continuity_residual", "energy", "enstrophy",
                          "palinstrophy")):
    """Step-indexed metric histories as a DataFrame (one column per metric)."""
    import pandas as pd

    if tracking_uri:
        T.set_tracking_uri(tracking_uri)
    frames = {}
    for key in keys:
        hist = T.get_metric_history(run_id, key)
        if hist:
            frames[key] = pd.Series({s: v for s, v in hist})
    if not frames:
        return pd.DataFrame()
    df = pd.DataFrame(frames)
    df.index.name = "step"
    return df.sort_index()


def upload_plots(run_id: str, plot_paths: List[Path], tracking_uri=None) -> None:
    if tracking_uri:
        T.set_tracking_uri(tracking_uri)
    with T.attach_run(run_id):
        for p in plot_paths:
            if p and Path(p).exists():
                T.log_artifact(p, artifact_path="plots")
