"""User-facing solver shell of the port.

The counterpart of ``anap3_tpu/models/base.py``: ``solve()``, ``params`` /
``metrics`` / ``fields`` / ``time_series``, vortex metrics, validation
errors and tables, the global quantities, VTS export (bilinear evaluation
and spline vorticity by default, as in the JAX base class) and the HDF5
``save`` (h5py and pandas, imported only there). Everything after the solve is numpy host
code, as in the JAX package. There is no compile cache (PyTorch runs
eagerly; the kernels cache their own build); ``checkpoint_dir`` is taken by
the SG and FV solves (``utils/checkpoint.py``).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..analysis import validation as validation_mod
from ..analysis.vortex import vortex_metrics_from_fields
from ..utils import vts as vts_mod
from ..utils.profiling import span
from .params import (Fields, Metrics, TimeSeries, resolve_device, resolve_dtype,
                     use_pallas_flag)
from .runner import IterationResult

log = logging.getLogger(__name__)

__all__ = ["CavitySolver"]

_VORTEX_KEYS = ("psi_min", "psi_min_x", "psi_min_y", "omega_center",
                "omega_max", "omega_max_x", "omega_max_y",
                "psi_BR", "omega_BR", "psi_BR_x", "psi_BR_y",
                "psi_BL", "omega_BL", "psi_BL_x", "psi_BL_y",
                "psi_TL", "omega_TL", "psi_TL_x", "psi_TL_y")


class CavitySolver:
    """Base class wiring a solver core into the experiment harness."""

    Parameters = None  # subclasses: SpectralParameters, FVParameters

    def __init__(self, params=None, **kwargs):
        if params is None:
            if self.Parameters is None:
                raise ValueError(
                    "Subclass must define a Parameters class attribute")
            kwargs.pop("_target_", None)
            params = self.Parameters(**kwargs)
        self.device = resolve_device(params.device)
        params.dtype = resolve_dtype(params.dtype, self.device)
        self.params = params
        self.metrics = Metrics()
        self.fields: Optional[Fields] = None
        self.time_series: Optional[TimeSeries] = None
        self._log_callback = None  # optional live-metric hook (tracking)

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        raise NotImplementedError

    def _restore_checkpoint(self):
        """``(manager, start_iteration)`` for ``checkpoint_dir``, with
        ``self.state`` restored from its latest checkpoint; ``(None, 0)``
        without a directory."""
        if not self.params.checkpoint_dir:
            return None, 0
        from ..utils.checkpoint import CheckpointManager

        mgr = CheckpointManager(
            self.params.checkpoint_dir, self.params,
            every_chunks=self.params.checkpoint_every_chunks)
        self.state, start_iter = mgr.restore_or(self.state)
        if start_iter:
            log.info("Resumed from checkpoint at iteration %d", start_iter)
        return mgr, start_iter

    def _use_pallas_flag(self) -> Optional[bool]:
        """``params.use_pallas`` as True, False or None (auto)."""
        return use_pallas_flag(self.params.use_pallas)

    def _final_fields(self) -> Fields:
        raise NotImplementedError

    def _vorticity_full(self) -> np.ndarray:
        raise NotImplementedError

    def _streamfunction(self):
        raise NotImplementedError

    def _evaluate_at_points(self, x: np.ndarray, y: np.ndarray):
        """Bilinear interpolation of the stored fields (the JAX default;
        the spectral solvers override it); NaN outside the cell centres."""
        from scipy.interpolate import RegularGridInterpolator

        x_unique = np.sort(np.unique(self.fields.x))
        y_unique = np.sort(np.unique(self.fields.y))
        nx, ny = len(x_unique), len(y_unique)
        order = np.lexsort((self.fields.x, self.fields.y))
        pts = np.column_stack([y, x])
        out = []
        for f in (self.fields.u, self.fields.v):
            interp = RegularGridInterpolator(
                (y_unique, x_unique), f[order].reshape(ny, nx),
                method="linear", bounds_error=False, fill_value=np.nan)
            out.append(interp(pts))
        return tuple(out)

    def _vorticity_for_export(self, U, V, x, y):
        """Spline derivatives for VTS export (the JAX default)."""
        from scipy.interpolate import RectBivariateSpline

        U_s = RectBivariateSpline(y, x, U)
        V_s = RectBivariateSpline(y, x, V)
        return V_s(y, x, dx=1) - U_s(y, x, dy=1)

    def _store_results(self, result: IterationResult,
                       max_timeseries_points: int = 1000) -> None:
        with span("solve.finish"):
            self.fields = self._final_fields()
        self.first_chunk_time = result.first_chunk_time
        hist = result.history

        def downsample(data):
            if data is None or len(data) <= max_timeseries_points:
                return data
            idx = np.linspace(0, len(data) - 1, max_timeseries_points,
                              dtype=int)
            return [data[i] for i in idx]

        self.time_series = TimeSeries(
            rel_iter_residual=downsample(hist.get("rel_iter")),
            u_residual=downsample(hist.get("u_eq")),
            v_residual=downsample(hist.get("v_eq")),
            continuity_residual=downsample(hist.get("continuity")),
            energy=downsample(hist.get("energy")),
            enstrophy=downsample(hist.get("enstrophy")),
            palinstrophy=downsample(hist.get("palinstrophy")),
        )
        try:
            vortex = self.compute_vortex_metrics()
        except Exception as exc:  # analysis must not lose the solve's result
            log.warning("Failed to compute vortex metrics: %s", exc,
                        exc_info=True)
            vortex = {}

        def last(key, default=0.0):
            vals = hist.get(key) or []
            return float(vals[-1]) if vals else default

        self.metrics = Metrics(
            iterations=result.iterations,
            converged=result.converged,
            stalled=result.stalled,
            final_residual=last("rel_iter", float("inf")),
            wall_time_seconds=result.wall_time,
            u_momentum_residual=last("u_eq"),
            v_momentum_residual=last("v_eq"),
            continuity_residual=last("continuity"),
            final_energy=last("energy"),
            final_enstrophy=last("enstrophy"),
            final_palinstrophy=last("palinstrophy"),
            **{k: vortex.get(k, 0.0) for k in _VORTEX_KEYS},
        )
        polish = getattr(self, "_polish_info", None)
        if polish:
            self.metrics.polish_steps = int(polish["steps"])
            self.metrics.steady_residual_rms = float(polish["rms"])

    def compute_vortex_metrics(self) -> Dict[str, float]:
        # a span a part, so that each holds few of the profiler's events
        with span("solve.finish"):
            psi, X, Y = self._streamfunction()
        with span("solve.finish"):
            omega = self._vorticity_full()
        with span("solve.finish"):
            return vortex_metrics_from_fields(psi, omega.reshape(psi.shape),
                                              X, Y)

    def compute_global_quantities(self) -> Dict[str, float]:
        """The final energy, enstrophy and palinstrophy (E, Z, P)."""
        return {
            "E": self.metrics.final_energy,
            "Z": self.metrics.final_enstrophy,
            "P": self.metrics.final_palinstrophy,
        }

    def compute_validation_errors(self, reference_dir: str = "data/validation/fv",
                                  base_dir=None,
                                  save_plots: bool = True) -> Dict[str, float]:
        roots = [("data/validation/fv", ""), ("data/validation/fv-regu", "_regu")]
        if reference_dir not in [r for r, _ in roots]:
            roots.insert(0, (reference_dir, ""))
            roots = list(dict.fromkeys(roots))
        self.validation_error_plots: list = []
        with span("validate"):
            return validation_mod.compute_l2_errors_vs_reference(
                self._evaluate_at_points, self.params.Re,
                Lx=self.params.Lx, Ly=self.params.Ly,
                reference_roots=tuple(roots), base_dir=base_dir,
                heatmap_method=(self.params.method or self.params.name)
                if save_plots else None,
                heatmap_paths=self.validation_error_plots,
            )

    def validation_table(self, base_dir=None):
        return validation_mod.botella_validation_rows(
            self.metrics, self.params.Re, base_dir=base_dir)

    def saad_table(self, base_dir=None):
        grid = f"{self.params.nx}x{self.params.ny}"
        return validation_mod.saad_quantities_rows(
            self.metrics, self.params.Re, grid, base_dir=base_dir)

    def to_vtk_payload(self):
        """(points, point_data, field_data, dims) in the reference VTS
        layout."""
        f = self.fields
        x_unique = np.sort(np.unique(f.x))
        y_unique = np.sort(np.unique(f.y))
        nx, ny = len(x_unique), len(y_unique)
        order = np.lexsort((f.x, f.y))
        U = f.u[order].reshape(ny, nx)
        V = f.v[order].reshape(ny, nx)
        P = f.p[order].reshape(ny, nx)
        X, Y = np.meshgrid(x_unique, y_unique)

        def frav(a):  # pyvista point order: Fortran ravel of (ny, nx)
            return np.asarray(a).ravel("F")

        points = np.column_stack([frav(X), frav(Y), np.zeros(nx * ny)])
        vort = self._vorticity_for_export(U, V, x_unique, y_unique)
        vel = np.zeros((nx * ny, 3))
        vel[:, 0] = frav(U)
        vel[:, 1] = frav(V)
        point_data = {
            "u": frav(U), "v": frav(V), "pressure": frav(P),
            "velocity_magnitude": frav(np.sqrt(U**2 + V**2)),
            "vorticity": frav(vort), "velocity": vel,
        }
        field_data = {
            "Re": np.array([int(self.params.Re)], dtype=np.int64),
            "N": np.array([int(self.params.nx)], dtype=np.int64),
            "solver": str(self.params.name),
        }
        return points, point_data, field_data, (ny, nx, 1)

    def save_vtk(self, filepath) -> None:
        points, pdata, fdata, dims = self.to_vtk_payload()
        vts_mod.write_vts(filepath, points, pdata, fdata, dims)
        log.info("Saved VTS to %s", filepath)

    def save(self, filepath) -> None:
        """Write params, metrics, time series and fields to HDF5, the JAX
        package's layout (``anap3_tpu/models/base.py:save``): one group per
        table (params, metrics, time_series, fields; the last two when
        present), one dataset per column, text as bytes. Needs h5py and
        pandas, imported here: without them it raises ImportError naming
        the missing package, before any file is opened."""
        try:
            import h5py
            import pandas  # noqa: F401  (the tables' to_dataframe)
        except ImportError as exc:
            raise ImportError(f"CavitySolver.save needs the {exc.name} "
                              f"package, which is not installed") from exc
        filepath = Path(filepath)
        filepath.parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(filepath, "w") as h5:
            for group, table in (
                    ("params", self.params),
                    ("metrics", self.metrics),
                    ("time_series", self.time_series),
                    ("fields", self.fields)):
                if table is None:
                    continue
                df = table.to_dataframe()
                if group == "params":
                    # the port's run control; the JAX package has none
                    df = df.drop(columns=["device"], errors="ignore")
                g = h5.create_group(group)
                for col in df.columns:
                    vals = df[col].to_numpy()
                    if vals.dtype == object:
                        vals = vals.astype("S")
                    g.create_dataset(col, data=vals)
        log.info("Saved HDF5 to %s", filepath)
