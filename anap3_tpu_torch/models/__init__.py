"""Solver models of the port: spectral SG and FSG, plus the solve harness."""

from .params import SpectralParameters, Metrics, TimeSeries, Fields  # noqa: F401

_LAZY = {
    "SGSolver": ("anap3_tpu_torch.models.spectral", "SGSolver"),
    "FSGSolver": ("anap3_tpu_torch.models.spectral", "FSGSolver"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
