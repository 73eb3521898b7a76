"""Solver models of the port: spectral SG, FSG, VMG and FMG, FV-SIMPLE, the
Newton-Krylov steady solver, plus the solve harness."""

from .params import (FVParameters, SpectralParameters, Metrics,  # noqa: F401
                     TimeSeries, Fields)

_LAZY = {
    "SGSolver": ("anap3_tpu_torch.models.spectral", "SGSolver"),
    "FSGSolver": ("anap3_tpu_torch.models.spectral", "FSGSolver"),
    "FVSolver": ("anap3_tpu_torch.models.fv", "FVSolver"),
    "VMGSolver": ("anap3_tpu_torch.models.spectral_vmg", "VMGSolver"),
    "FMGSolver": ("anap3_tpu_torch.models.spectral_vmg", "FMGSolver"),
    "NewtonSolver": ("anap3_tpu_torch.models.steady", "NewtonSolver"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
