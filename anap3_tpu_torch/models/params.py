"""Parameters of the port: the JAX package's dataclasses plus a device.

``SpectralParameters`` and ``FVParameters`` add ``device`` to
``anap3_tpu``'s dataclasses (which are jax-free; only its ``resolve_dtype``
imports jax, and this module does not use it). The device is explicit:
``"cuda"`` without a card raises, and the plain PyTorch path runs on the
host only when ``device="cpu"`` is asked for.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from anap3_tpu.models.params import Fields, Metrics, TimeSeries
from anap3_tpu.models.params import FVParameters as _FVParameters
from anap3_tpu.models.params import SpectralParameters as _SpectralParameters

__all__ = ["SpectralParameters", "FVParameters", "Metrics", "TimeSeries",
           "Fields", "resolve_device", "resolve_dtype"]


@dataclass
class SpectralParameters(_SpectralParameters):
    """Spectral solver parameters with the torch device they run on."""

    device: str = "cuda"


@dataclass
class FVParameters(_FVParameters):
    """FV-SIMPLE solver parameters with the torch device they run on."""

    device: str = "cuda"


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; raises when CUDA is asked for and
    absent (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch sees no CUDA "
            "device; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: cuda or cpu")
    return dev


def resolve_dtype(dtype, device) -> str:
    """Resolve the ``"auto"`` precision policy against the device.

    ``auto`` is float32 on CUDA (the TPU's production precision, so the
    iteration counts compare with the JAX records) and float64 on the CPU
    (the reference's semantics)."""
    s = str(dtype).lower()
    if s != "auto":
        return str(dtype)
    return "float32" if torch.device(device).type == "cuda" else "float64"
