"""Configuration and result dataclasses of the port.

The port's own copies of ``anap3_tpu/models/params.py``'s dataclasses, with
every field name, default and order as they are there (so the
``conf/solver/*.yaml`` overrides and ``main.py``'s instantiation keep
working), plus ``device`` as the last field of ``SpectralParameters`` and
``FVParameters``. The device is explicit: ``"cuda"`` without a card
raises, and the plain PyTorch path runs on the host only when
``device="cpu"`` is asked for.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import List, Optional

import numpy as np
import torch

__all__ = ["Parameters", "SpectralParameters", "FVParameters", "Metrics",
           "TimeSeries", "Fields", "resolve_device", "resolve_dtype",
           "use_pallas_flag", "lane_kernels_on"]


@dataclass
class Parameters:
    """Base solver parameters (input configuration)."""

    name: str = ""
    Re: float = 100.0
    lid_velocity: float = 1.0
    Lx: float = 1.0
    Ly: float = 1.0
    nx: int = 64
    ny: int = 64
    max_iterations: int = 500
    tolerance: float = 1e-4
    method: str = ""
    # working precision of the device hot path ("auto": resolve_dtype)
    dtype: str = "float64"
    # mid-solve checkpoint/resume (utils/checkpoint.py); empty = disabled
    checkpoint_dir: str = ""
    checkpoint_every_chunks: int = 10
    # iterations per device chunk between host reads
    chunk_size: int = 200
    # "auto" | "rel_iter" | "residual" | "energy" (models/runner.py)
    convergence_metric: str = "auto"
    # stall detection: -1 auto, 0 off, >0 chunks without >2% improvement
    stall_chunks: int = -1

    def to_mlflow(self) -> dict:
        return {
            k: (int(v) if isinstance(v, bool) else v)
            for k, v in asdict(self).items()
        }

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame([self.to_mlflow()])


@dataclass
class FVParameters(Parameters):
    """FV-SIMPLE parameters."""

    convection_scheme: str = "Upwind"
    limiter: str = "MUSCL"
    alpha_uv: float = 0.6
    alpha_p: float = 0.4
    linear_solver_tol: float = 1e-6
    method: str = "FV-SIMPLE"
    corner_treatment: str = "none"
    corner_smoothing: float = 0.15
    # the fused SIMPLE kernels: "auto" (on CUDA) | true | false
    use_pallas: str = "auto"
    fv_inner_iters: int = 16
    # "compact" Rhie-Chow face pressure gradient, or the reference's
    # "averaged" formulation
    rhie_chow: str = "compact"
    device: str = "cuda"


@dataclass
class SpectralParameters(Parameters):
    """Spectral solver parameters."""

    basis_type: str = "legendre"
    CFL: float = 0.1
    beta_squared: float = 5.0
    method: str = "Spectral-AC"
    corner_treatment: str = "smoothing"
    corner_smoothing: float = 0.15
    multigrid: str = "none"  # "none" | "fsg" | "vmg" | "fmg"
    n_levels: int = 3
    # "auto" | "x3" | "x6" (exact products on the card); "x1" raises
    matmul_algorithm: str = "auto"
    # the SG kernels: "auto" (on CUDA) | true | false
    use_pallas: str = "auto"
    coarse_tolerance_factor: float = 10.0
    prolongation_method: str = "fft"
    restriction_method: str = "fft"
    # Newton-Krylov / PTC knobs (models/steady.py, solver=gpu/newton) and
    # the float64 Newton polish of the marched solvers (newton_polish)
    newton_max_steps: int = 50
    gmres_vectors: int = 60
    newton_dt0: float = 0.05
    newton_dt_max: float = 3e3
    newton_schur_iters: int = 40
    newton_prelude: int = 0
    initial_state_path: str = ""
    newton_polish: bool = False
    newton_polish_tol: float = 1e-9
    newton_polish_steps: int = 12
    device: str = "cuda"


@dataclass
class Metrics:
    """Scalar output metrics."""

    iterations: int = 0
    converged: bool = False
    # the criterion plateaued above tolerance and stall detection stopped
    stalled: bool = False
    final_residual: float = float("inf")
    wall_time_seconds: float = 0.0
    u_momentum_residual: float = 0.0
    v_momentum_residual: float = 0.0
    continuity_residual: float = 0.0
    final_energy: float = 0.0
    final_enstrophy: float = 0.0
    final_palinstrophy: float = 0.0

    psi_min: float = 0.0
    psi_min_x: float = 0.0
    psi_min_y: float = 0.0
    omega_center: float = 0.0
    omega_max: float = 0.0
    omega_max_x: float = 0.0
    omega_max_y: float = 0.0
    psi_BR: float = 0.0
    omega_BR: float = 0.0
    psi_BR_x: float = 0.0
    psi_BR_y: float = 0.0
    psi_BL: float = 0.0
    omega_BL: float = 0.0
    psi_BL_x: float = 0.0
    psi_BL_y: float = 0.0
    psi_TL: float = 0.0
    omega_TL: float = 0.0
    psi_TL_x: float = 0.0
    psi_TL_y: float = 0.0

    # newton_polish=true extras (0 when the polish is off): PTC steps taken
    # and the float64 RMS steady residual of the final state
    polish_steps: int = 0
    steady_residual_rms: float = 0.0

    def to_mlflow(self) -> dict:
        return {
            k: (int(v) if isinstance(v, bool) else v)
            for k, v in self.__dict__.items()
            if v != float("inf")
        }

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame([self.to_mlflow()])


@dataclass
class TimeSeries:
    """Per-iteration convergence histories."""

    rel_iter_residual: Optional[List[float]] = field(default_factory=list)
    u_residual: Optional[List[float]] = field(default_factory=list)
    v_residual: Optional[List[float]] = field(default_factory=list)
    continuity_residual: Optional[List[float]] = field(default_factory=list)
    energy: Optional[List[float]] = field(default_factory=list)
    enstrophy: Optional[List[float]] = field(default_factory=list)
    palinstrophy: Optional[List[float]] = field(default_factory=list)

    def to_batch(self) -> list:
        """(key, value, step) triples for batched metric logging."""
        return [
            (name, float(value), step)
            for name, values in self.__dict__.items()
            if values
            for step, value in enumerate(values)
            if value is not None
        ]

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame({k: v for k, v in self.__dict__.items() if v})


@dataclass
class Fields:
    """Flat spatial solution arrays on the solver's grid."""

    u: np.ndarray
    v: np.ndarray
    p: np.ndarray
    x: np.ndarray
    y: np.ndarray

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame(
            {"x": self.x, "y": self.y, "u": self.u, "v": self.v, "p": self.p}
        )


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


def use_pallas_flag(flag) -> Optional[bool]:
    """The ``use_pallas`` knob as True, False or None (auto)."""
    if isinstance(flag, bool):
        return flag
    s = str(flag).lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no"):
        return False
    return None


def lane_kernels_on(params, device) -> bool:
    """Whether a batch of lanes with ``params`` on ``device`` takes the
    lane kernels: ``use_pallas`` true, or auto on CUDA."""
    flag = use_pallas_flag(getattr(params, "use_pallas", "auto"))
    return flag is True or (flag is None and
                            torch.device(device).type == "cuda")
