"""Direct separable Poisson solver by tensor-product diagonalization.

The counterpart of ``anap3_tpu/ops/poisson.py`` for the spectral
streamfunction: for L = Ax (x) I + I (x) Ay the 1-D eigendecompositions are
built once on the host in float64 numpy, and a solve is four matrix
products and one elementwise scale,

    U = Vx [ (Vx^-1 F Vy^-T) / (lx_i + ly_j) ] Vy^T.

The products are plain ``torch.matmul`` in the working dtype (never TF32),
outside any kernel, as they are plain XLA products in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SeparablePoisson", "spectral_dirichlet_poisson"]


@dataclass
class SeparablePoisson:
    """Direct solver for (Ax (x) I + I (x) Ay) u = f."""

    Vx: torch.Tensor
    Vx_inv: torch.Tensor
    Vy: torch.Tensor
    Vy_inv: torch.Tensor
    inv_lam: torch.Tensor  # (nx, ny): 1 / (lx_i + ly_j)
    Ax: torch.Tensor
    Ay: torch.Tensor

    @classmethod
    def build(cls, Ax: np.ndarray, Ay: np.ndarray, dtype=torch.float64,
              device="cpu") -> "SeparablePoisson":
        torch.backends.cuda.matmul.allow_tf32 = False
        Ax64 = np.asarray(Ax, dtype=np.float64)
        Ay64 = np.asarray(Ay, dtype=np.float64)
        lx, Vx = np.linalg.eig(Ax64)
        ly, Vy = np.linalg.eig(Ay64)
        # the Dirichlet collocation Laplacians have real spectra; drop the
        # numerically-zero imaginary parts
        lx, Vx = np.real(lx), np.real(Vx)
        ly, Vy = np.real(ly), np.real(Vy)
        inv = 1.0 / (lx[:, None] + ly[None, :])
        cast = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                         device=device)
        return cls(cast(Vx), cast(np.linalg.inv(Vx)), cast(Vy),
                   cast(np.linalg.inv(Vy)), cast(inv), cast(Ax64),
                   cast(Ay64))

    def solve(self, f) -> torch.Tensor:
        """Solve L u = f for a 2-D right-hand side of shape (nx, ny)."""
        f = torch.as_tensor(f, dtype=self.Vx.dtype, device=self.Vx.device)
        fhat = (self.Vx_inv @ f) @ self.Vy_inv.T
        return (self.Vx @ (fhat * self.inv_lam)) @ self.Vy.T

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """L u = Ax u + u Ay^T."""
        return self.Ax @ u + u @ self.Ay.T


def spectral_dirichlet_poisson(Dxx_1d: np.ndarray, Dyy_1d: np.ndarray,
                               dtype=torch.float64,
                               device="cpu") -> SeparablePoisson:
    """Interior spectral Laplacian with homogeneous Dirichlet BCs: the
    boundary unknowns vanish, leaving Ax = Dxx[1:-1, 1:-1] and
    Ay = Dyy[1:-1, 1:-1]."""
    return SeparablePoisson.build(np.asarray(Dxx_1d)[1:-1, 1:-1],
                                  np.asarray(Dyy_1d)[1:-1, 1:-1],
                                  dtype=dtype, device=device)
