"""Direct separable Poisson solvers by tensor-product diagonalization.

The counterpart of ``anap3_tpu/ops/poisson.py``: for L = Ax (x) I + I (x) Ay
the 1-D eigendecompositions are built once on the host in float64 numpy,
and a solve is four matrix products and one elementwise scale,

    U = Vx [ (Vx^-1 F Vy^-T) / (lx_i + ly_j) ] Vy^T.

The products are plain ``torch.matmul`` in the working dtype (never TF32),
outside any kernel, as they are plain XLA products in the JAX package. The
FV pressure solve inside the fused SIMPLE kernel runs its own products
(``csrc/fv_dense.cu``) on these operators.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SeparablePoisson", "spectral_dirichlet_poisson",
           "fd_dirichlet_poisson", "fv_neumann_pressure_poisson"]


@dataclass
class SeparablePoisson:
    """Direct solver for (Ax (x) I + I (x) Ay) u = f.

    ``symmetric=True`` builds with ``eigh``, so the eigenbases are
    orthogonal and their inverses are plain transposes. ``zero_mode_tol``
    > 0 nulls the near-zero eigenvalue sums of a singular (Neumann)
    operator, which selects the mean-free solution; ``singular`` records it
    so that ``solve_refined`` projects its residuals."""

    Vx: torch.Tensor
    Vx_inv: torch.Tensor
    Vy: torch.Tensor
    Vy_inv: torch.Tensor
    inv_lam: torch.Tensor  # (nx, ny): 1 / (lx_i + ly_j), 0 on nulled modes
    Ax: torch.Tensor
    Ay: torch.Tensor
    singular: bool = False

    @classmethod
    def build(cls, Ax: np.ndarray, Ay: np.ndarray, dtype=torch.float64,
              device="cpu", zero_mode_tol: float = 0.0,
              symmetric: bool = False) -> "SeparablePoisson":
        torch.backends.cuda.matmul.allow_tf32 = False
        Ax64 = np.asarray(Ax, dtype=np.float64)
        Ay64 = np.asarray(Ay, dtype=np.float64)
        if symmetric:
            lx, Vx = np.linalg.eigh(Ax64)
            ly, Vy = np.linalg.eigh(Ay64)
            Vx_inv, Vy_inv = Vx.T, Vy.T
        else:
            lx, Vx = np.linalg.eig(Ax64)
            ly, Vy = np.linalg.eig(Ay64)
            # the Dirichlet collocation Laplacians have real spectra; drop
            # the numerically-zero imaginary parts
            lx, Vx = np.real(lx), np.real(Vx)
            ly, Vy = np.real(ly), np.real(Vy)
            Vx_inv, Vy_inv = np.linalg.inv(Vx), np.linalg.inv(Vy)
        lam = lx[:, None] + ly[None, :]
        if zero_mode_tol > 0.0:
            scale = max(np.abs(lam).max(), 1.0)
            mask = np.abs(lam) > zero_mode_tol * scale
            inv = np.where(mask, 1.0 / np.where(mask, lam, 1.0), 0.0)
        else:
            inv = 1.0 / lam
        cast = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                         device=device)
        return cls(cast(Vx), cast(Vx_inv), cast(Vy), cast(Vy_inv), cast(inv),
                   cast(Ax64), cast(Ay64), singular=zero_mode_tol > 0.0)

    def solve(self, f) -> torch.Tensor:
        """Solve L u = f for a 2-D right-hand side of shape (nx, ny)."""
        f = torch.as_tensor(f, dtype=self.Vx.dtype, device=self.Vx.device)
        fhat = (self.Vx_inv @ f) @ self.Vy_inv.T
        return (self.Vx @ (fhat * self.inv_lam)) @ self.Vy.T

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """L u = Ax u + u Ay^T."""
        return self.Ax @ u + u @ self.Ay.T

    def solve_refined(self, f, n_refine: int = 1) -> torch.Tensor:
        """Direct solve plus ``n_refine`` steps of iterative refinement;
        on a singular operator each residual is projected mean-free."""
        f = torch.as_tensor(f, dtype=self.Vx.dtype, device=self.Vx.device)
        u = self.solve(f)
        for _ in range(int(n_refine)):
            r = f - self.apply(u)
            if self.singular:
                r = r - torch.mean(r)
            u = u + self.solve(r)
        return u


def spectral_dirichlet_poisson(Dxx_1d: np.ndarray, Dyy_1d: np.ndarray,
                               dtype=torch.float64,
                               device="cpu") -> SeparablePoisson:
    """Interior spectral Laplacian with homogeneous Dirichlet BCs: the
    boundary unknowns vanish, leaving Ax = Dxx[1:-1, 1:-1] and
    Ay = Dyy[1:-1, 1:-1]."""
    return SeparablePoisson.build(np.asarray(Dxx_1d)[1:-1, 1:-1],
                                  np.asarray(Dyy_1d)[1:-1, 1:-1],
                                  dtype=dtype, device=device)


def _fd_dirichlet_1d(n_interior: int, h: float) -> np.ndarray:
    """Second-difference operator with homogeneous Dirichlet ends."""
    main = np.full(n_interior, -2.0 / h**2)
    off = np.full(n_interior - 1, 1.0 / h**2)
    return np.diag(main) + np.diag(off, 1) + np.diag(off, -1)


def fd_dirichlet_poisson(nx_interior: int, ny_interior: int, dx: float,
                         dy: float, dtype=torch.float64,
                         device="cpu") -> SeparablePoisson:
    """5-point FD interior Laplacian with psi = 0 walls (streamfunction)."""
    return SeparablePoisson.build(
        _fd_dirichlet_1d(nx_interior, dx), _fd_dirichlet_1d(ny_interior, dy),
        dtype=dtype, device=device, symmetric=True)


def _fv_neumann_1d(n_cells: int, d_conductance: float) -> np.ndarray:
    """Cell-centred conductance Laplacian with homogeneous Neumann ends."""
    A = np.zeros((n_cells, n_cells))
    for i in range(n_cells):
        if i > 0:
            A[i, i - 1] = d_conductance
            A[i, i] -= d_conductance
        if i < n_cells - 1:
            A[i, i + 1] = d_conductance
            A[i, i] -= d_conductance
    return A


def fv_neumann_pressure_poisson(nx: int, ny: int, dx: float, dy: float,
                                rho: float = 1.0, dtype=torch.float64,
                                device="cpu") -> SeparablePoisson:
    """Direct solver of the FV pressure-correction equation, the NEGATIVE
    conductance Laplacian (the reference's sign), singular with a constant
    null space: the mean-free solution is returned and the caller gauges
    it. Built as ``build(Ay, Ax)``, so ``Vx`` is the y eigenbasis (ny, ny)
    applied from the left to (ny, nx) fields and ``inv_lam`` is (ny, nx)."""
    Ax = -_fv_neumann_1d(nx, rho * dy / dx)
    Ay = -_fv_neumann_1d(ny, rho * dx / dy)
    return SeparablePoisson.build(Ay, Ax, dtype=dtype, device=device,
                                  zero_mode_tol=1e-12, symmetric=True)
