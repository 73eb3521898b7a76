"""Multigrid transfer operators as precomputed dense matrices.

The port's own copy of ``anap3_tpu/ops/transfer.py`` (float64 numpy); the
V-cycle of ``models/spectral_vmg.py`` applies them with ``torch.matmul``.

The reference implements DCT-I based prolongation/restriction with per-call
``scipy.fft.dct`` plus a JIT polynomial evaluation loop
(``src/solvers/spectral/operators/transfer_operators.py``). On TPU the right
formulation is different: grid sizes are fixed per multigrid level, so each
transfer is a *constant linear operator* — we materialize it once as an
(n_to, n_from) matrix and apply 2D transfers as two MXU matmuls:

    U_fine = P_x @ U_coarse @ P_y^T

This is mathematically identical to DCT-analysis + Chebyshev synthesis and is
the speed-of-light formulation for small fixed N on a systolic array.

Conventions match the reference exactly:
- nodes are CGL with theta_j = pi j / N (ascending x = -cos theta; the theta
  parameterization makes the operator orientation-free),
- analysis uses boundary half-weights on both the samples and the
  coefficients (transfer_operators.py:237-252),
- restriction truncates to the leading n_coarse coefficients
  (transfer_operators.py:309-325).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "chebyshev_analysis_matrix",
    "chebyshev_synthesis_matrix",
    "fft_prolongation_matrix",
    "fft_restriction_matrix",
    "polynomial_prolongation_matrix",
    "injection_restriction_matrix",
    "make_transfer_matrices",
    "nodal_interpolation_matrix",
    "nodal_injection_matrix",
    "modal_restriction_matrix",
    "make_level_transfer_matrices",
]


def chebyshev_analysis_matrix(num_points: int) -> np.ndarray:
    """Matrix A with a = A @ u giving Chebyshev coefficients of CGL samples.

    A[k, j] = (2 / (N c_k c_j)) cos(pi k j / N), c_0 = c_N = 2 else 1.
    """
    n = num_points - 1
    j = np.arange(num_points)
    c = np.ones(num_points)
    c[0] = c[-1] = 2.0
    cosines = np.cos(np.pi * np.outer(j, j) / n)
    return (2.0 / n) * cosines / np.outer(c, c)


def chebyshev_synthesis_matrix(num_points_to: int, num_coeffs: int) -> np.ndarray:
    """Matrix S with u_to = S @ a evaluating a Chebyshev series on CGL nodes.

    S[i, k] = cos(k pi i / N_to).
    """
    n_to = num_points_to - 1
    i = np.arange(num_points_to)
    k = np.arange(num_coeffs)
    return np.cos(np.pi * np.outer(i, k) / n_to)


def fft_prolongation_matrix(n_coarse: int, n_fine: int) -> np.ndarray:
    """(n_fine, n_coarse) spectrally-exact prolongation (DCT-I method)."""
    if n_coarse > n_fine:
        raise ValueError(f"prolongation requires n_coarse ({n_coarse}) <= n_fine ({n_fine})")
    if n_coarse == n_fine:
        return np.eye(n_fine)
    return chebyshev_synthesis_matrix(n_fine, n_coarse) @ chebyshev_analysis_matrix(n_coarse)


def fft_restriction_matrix(n_fine: int, n_coarse: int) -> np.ndarray:
    """(n_coarse, n_fine) restriction by spectral truncation (DCT-I method)."""
    if n_fine < n_coarse:
        raise ValueError(f"restriction requires n_fine ({n_fine}) >= n_coarse ({n_coarse})")
    if n_fine == n_coarse:
        return np.eye(n_fine)
    A = chebyshev_analysis_matrix(n_fine)[:n_coarse, :]  # truncate high modes
    return chebyshev_synthesis_matrix(n_coarse, n_coarse) @ A


def polynomial_prolongation_matrix(n_coarse: int, n_fine: int) -> np.ndarray:
    """Prolongation via Chebyshev-Vandermonde interpolation (equivalent up to
    roundoff to the DCT form; reference transfer_operators.py:333-376)."""
    from numpy.polynomial.chebyshev import chebvander

    if n_coarse == n_fine:
        return np.eye(n_fine)
    x_c = np.cos(np.pi * np.arange(n_coarse) / (n_coarse - 1))
    x_f = np.cos(np.pi * np.arange(n_fine) / (n_fine - 1))
    V_c = chebvander(x_c, n_coarse - 1)
    V_f = chebvander(x_f, n_coarse - 1)
    return np.linalg.solve(V_c.T, V_f.T).T


def injection_restriction_matrix(n_fine: int, n_coarse: int) -> np.ndarray:
    """Restriction by direct injection (coarse CGL nodes nest in fine ones).

    For n_fine = 2*n_coarse - 1 this picks every other fine point; otherwise
    it picks the nearest fine node to each coarse node.
    """
    if n_fine == n_coarse:
        return np.eye(n_fine)
    R = np.zeros((n_coarse, n_fine))
    if n_fine == 2 * n_coarse - 1:
        R[np.arange(n_coarse), 2 * np.arange(n_coarse)] = 1.0
        return R
    x_f = np.cos(np.pi * np.arange(n_fine) / (n_fine - 1))
    x_c = np.cos(np.pi * np.arange(n_coarse) / (n_coarse - 1))
    nearest = np.argmin(np.abs(x_f[None, :] - x_c[:, None]), axis=1)
    R[np.arange(n_coarse), nearest] = 1.0
    return R


def nodal_interpolation_matrix(x_from: np.ndarray, x_to: np.ndarray) -> np.ndarray:
    """Exact polynomial interpolation matrix between ARBITRARY node sets.

    The DCT-based operators above assume the data sits on Chebyshev-Lobatto
    nodes of matching order — true for the FULL velocity grids, but NOT for
    the PN-PN-2 INNER pressure grids (interior CGL nodes are not a smaller
    CGL grid). Inner-grid transfers must therefore be built from the actual
    node positions. (The reference applies its CGL-based operators to inner
    grids too — transfer_operators.py restrict/prolongate_2d on shape_inner —
    a latent inconsistency that FSG never exposes because it only prolongates
    solutions that smoothing then repairs; a FAS V-cycle DOES expose it.)
    """
    from .basis import interpolation_matrix_1d

    return interpolation_matrix_1d(np.asarray(x_from), np.asarray(x_to))


def nodal_injection_matrix(x_fine: np.ndarray, x_coarse: np.ndarray) -> np.ndarray:
    """Injection by nearest node position (exact when grids nest)."""
    x_fine = np.asarray(x_fine)
    x_coarse = np.asarray(x_coarse)
    R = np.zeros((x_coarse.size, x_fine.size))
    nearest = np.argmin(np.abs(x_fine[None, :] - x_coarse[:, None]), axis=1)
    R[np.arange(x_coarse.size), nearest] = 1.0
    return R


def _to_reference_interval(x: np.ndarray) -> np.ndarray:
    """Affine map of a Lobatto node set (endpoints included) onto [-1, 1]."""
    x = np.asarray(x, dtype=np.float64)
    return 2.0 * (x - x[0]) / (x[-1] - x[0]) - 1.0


def modal_restriction_matrix(x_fine: np.ndarray,
                             x_coarse: np.ndarray) -> np.ndarray:
    """Restriction by LEGENDRE-modal truncation between arbitrary node sets.

    The non-Chebyshev analog of :func:`fft_restriction_matrix`: fine nodal
    values -> Legendre coefficients (square Vandermonde solve) -> keep the
    leading ``len(x_coarse)`` modes -> evaluate at the coarse nodes. Exact
    on polynomials of degree < len(x_coarse); high modes are dropped rather
    than aliased, which is what FAS defect restriction requires. Reduces to
    the same truncation semantics as the DCT path (reference
    transfer_operators.py:309-325) with the Chebyshev basis swapped for
    Legendre.
    """
    from .basis import jacobi_vandermonde

    xf = _to_reference_interval(x_fine)
    xc = _to_reference_interval(x_coarse)
    nf, nc = xf.size, xc.size
    Vf = jacobi_vandermonde(xf, 0.0, 0.0, nf - 1)      # (nf, nf), square
    Vc = jacobi_vandermonde(xc, 0.0, 0.0, nc - 1)      # (nc, nc)
    T = np.zeros((nc, nf))
    T[:, :nc] = Vc                                     # truncate to nc modes
    return T @ np.linalg.inv(Vf)


def make_level_transfer_matrices(
    x_coarse: np.ndarray,
    x_fine: np.ndarray,
    prolongation_method: str = "fft",
    restriction_method: str = "fft",
    chebyshev: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Basis-aware (P, R) pair for one full-grid level transition.

    On Chebyshev-Lobatto grids this defers to the DCT-based
    :func:`make_transfer_matrices` (bit-identical to the previous behavior).
    On any other node set (e.g. Legendre-Gauss-Lobatto, where the DCT
    identities do NOT hold and coarse nodes do NOT nest in fine ones) it
    builds the mathematically equivalent operators from the actual node
    positions: exact polynomial interpolation for prolongation (also what
    ``prolongation_method=polynomial`` means), Legendre-modal truncation
    ("fft") or exact resampling ("injection") for restriction.
    """
    if chebyshev:
        return make_transfer_matrices(len(x_coarse), len(x_fine),
                                      prolongation_method, restriction_method)
    P = nodal_interpolation_matrix(x_coarse, x_fine)
    if restriction_method == "fft":
        R = modal_restriction_matrix(x_fine, x_coarse)
    elif restriction_method == "injection":
        # exact resampling of the (polynomial) fine field at coarse nodes —
        # LGL grids do not nest, so index injection does not exist
        R = nodal_interpolation_matrix(x_fine, x_coarse)
    else:
        raise ValueError(f"Unknown restriction method: {restriction_method!r}")
    return P, R


def make_transfer_matrices(
    n_coarse: int,
    n_fine: int,
    prolongation_method: str = "fft",
    restriction_method: str = "fft",
) -> tuple[np.ndarray, np.ndarray]:
    """Build the (P, R) pair for one level transition.

    P is (n_fine, n_coarse); R is (n_coarse, n_fine). Apply in 2D as
    ``P @ U @ P.T`` / ``R @ U @ R.T``.
    """
    if prolongation_method == "fft":
        P = fft_prolongation_matrix(n_coarse, n_fine)
    elif prolongation_method == "polynomial":
        P = polynomial_prolongation_matrix(n_coarse, n_fine)
    else:
        raise ValueError(f"Unknown prolongation method: {prolongation_method!r}")
    if restriction_method == "fft":
        R = fft_restriction_matrix(n_fine, n_coarse)
    elif restriction_method == "injection":
        R = injection_restriction_matrix(n_fine, n_coarse)
    else:
        raise ValueError(f"Unknown restriction method: {restriction_method!r}")
    return P, R
