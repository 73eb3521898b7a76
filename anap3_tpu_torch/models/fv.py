"""Collocated FV-SIMPLE solver on a structured Cartesian grid, in PyTorch.

The counterpart of ``anap3_tpu/models/fv.py``. One SIMPLE iteration
(``fv_step``) is: the unlimited pressure gradient; upwind + diffusion
momentum coefficients with the deferred high-order correction; ONE joint
u/v BiCGSTAB predictor solve (the two momentum matrices are identical on
the cavity), Jacobi-preconditioned and matrix-free, with the semantics of
``jax.scipy.sparse.linalg.bicgstab``; ``bold_D`` from the unrelaxed
diagonal; Rhie-Chow face velocities; the exact pressure-correction solve by
tensor-product diagonalization with the cell-0 gauge; corrections and the
mass-flux update. The metrics are ||u'||, ||v'||, ||div(mdot)|| and the FD
conserved quantities with Dirichlet ghost cells.

On CUDA, ``FVSolver`` runs the fused SIMPLE iteration of
``ops/fv_kernels.py`` (hand-written CUDA kernels with a fixed-count inner
BiCGSTAB, as the Pallas kernel does); ``fv_step`` is the path of the
configurations the fused kernels do not take.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .base import CavitySolver
from .params import Fields, FVParameters
from .runner import WARMUP_ITERS, run_fixed_point
from ..ops import fv_stencils as st
from ..ops.corner import lid_profile
from ..ops.poisson import (SeparablePoisson, fd_dirichlet_poisson,
                           fv_neumann_pressure_poisson)

log = logging.getLogger(__name__)

__all__ = ["FVSolver", "FVState", "FVOps", "fv_step", "build_fv_ops",
           "fv_ops_from_jax", "fv_state_from_numpy", "initial_state",
           "fd_vorticity", "bicgstab"]


class FVState(NamedTuple):
    u: torch.Tensor    # (ny, nx) cell-centred
    v: torch.Tensor
    p: torch.Tensor
    mx: torch.Tensor   # (ny, nx-1) internal x-face mass flux
    my: torch.Tensor   # (ny-1, nx) internal y-face mass flux


@dataclass
class FVOps:
    """Static per-solve data: tensors in the working dtype on the solve's
    device, with the pressure-correction solver inside."""

    mu: torch.Tensor            # 0-d
    rho: torch.Tensor           # 0-d
    dx: float
    dy: float
    alpha_uv: float
    alpha_p: float
    lin_tol: float
    lid_velocity: torch.Tensor  # 0-d
    bc_u_n: torch.Tensor        # lid profile at the top-face centres (nx,)
    zeros_x: torch.Tensor       # (ny,)
    zeros_y: torch.Tensor       # (nx,)
    scheme: str
    limiter: Optional[str]
    rhie_chow: str
    poisson: SeparablePoisson
    n_refine: int               # refinement steps of the pressure solve

    @property
    def nx(self) -> int:
        return int(self.bc_u_n.shape[0])

    @property
    def ny(self) -> int:
        return int(self.zeros_x.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.bc_u_n.dtype

    @property
    def device(self) -> torch.device:
        return self.bc_u_n.device


def _torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "float64": torch.float64}[str(name)]


def build_fv_ops(params: FVParameters, dtype=None, device=None
                 ) -> tuple[FVOps, dict]:
    """Operators and grid facts of ``params`` (anap3_tpu's build_fv_ops),
    on ``params.device`` unless ``device`` is given."""
    dtype = _torch_dtype(params.dtype if dtype is None else dtype)
    device = torch.device(params.device if device is None else device)
    nx, ny = int(params.nx), int(params.ny)
    dx, dy = params.Lx / nx, params.Ly / ny
    rho = 1.0
    mu = rho * params.lid_velocity * params.Lx / params.Re

    x_centers = (np.arange(nx) + 0.5) * dx
    y_centers = (np.arange(ny) + 0.5) * dy
    # the lid BC at the top-face centres, corner treatment baked in
    bc_u_n = lid_profile(x_centers, method=params.corner_treatment,
                         smoothing_width=params.corner_smoothing,
                         lid_velocity=params.lid_velocity, Lx=params.Lx)

    limiter = (params.limiter if params.limiter not in ("none", "None", "")
               else None)
    # float32: the linear tolerance is clamped to ~10 ulp and the pressure
    # solve takes one refinement step (the JAX package's f32 mode)
    eps = float(torch.finfo(dtype).eps)
    lin_tol = max(float(params.linear_solver_tol), 10.0 * eps)
    n_refine = 1 if dtype == torch.float32 else 0
    kw = dict(dtype=dtype, device=device)
    ops = FVOps(
        mu=torch.tensor(mu, **kw), rho=torch.tensor(rho, **kw),
        dx=float(dx), dy=float(dy),
        alpha_uv=float(params.alpha_uv), alpha_p=float(params.alpha_p),
        lin_tol=lin_tol,
        lid_velocity=torch.tensor(params.lid_velocity, **kw),
        bc_u_n=torch.as_tensor(np.asarray(bc_u_n), **kw),
        zeros_x=torch.zeros(ny, **kw), zeros_y=torch.zeros(nx, **kw),
        scheme=str(params.convection_scheme), limiter=limiter,
        rhie_chow=str(params.rhie_chow),
        poisson=fv_neumann_pressure_poisson(nx, ny, dx, dy, rho, dtype=dtype,
                                            device=device),
        n_refine=n_refine)
    grid = {"nx": nx, "ny": ny, "dx": dx, "dy": dy,
            "x_centers": x_centers, "y_centers": y_centers,
            "mu": mu, "rho": rho}
    return ops, grid


def fv_ops_from_jax(jax_ops, device, dtype) -> FVOps:
    """The port's operators from an ``anap3_tpu`` ``FVOps`` (leaves readable
    as numpy arrays), so both packages compute on the same numbers."""
    kw = dict(dtype=dtype, device=torch.device(device))
    t = lambda a: torch.as_tensor(np.array(a), **kw)
    P = jax_ops.poisson
    poisson = SeparablePoisson(t(P.Vx), t(P.Vx_inv), t(P.Vy), t(P.Vy_inv),
                               t(P.inv_lam), t(P.Ax), t(P.Ay),
                               singular=bool(P.singular))
    return FVOps(
        mu=t(jax_ops.mu), rho=t(jax_ops.rho), dx=float(jax_ops.dx),
        dy=float(jax_ops.dy), alpha_uv=float(jax_ops.alpha_uv),
        alpha_p=float(jax_ops.alpha_p), lin_tol=float(jax_ops.lin_tol),
        lid_velocity=t(jax_ops.lid_velocity), bc_u_n=t(jax_ops.bc_u_n),
        zeros_x=t(jax_ops.zeros_x), zeros_y=t(jax_ops.zeros_y),
        scheme=str(jax_ops.scheme), limiter=jax_ops.limiter,
        rhie_chow=str(jax_ops.rhie_chow), poisson=poisson,
        n_refine=int(jax_ops.n_refine))


def fv_state_from_numpy(state, device, dtype) -> FVState:
    """An ``FVState`` from any (u, v, p, mx, my) tuple of array-likes."""
    return FVState(*(torch.as_tensor(np.array(a),
                                     dtype=dtype, device=torch.device(device))
                     for a in state))


def initial_state(ops: FVOps) -> FVState:
    """The fluid at rest."""
    ny, nx = ops.ny, ops.nx
    z = lambda *shape: torch.zeros(shape, dtype=ops.dtype, device=ops.device)
    return FVState(z(ny, nx), z(ny, nx), z(ny, nx), z(ny, nx - 1),
                   z(ny - 1, nx))


# ------------------------------------------------------------- BiCGSTAB


def _vdot(a, b):
    return torch.sum(a * b)


def bicgstab(A, b, x0, tol: float, atol: float = 0.0, maxiter: int = 1000,
             M=lambda x: x):
    """Preconditioned BiCGSTAB with the semantics of
    ``jax.scipy.sparse.linalg.bicgstab``: p = q = r0 at the start; stop when
    ||r||^2 <= max(tol^2 ||b||^2, atol^2) or after ``maxiter`` iterations;
    the early exit on ||s||^2 < atol2; breakdown exits on omega = 0 or
    alpha = 0 (code -11) and rho = 0 (code -10). Inner products run over
    the whole (stacked) array. Returns (x, iterations or breakdown code)."""
    atol2 = torch.clamp_min(tol * tol * _vdot(b, b), atol * atol)
    r = b - A(x0)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    x, rhat, p, q = x0, r, r, r
    rho = alpha = omega = one
    k = 0
    while bool(_vdot(r, r) > atol2) and k < maxiter and k >= 0:
        rho_ = _vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = M(p)
        q = A(phat)
        alpha = rho_ / _vdot(rhat, q)
        s = r - alpha * q
        exit_early = bool(_vdot(s, s) < atol2)
        shat = M(s)
        t = A(shat)
        omega = _vdot(t, s) / _vdot(t, t)
        if exit_early:
            x = x + alpha * phat
            r = s
        else:
            x = x + (alpha * phat + omega * shat)
            r = s - omega * t
        k = -11 if bool((omega == 0) | (alpha == 0)) else k + 1
        if bool(rho_ == 0):
            k = -10
        rho = rho_
    return x, k


def _solve_momentum_uv(ops: FVOps, coeffs: st.MomentumCoeffs, rhs_u, rhs_v,
                       u_prev, v_prev):
    """Joint u/v momentum solve: one BiCGSTAB over the stacked (2, ny, nx)
    system with Patankar under-relaxation and a Jacobi preconditioner."""
    alpha = ops.alpha_uv
    aP_rel = coeffs.aP / alpha
    scale = (1.0 - alpha) / alpha
    rhs = torch.stack([rhs_u + scale * coeffs.aP * u_prev,
                       rhs_v + scale * coeffs.aP * v_prev])
    x, _ = bicgstab(
        lambda phi: st.apply_momentum_operator(coeffs, phi,
                                               aP_override=aP_rel),
        rhs, torch.stack([u_prev, v_prev]), tol=ops.lin_tol, maxiter=1000,
        M=lambda phi: phi / aP_rel)
    return x[0], x[1], coeffs.aP


def fv_step(ops: FVOps, state: FVState):
    """One SIMPLE iteration. Returns (new_state, metrics)."""
    u, v, p, mx, my = state
    dx, dy = ops.dx, ops.dy
    vol = dx * dy

    gpx, gpy = st.cell_gradient(p, dx, dy, use_limiter=False)
    cu = st.momentum_coefficients(mx, my, ops.mu, dx, dy, ops.zeros_x,
                                  ops.zeros_x, ops.zeros_y, ops.bc_u_n)
    cv = st.momentum_coefficients(mx, my, ops.mu, dx, dy, ops.zeros_x,
                                  ops.zeros_x, ops.zeros_y, ops.zeros_y)
    b_u = cu.b + st.deferred_correction(u, mx, my, ops.scheme, ops.limiter)
    b_v = cv.b + st.deferred_correction(v, mx, my, ops.scheme, ops.limiter)
    rhs_u = b_u - gpx * vol
    rhs_v = b_v - gpy * vol
    u_star, v_star, aP_uv = _solve_momentum_uv(ops, cu, rhs_u, rhs_v, u, v)

    # bold_D from the UNRELAXED diagonal
    Du = vol / (aP_uv + 1e-14)
    Dv = Du

    ubar_x = st.face_average_x(u_star)
    vbar_y = st.face_average_y(v_star)
    if ops.rhie_chow == "compact":
        dpdx_face = (p[:, 1:] - p[:, :-1]) / dx
        dpdy_face = (p[1:, :] - p[:-1, :]) / dy
        corr_x = st.face_average_x(Du) * (dpdx_face - st.face_average_x(gpx))
        corr_y = st.face_average_y(Dv) * (dpdy_face - st.face_average_y(gpy))
        Uf_x = ubar_x - corr_x
        Uf_y = vbar_y - corr_y
    else:  # "averaged": the reference's formulation, the correction cancels
        Uf_x = ubar_x
        Uf_y = vbar_y
    mx_star = ops.rho * Uf_x * dy
    my_star = ops.rho * Uf_y * dx

    rhs_p = -st.divergence_from_fluxes(mx_star, my_star)
    rhs_p = rhs_p - torch.mean(rhs_p)
    p_prime = ops.poisson.solve_refined(rhs_p, ops.n_refine)
    p_prime = p_prime - p_prime[0, 0]    # the reference's cell-0 pinning

    gppx, gppy = st.cell_gradient(p_prime, dx, dy, use_limiter=False)
    u_prime = -Du * gppx
    v_prime = -Dv * gppy
    u_new = u_star + u_prime
    v_new = v_star + v_prime
    p_new = p + ops.alpha_p * p_prime
    mx_new = mx_star + ops.rho * st.face_average_x(u_prime) * dy
    my_new = my_star + ops.rho * st.face_average_y(v_prime) * dx

    mass_imbalance = st.divergence_from_fluxes(mx_new, my_new)
    metrics = {
        "u_eq": torch.linalg.norm(u_prime),
        "v_eq": torch.linalg.norm(v_prime),
        "continuity": torch.linalg.norm(mass_imbalance),
    }
    metrics.update(_conserved_quantities(ops, u_new, v_new, dx, dy))
    return FVState(u_new, v_new, p_new, mx_new, my_new), metrics


# ------------------------------------------- FD conserved quantities


def _ghost_pad(f, bc_w, bc_e, bc_s, bc_n):
    """Pad with ghost = 2*bc - interior; corners average adjacent ghosts."""
    ny, nx = f.shape
    g = torch.zeros((ny + 2, nx + 2), dtype=f.dtype, device=f.device)
    g[1:-1, 1:-1] = f
    g[0, 1:-1] = 2.0 * bc_s - f[0, :]
    g[-1, 1:-1] = 2.0 * bc_n - f[-1, :]
    g[1:-1, 0] = 2.0 * bc_w - f[:, 0]
    g[1:-1, -1] = 2.0 * bc_e - f[:, -1]
    g[0, 0] = 0.5 * (g[0, 1] + g[1, 0])
    g[0, -1] = 0.5 * (g[0, -2] + g[1, -1])
    g[-1, 0] = 0.5 * (g[-1, 1] + g[-2, 0])
    g[-1, -1] = 0.5 * (g[-1, -2] + g[-2, -1])
    return g


def _fd_gradient(f, dx, dy, bc=0.0, bc_lid=None):
    bc_lid = bc if bc_lid is None else bc_lid
    z = torch.zeros(f.shape[1], dtype=f.dtype, device=f.device)
    zx = torch.zeros(f.shape[0], dtype=f.dtype, device=f.device)
    g = _ghost_pad(f, zx + bc, zx + bc, z + bc, z + bc_lid)
    dfdx = (g[1:-1, 2:] - g[1:-1, :-2]) / (2.0 * dx)
    dfdy = (g[2:, 1:-1] - g[:-2, 1:-1]) / (2.0 * dy)
    return dfdx, dfdy


def fd_vorticity(u, v, dx, dy, lid_velocity):
    """omega = dv/dx - du/dy with cavity ghost BCs; the u-ghost at the lid
    uses the CONSTANT lid velocity whatever the corner treatment (the
    reference's choice, kept)."""
    dvdx, _ = _fd_gradient(v, dx, dy, bc=0.0, bc_lid=0.0)
    _, dudy = _fd_gradient(u, dx, dy, bc=0.0, bc_lid=lid_velocity)
    return dvdx - dudy


def _conserved_quantities(ops, u, v, dx, dy):
    dA = dx * dy
    energy = 0.5 * torch.sum(u * u + v * v) * dA
    omega = fd_vorticity(u, v, dx, dy, ops.lid_velocity)
    enstrophy = 0.5 * torch.sum(omega * omega) * dA
    dwx, dwy = _fd_gradient(omega, dx, dy, bc=0.0)
    palinstrophy = 0.5 * torch.sum(dwx * dwx + dwy * dwy) * dA
    return {"energy": energy, "enstrophy": enstrophy,
            "palinstrophy": palinstrophy}


# ------------------------------------------------------------ solver


class FVSolver(CavitySolver):
    """Finite-volume SIMPLE solver (reference fv/solver.py)."""

    Parameters = FVParameters
    rho = 1.0

    def __init__(self, params=None, **kwargs):
        super().__init__(params=params, **kwargs)
        self.ops, self.grid = build_fv_ops(self.params, device=self.device)
        self.state = initial_state(self.ops)
        self._psi_poisson = None

    def _fused_paths(self, metric: str):
        """``(step, chunk_runner_factory)`` of the path this configuration
        takes. ``use_pallas`` keeps its meaning: auto = the CUDA kernels on
        the card and ``fv_step`` on the CPU; true = the kernel wrappers
        (their plain versions on CPU tensors; an unsupported configuration
        raises); false = ``fv_step``. Under auto on the card, MUSCL-sharp
        and averaged Rhie-Chow run ``fv_step`` with a warning, counted in
        ``fv_kernels.PLAIN_CALLS["fv_unfused"]``."""
        from ..ops import fv_kernels as fvk

        ops, params = self.ops, self.params
        flag = self._use_pallas_flag()
        enabled = self.device.type == "cuda" if flag is None else flag
        if enabled and flag is None:
            try:
                fvk.validate(ops)
            except ValueError as exc:
                log.warning("Fused FV kernels unavailable (%s); running the "
                            "unfused fv_step on %s", exc, self.device)
                return fvk.unfused_step(ops), None
        if not enabled:
            return (lambda s: fv_step(ops, s)), None
        K = int(params.fv_inner_iters)
        step = fvk.make_fv_step(params, ops, bicgstab_iters=K)
        if metric not in ("rel_iter", "energy"):
            return step, None

        def factory(chunk, tol_, metric_):
            # "energy" arrives mapped to (rel_iter, tolerance 0): the kernel
            # only detects divergence and the plateau test runs on the host
            return fvk.make_fv_chunk_runner(params, ops, chunk, tol_,
                                            WARMUP_ITERS, bicgstab_iters=K)

        return step, factory

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        tol = self.params.tolerance if tolerance is None else tolerance
        max_iter = self.params.max_iterations if max_iter is None else max_iter
        # "auto" resolves to rel_iter for FV at every size
        from .spectral import resolve_convergence_metric

        metric = resolve_convergence_metric(self.params,
                                            auto_large="rel_iter")
        step, chunk_runner = self._fused_paths(metric)
        stall = int(self.params.stall_chunks)
        if stall < 0:  # auto: the f32 criterion can floor above tolerance
            stall = 25 if self.params.dtype == "float32" else 0
        result = run_fixed_point(
            step, lambda s: (s.u, s.v), self.state,
            tolerance=tol, max_iterations=max_iter,
            chunk=self.params.chunk_size,
            log_callback=self._log_callback,
            convergence_metric=metric, chunk_runner=chunk_runner,
            stall_chunks=stall)
        if result.stalled:
            log.warning(
                "Convergence stalled at %s=%.3e (> tol %.1e): float32 noise "
                "floor reached after %d iterations; stopping with the best "
                "attainable state.", metric,
                result.history["rel_iter"][-1]
                if result.history.get("rel_iter") else float("nan"),
                tol, result.iterations)
        self.state = result.state
        self._store_results(result)

    # -- field plumbing --------------------------------------------------

    def _final_fields(self) -> Fields:
        X, Y = np.meshgrid(self.grid["x_centers"], self.grid["y_centers"])
        f64 = lambda t: t.detach().to("cpu", torch.float64).numpy().ravel()
        return Fields(u=f64(self.state.u), v=f64(self.state.v),
                      p=f64(self.state.p), x=X.ravel(), y=Y.ravel())

    def _vorticity_full(self) -> np.ndarray:
        om = fd_vorticity(self.state.u, self.state.v, self.grid["dx"],
                          self.grid["dy"], self.ops.lid_velocity)
        return om.detach().cpu().numpy()

    def _streamfunction(self):
        from ..analysis.vortex import solve_streamfunction

        ny, nx = self.params.ny, self.params.nx
        if self._psi_poisson is None:
            self._psi_poisson = fd_dirichlet_poisson(
                ny - 2, nx - 2, self.grid["dy"], self.grid["dx"],
                dtype=self.ops.dtype, device=self.device)
        psi = solve_streamfunction(self._psi_poisson, self._vorticity_full())
        X, Y = np.meshgrid(self.grid["x_centers"], self.grid["y_centers"])
        return psi, X, Y

