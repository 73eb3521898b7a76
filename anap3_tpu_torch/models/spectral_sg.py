"""Single-grid PN-PN-2 pseudospectral artificial-compressibility core, in
plain PyTorch.

The counterpart of ``anap3_tpu/models/spectral_sg.py``, with the same
numerical contract: velocities on the full (N+1)^2 Gauss-Lobatto grid,
pressure on the (N-1)^2 inner grid, residuals R_u = -(u.grad)u - grad p +
nu lap u and R_p = -beta^2 div u, the adaptive CFL pseudo-timestep, the
4-stage low-storage RK step with alpha = (1/4, 1/3, 1/2, 1) and BCs
re-enforced by a masked select after every stage, and the quadrature
metrics. Both lid modes are supported: the regularized lids ("smoothing",
"saad", ...) and "singular", the Botella & Peyret sharp-lid subtraction in
which the state holds the smooth remainder and the sampled corner-flow
fields enter convection and the diagnostics.

These functions are the plain versions the CUDA kernels of
``ops/sg_kernels.py`` are held against, and the path every CPU run takes.
Operators are built once on the host in float64 numpy and cast to the
working dtype on an explicit device.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import basis as basis_ops
from ..ops.corner import lid_profile
from ..ops.singular import singular_fields_on_grid
from ..utils import host_blas
from .params import SpectralParameters

__all__ = ["SpectralOps", "SpectralState", "build_spectral_ops", "ops_from_jax",
           "state_from_numpy", "state_to_numpy", "initial_state", "enforce_bc",
           "residuals", "adaptive_dt", "rk4_step", "sg_step",
           "conserved_quantities", "vorticity", "extrapolate_inner_to_full"]

RK4_ALPHAS = (0.25, 1.0 / 3.0, 0.5, 1.0)


class SpectralState(NamedTuple):
    """u, v on the full grid (nf, nf); p on the inner grid (nf-2, nf-2)."""

    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor


@dataclass
class SpectralOps:
    """Operators of one grid size, as tensors on one device and dtype.

    The matrices follow ``anap3_tpu``'s layout: left operators (Dx, Dxx, Ix,
    Gx) act on the row index, transposed right operators (DyT, DyyT, IyT,
    GyT) on the column index. Gx = Dx Ix and GyT = (Dy Iy)^T fuse the
    inner-to-full pressure interpolation with its derivative. Scalars are
    Python floats. The ``sing_*`` fields are set in singular mode only.
    """

    Dx: torch.Tensor        # (nf, nf)
    DyT: torch.Tensor       # (nf, nf)
    Dxx: torch.Tensor       # (nf, nf)
    DyyT: torch.Tensor      # (nf, nf)
    Ix: torch.Tensor        # (nf, ni)
    IyT: torch.Tensor       # (ni, nf)
    Gx: torch.Tensor        # (nf, ni)
    GyT: torch.Tensor       # (ni, nf)
    bc_u: torch.Tensor      # (nf, nf) boundary values (0 in the interior)
    bc_v: torch.Tensor
    interior: torch.Tensor  # (nf, nf) bool
    W2d: torch.Tensor       # (nf, nf) tensor-product quadrature weights
    nu: float
    beta_sq: float
    CFL: float
    lid_velocity: float
    inv_dx_min: float
    inv_dy_min: float
    sing_u: Optional[torch.Tensor] = None
    sing_v: Optional[torch.Tensor] = None
    sing_dudx: Optional[torch.Tensor] = None
    sing_dudy: Optional[torch.Tensor] = None
    sing_dvdx: Optional[torch.Tensor] = None
    sing_dvdy: Optional[torch.Tensor] = None
    sing_w: Optional[torch.Tensor] = None
    sing_dwx: Optional[torch.Tensor] = None
    sing_dwy: Optional[torch.Tensor] = None

    @property
    def nf(self) -> int:
        return int(self.Dx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.Dx.device

    @property
    def dtype(self) -> torch.dtype:
        return self.Dx.dtype

    @property
    def singular(self) -> bool:
        return self.sing_u is not None


_SCALARS = ("nu", "beta_sq", "CFL", "lid_velocity", "inv_dx_min",
            "inv_dy_min")


def _to_tensor(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float64, order="C"), dtype=dtype,
                           device=device)


def _pack(host: dict, device, dtype) -> SpectralOps:
    kwargs = {}
    for f in fields(SpectralOps):
        val = host.get(f.name)
        if f.name == "interior":
            kwargs[f.name] = torch.as_tensor(np.array(val, bool),
                                             device=device)
        elif f.name in _SCALARS:
            kwargs[f.name] = float(np.asarray(val))
        elif val is not None:
            kwargs[f.name] = _to_tensor(val, device, dtype)
    return SpectralOps(**kwargs)


@host_blas.one_thread()
def build_spectral_ops(params: SpectralParameters, n: Optional[int] = None,
                       dtype=None, device=None) -> Tuple[SpectralOps, dict]:
    """Operators + grid info for order ``n`` (default ``params.nx``).

    The numpy construction is ``anap3_tpu/models/spectral_sg.py``'s
    (build_spectral_ops, float64 on the host); the result is cast to
    ``dtype`` (default ``params.dtype``) on ``device`` (default
    ``params.device``). numpy's BLAS runs in one thread here, so the
    operators are the same bits on every host (``utils/host_blas``)."""
    n = int(params.nx if n is None else n)
    if params.nx != params.ny:
        raise ValueError(
            "Spectral solvers use a square polynomial order (nx == ny); "
            f"got nx={params.nx}, ny={params.ny}.")
    dtype = getattr(torch, str(params.dtype)) if dtype is None else dtype
    device = torch.device(params.device if device is None else device)

    bx = basis_ops.make_basis(params.basis_type, (0.0, params.Lx))
    by = basis_ops.make_basis(params.basis_type, (0.0, params.Ly))
    x_nodes = bx.nodes(n + 1)
    y_nodes = by.nodes(n + 1)
    Dx = bx.diff_matrix(n + 1)
    Dy = by.diff_matrix(n + 1)
    Dxx = Dx @ Dx
    Dyy = Dy @ Dy
    Ix = basis_ops.inner_to_full_interp_matrix(x_nodes)
    Iy = basis_ops.inner_to_full_interp_matrix(y_nodes)
    w_x = bx.quadrature_weights(n + 1)
    w_y = by.quadrature_weights(n + 1)

    nf = n + 1
    interior = np.zeros((nf, nf), dtype=bool)
    interior[1:-1, 1:-1] = True
    singular = None
    if str(params.corner_treatment).lower() == "singular":
        # the state is the smooth remainder u - u_s, whose boundary data
        # (sharp lid minus the sampled corner solutions) is continuous
        singular = singular_fields_on_grid(
            x_nodes, y_nodes, lid_velocity=params.lid_velocity,
            Lx=params.Lx, Ly=params.Ly)
        u_tot_bc = np.zeros((nf, nf))
        u_tot_bc[:, -1] = params.lid_velocity  # SHARP lid, corners included
        bc_u = np.where(~interior, u_tot_bc - singular["u"], 0.0)
        bc_v = np.where(~interior, -singular["v"], 0.0)
    else:
        u_lid = lid_profile(x_nodes, method=params.corner_treatment,
                            smoothing_width=params.corner_smoothing,
                            lid_velocity=params.lid_velocity, Lx=params.Lx)
        bc_u = np.zeros((nf, nf))
        bc_v = np.zeros((nf, nf))
        bc_u[:, -1] = u_lid  # lid applied last => owns the top corners
    dx_min = float(np.min(np.diff(x_nodes)))
    dy_min = float(np.min(np.diff(y_nodes)))

    host = {
        "Dx": Dx, "DyT": Dy.T, "Dxx": Dxx, "DyyT": Dyy.T, "Ix": Ix,
        "IyT": Iy.T, "Gx": Dx @ Ix, "GyT": (Dy @ Iy).T, "bc_u": bc_u,
        "bc_v": bc_v, "interior": interior, "W2d": np.outer(w_x, w_y),
        "nu": 1.0 / params.Re, "beta_sq": params.beta_squared,
        "CFL": params.CFL, "lid_velocity": params.lid_velocity,
        "inv_dx_min": 1.0 / dx_min, "inv_dy_min": 1.0 / dy_min,
    }
    if singular is not None:
        host.update({
            "sing_u": singular["u"], "sing_v": singular["v"],
            "sing_dudx": singular["dudx"], "sing_dudy": singular["dudy"],
            "sing_dvdx": singular["dvdx"], "sing_dvdy": singular["dvdy"],
            "sing_w": singular["omega"], "sing_dwx": singular["dwx"],
            "sing_dwy": singular["dwy"],
        })
    ops = _pack(host, device, dtype)
    grid = {
        "n": n, "x_nodes": x_nodes, "y_nodes": y_nodes,
        "shape_full": (nf, nf), "shape_inner": (n - 1, n - 1),
        "dx_min": dx_min, "dy_min": dy_min, "w_x": w_x, "w_y": w_y,
        "Dx": Dx, "Dy": Dy, "Dxx": Dxx, "Dyy": Dyy, "Ix": Ix, "Iy": Iy,
        "basis_x": bx, "basis_y": by, "singular": singular,
    }
    return ops, grid


def ops_from_jax(jax_ops, device, dtype) -> SpectralOps:
    """The port's operators from an ``anap3_tpu`` ``SpectralOps`` (leaves
    readable as numpy arrays), so both packages compute on the same
    numbers."""
    host = {f.name: getattr(jax_ops, f.name, None) for f in fields(SpectralOps)}
    host = {k: (None if v is None else np.asarray(v)) for k, v in host.items()}
    return _pack(host, torch.device(device), dtype)


def state_from_numpy(state, device, dtype) -> SpectralState:
    """A ``SpectralState`` from any (u, v, p) triple of array-likes."""
    u, v, p = (state.u, state.v, state.p) if hasattr(state, "u") else state
    return SpectralState(*(_to_tensor(a, torch.device(device), dtype)
                           for a in (u, v, p)))


def state_to_numpy(state: SpectralState) -> SpectralState:
    """The state's fields as numpy arrays of their own dtype."""
    return SpectralState(*(t.detach().cpu().numpy() for t in state))


def initial_state(ops: SpectralOps) -> SpectralState:
    """Impulsive start from rest. In singular mode "rest" means the TOTAL
    velocity is zero in the interior, i.e. the remainder is -u_s there."""
    nf = ops.nf
    if ops.singular:
        u, v = enforce_bc(ops, -ops.sing_u, -ops.sing_v)
    else:
        zero = torch.zeros((nf, nf), dtype=ops.dtype, device=ops.device)
        u, v = enforce_bc(ops, zero, zero)
    p = torch.zeros((nf - 2, nf - 2), dtype=ops.dtype, device=ops.device)
    return SpectralState(u=u, v=v, p=p)


def enforce_bc(ops: SpectralOps, u: torch.Tensor, v: torch.Tensor):
    """Masked-select BC enforcement."""
    return (torch.where(ops.interior, u, ops.bc_u),
            torch.where(ops.interior, v, ops.bc_v))


def residuals(ops: SpectralOps, u, v, p):
    """(R_u, R_v) on the full grid and R_p on the inner grid."""
    du_dx = ops.Dx @ u
    du_dy = u @ ops.DyT
    dv_dx = ops.Dx @ v
    dv_dy = v @ ops.DyT
    lap_u = ops.Dxx @ u + u @ ops.DyyT
    lap_v = ops.Dxx @ v + v @ ops.DyyT
    dp_dx = (ops.Gx @ p) @ ops.IyT
    dp_dy = (ops.Ix @ p) @ ops.GyT
    if ops.singular:
        # convect with the TOTAL velocity; the singular part's derivatives
        # are analytic samples (Stokes: its viscous/pressure/continuity
        # terms cancel, so those keep their remainder form)
        U = u + ops.sing_u
        V = v + ops.sing_v
        conv_u = U * (du_dx + ops.sing_dudx) + V * (du_dy + ops.sing_dudy)
        conv_v = U * (dv_dx + ops.sing_dvdx) + V * (dv_dy + ops.sing_dvdy)
    else:
        conv_u = u * du_dx + v * du_dy
        conv_v = u * dv_dx + v * dv_dy
    R_u = -conv_u - dp_dx + ops.nu * lap_u
    R_v = -conv_v - dp_dy + ops.nu * lap_v
    R_p = -ops.beta_sq * (du_dx + dv_dy)[1:-1, 1:-1]
    return R_u, R_v, R_p


def adaptive_dt(ops: SpectralOps, u, v) -> torch.Tensor:
    """CFL-limited pseudo-timestep (0-d tensor); wave speeds of the TOTAL
    velocity in singular mode."""
    if ops.singular:
        u = u + ops.sing_u
        v = v + ops.sing_v
    u_max = torch.clamp_min(torch.max(torch.abs(u)), ops.lid_velocity)
    v_max = torch.clamp_min(torch.max(torch.abs(v)), 1e-10)
    lam_x = (u_max + torch.sqrt(u_max ** 2 + ops.beta_sq)) * ops.inv_dx_min \
        + ops.nu * ops.inv_dx_min ** 2
    lam_y = (v_max + torch.sqrt(v_max ** 2 + ops.beta_sq)) * ops.inv_dy_min \
        + ops.nu * ops.inv_dy_min ** 2
    return ops.CFL / (lam_x + lam_y)


def rk4_step(ops: SpectralOps, state: SpectralState, tau=None):
    """One RK4 pseudo-timestep without the quadratures.

    Returns ``(new_state, (R_u, R_v, R_p))`` with the residuals of the LAST
    stage evaluation; ``tau`` (tau_u, tau_v, tau_p) is a FAS forcing added
    to every stage residual."""
    u0, v0, p0 = state
    dt = adaptive_dt(ops, u0, v0)
    u_in, v_in, p_in = u0, v0, p0
    for alpha in RK4_ALPHAS:
        R_u, R_v, R_p = residuals(ops, u_in, v_in, p_in)
        if tau is not None:
            R_u = R_u + tau[0]
            R_v = R_v + tau[1]
            R_p = R_p + tau[2]
        adt = alpha * dt
        u_in, v_in = enforce_bc(ops, u0 + adt * R_u, v0 + adt * R_v)
        p_in = p0 + adt * R_p
    return SpectralState(u_in, v_in, p_in), (R_u, R_v, R_p)


def sg_step(ops: SpectralOps, state: SpectralState, tau=None):
    """One RK4 pseudo-timestep. Returns ``(state, metrics)``: the last
    stage's residual norms and the conserved quantities, as 0-d tensors."""
    new, (R_u, R_v, R_p) = rk4_step(ops, state, tau)
    energy, enstrophy, palinstrophy = conserved_quantities(ops, new.u, new.v)
    metrics = {
        "u_eq": torch.linalg.norm(R_u),
        "v_eq": torch.linalg.norm(R_v),
        "continuity": torch.linalg.norm(R_p),
        "energy": energy,
        "enstrophy": enstrophy,
        "palinstrophy": palinstrophy,
    }
    return new, metrics


def conserved_quantities(ops: SpectralOps, u, v):
    """(energy, enstrophy, palinstrophy) by Gauss-Lobatto quadrature. In
    singular mode over the TOTAL fields: spectral derivatives act on the
    smooth remainder, the singular contributions are sampled."""
    omega = ops.Dx @ v - u @ ops.DyT
    dwx = ops.Dx @ omega
    dwy = omega @ ops.DyT
    if ops.singular:
        u = u + ops.sing_u
        v = v + ops.sing_v
        omega = omega + ops.sing_w
        dwx = dwx + ops.sing_dwx
        dwy = dwy + ops.sing_dwy
    energy = 0.5 * torch.sum(ops.W2d * (u * u + v * v))
    enstrophy = 0.5 * torch.sum(ops.W2d * omega * omega)
    palinstrophy = 0.5 * torch.sum(ops.W2d * (dwx * dwx + dwy * dwy))
    return energy, enstrophy, palinstrophy


def vorticity(ops: SpectralOps, u, v, total: bool = True) -> torch.Tensor:
    """Spectral vorticity dv/dx - du/dy on the full grid; ``total`` adds the
    sampled singular vorticity in singular mode."""
    om = ops.Dx @ v - u @ ops.DyT
    if total and ops.singular:
        om = om + ops.sing_w
    return om


def extrapolate_inner_to_full(p_inner: torch.Tensor) -> torch.Tensor:
    """Linear boundary extrapolation of an inner-grid field (pressure
    output only)."""
    ni = p_inner.shape[0]
    full = torch.zeros((ni + 2, ni + 2), dtype=p_inner.dtype,
                       device=p_inner.device)
    full[1:-1, 1:-1] = p_inner
    full[0, 1:-1] = 2 * full[1, 1:-1] - full[2, 1:-1]
    full[-1, 1:-1] = 2 * full[-2, 1:-1] - full[-3, 1:-1]
    full[1:-1, 0] = 2 * full[1:-1, 1] - full[1:-1, 2]
    full[1:-1, -1] = 2 * full[1:-1, -2] - full[1:-1, -3]
    full[0, 0] = 0.5 * (full[0, 1] + full[1, 0])
    full[0, -1] = 0.5 * (full[0, -2] + full[1, -1])
    full[-1, 0] = 0.5 * (full[-1, 1] + full[-2, 0])
    full[-1, -1] = 0.5 * (full[-1, -2] + full[-2, -1])
    return full
