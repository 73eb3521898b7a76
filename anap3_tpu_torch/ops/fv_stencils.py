"""Structured-grid stencils of the FV-SIMPLE solver, in plain torch.

The counterpart of ``anap3_tpu/ops/fv_stencils.py``, function for function
and with its conventions: cell arrays are (ny, nx) with index [j, i];
x-faces sit between (j, i) and (j, i+1) in (ny, nx-1) arrays, y-faces
between (j, i) and (j+1, i) in (ny-1, nx) arrays; boundary mass fluxes are
zero. Every gradient pins cell 0 (its neighbors exclude it), and the MUSCL
deferred correction uses the reference's extrapolated upstream value, so
its limiter argument r is (down-up)/(down-up+1e-12), psi ~= 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = [
    "cell_gradient",
    "momentum_coefficients",
    "deferred_correction",
    "face_average_x",
    "face_average_y",
    "divergence_from_fluxes",
    "apply_momentum_operator",
    "MomentumCoeffs",
]


def shift_e(a: torch.Tensor) -> torch.Tensor:
    """East neighbor a[j, i+1] at [j, i]; zero beyond the last column."""
    return F.pad(a[:, 1:], (0, 1))


def shift_w(a: torch.Tensor) -> torch.Tensor:
    return F.pad(a[:, :-1], (1, 0))


def shift_n(a: torch.Tensor) -> torch.Tensor:
    return F.pad(a[1:, :], (0, 0, 0, 1))


def shift_s(a: torch.Tensor) -> torch.Tensor:
    return F.pad(a[:-1, :], (0, 0, 1, 0))


def neighbor_masks(shape, dtype, device, pin_cell0: bool):
    """Validity masks of the E/W/N/S neighbors, excluding the pinned cell."""
    ny, nx = shape
    kw = dict(dtype=dtype, device=device)
    has_e = torch.ones((ny, nx), **kw)
    has_e[:, -1] = 0
    has_w = torch.ones((ny, nx), **kw)
    has_w[:, 0] = 0
    has_n = torch.ones((ny, nx), **kw)
    has_n[-1, :] = 0
    has_s = torch.ones((ny, nx), **kw)
    has_s[0, :] = 0
    if pin_cell0:
        # cell (0,1) has no west and cell (1,0) no south: both skip cell 0
        has_w[0, 1] = 0
        has_s[1, 0] = 0
    return has_e, has_w, has_n, has_s


def cell_gradient(phi: torch.Tensor, dx: float, dy: float,
                  use_limiter: bool = True, pin_cell0: bool = True):
    """Central-difference cell gradients, one-sided at walls, with the
    optional Barth-Jespersen limiter on both components."""
    dt = phi.dtype
    has_e, has_w, has_n, has_s = neighbor_masks(phi.shape, dt, phi.device,
                                                pin_cell0)
    phi_e, phi_w = shift_e(phi), shift_w(phi)
    phi_n, phi_s = shift_n(phi), shift_s(phi)
    zero = torch.zeros((), dtype=dt, device=phi.device)

    sum_x = has_e * (phi_e - phi) / dx + has_w * (phi - phi_w) / dx
    cnt_x = has_e + has_w
    gx = torch.where(cnt_x > 0, sum_x / torch.clamp_min(cnt_x, 1), zero)
    sum_y = has_n * (phi_n - phi) / dy + has_s * (phi - phi_s) / dy
    cnt_y = has_n + has_s
    gy = torch.where(cnt_y > 0, sum_y / torch.clamp_min(cnt_y, 1), zero)

    if use_limiter:
        big = torch.tensor(torch.finfo(dt).max, dtype=dt, device=phi.device)
        cand_max = torch.stack([
            torch.where(has_e > 0, phi_e, -big),
            torch.where(has_w > 0, phi_w, -big),
            torch.where(has_n > 0, phi_n, -big),
            torch.where(has_s > 0, phi_s, -big), phi])
        cand_min = torch.stack([
            torch.where(has_e > 0, phi_e, big),
            torch.where(has_w > 0, phi_w, big),
            torch.where(has_n > 0, phi_n, big),
            torch.where(has_s > 0, phi_s, big), phi])
        umax = cand_max.max(dim=0).values
        umin = cand_min.min(dim=0).values
        one = torch.ones((), dtype=dt, device=phi.device)

        def face_ratio(mask, delta):
            pos = delta > 1e-20
            negd = delta < -1e-20
            r = torch.where(pos, (umax - phi) / torch.where(pos, delta, one),
                            one)
            r = torch.where(negd, (umin - phi) / torch.where(negd, delta, one),
                            r)
            return torch.where(mask > 0, r, one)

        lim = torch.ones_like(phi)
        for mask, ddx, ddy in ((has_e, dx, 0.0), (has_w, -dx, 0.0),
                               (has_n, 0.0, dy), (has_s, 0.0, -dy)):
            lim = torch.minimum(lim, face_ratio(mask, gx * ddx + gy * ddy))
        active = (umax > phi) | (umin < phi)
        lim = torch.where(active, lim, one)
        gx = lim * gx
        gy = lim * gy

    if pin_cell0:
        gx = gx.clone()
        gy = gy.clone()
        gx[0, 0] = 0.0
        gy[0, 0] = 0.0
    return gx, gy


class MomentumCoeffs(NamedTuple):
    """5-point stencil coefficients and the convection-free RHS part."""

    aP: torch.Tensor
    aE: torch.Tensor
    aW: torch.Tensor
    aN: torch.Tensor
    aS: torch.Tensor
    b: torch.Tensor


def momentum_coefficients(mx, my, mu, dx, dy, bc_w, bc_e, bc_s, bc_n
                          ) -> MomentumCoeffs:
    """Upwind + diffusion coefficients (Moukalled 15.72 form) from the
    internal-face mass fluxes; ``bc_*`` are the Dirichlet values of the
    transported component along each wall (length ny for w/e, nx for s/n)."""
    ny, nx = mx.shape[0], my.shape[1]
    kw = dict(dtype=mx.dtype, device=mx.device)
    Dx = mu * dy / dx
    Dy = mu * dx / dy

    mx_pos = torch.clamp_min(mx, 0.0)
    mx_neg = torch.clamp_min(-mx, 0.0)
    my_pos = torch.clamp_min(my, 0.0)
    my_neg = torch.clamp_min(-my, 0.0)

    aE = torch.zeros((ny, nx), **kw)
    aE[:, :-1] = -(mx_neg + Dx)
    aW = torch.zeros((ny, nx), **kw)
    aW[:, 1:] = -(mx_pos + Dx)
    aN = torch.zeros((ny, nx), **kw)
    aN[:-1, :] = -(my_neg + Dy)
    aS = torch.zeros((ny, nx), **kw)
    aS[1:, :] = -(my_pos + Dy)

    aP = torch.zeros((ny, nx), **kw)
    aP[:, :-1] += mx_pos + Dx
    aP[:, 1:] += mx_neg + Dx
    aP[:-1, :] += my_pos + Dy
    aP[1:, :] += my_neg + Dy

    # boundary faces: half-cell distance, conductance 2*D, no convection
    b = torch.zeros((ny, nx), **kw)
    aP[:, 0] += 2.0 * Dx
    b[:, 0] += 2.0 * Dx * bc_w
    aP[:, -1] += 2.0 * Dx
    b[:, -1] += 2.0 * Dx * bc_e
    aP[0, :] += 2.0 * Dy
    b[0, :] += 2.0 * Dy * bc_s
    aP[-1, :] += 2.0 * Dy
    b[-1, :] += 2.0 * Dy * bc_n
    return MomentumCoeffs(aP=aP, aE=aE, aW=aW, aN=aN, aS=aS, b=b)


def _muscl(r):
    """Symmetric MUSCL limiter max(0, min(2, 2r, (1+r)/2)) for r > 0."""
    lim = torch.clamp_min(torch.minimum(torch.clamp_max(2.0 * r, 2.0),
                                        0.5 * (1.0 + r)), 0.0)
    return torch.where(r > 0.0, lim, torch.zeros_like(r))


def deferred_correction(phi, mx, my, scheme: str = "TVD",
                        limiter: Optional[str] = "MUSCL"):
    """Per-cell deferred-correction source m*(phi_HO - phi_upwind) of every
    face, scattered -dc into the owner and +dc into the neighbor.

    Limiter modes as in the JAX package: None (psi = 1), "MUSCL" (the
    reference's extrapolated upstream value, psi ~= 1) and "MUSCL-sharp"
    (the true second-upstream neighbor where it exists)."""
    if scheme.lower() == "upwind":
        return torch.zeros_like(phi)
    sharp = limiter is not None and str(limiter).lower() == "muscl-sharp"

    def face_dc(m, up, down, upup_valid, upup):
        if limiter is None:
            psi = torch.ones_like(up)
        else:
            if sharp:
                denom = torch.where(upup_valid, up - upup, down - up) + 1e-12
            else:
                denom = (down - up) + 1e-12
            psi = _muscl((down - up) / denom)
        return m * (up + 0.5 * psi * (down - up)) - m * up

    # x-faces between (j, i) and (j, i+1)
    P, N = phi[:, :-1], phi[:, 1:]
    pos = mx >= 0
    up = torch.where(pos, P, N)
    down = torch.where(pos, N, P)
    W = F.pad(phi[:, :-2], (1, 0))
    has_W = torch.zeros_like(pos)
    has_W[:, 1:] = True
    E2 = F.pad(phi[:, 2:], (0, 1))
    has_E2 = torch.zeros_like(pos)
    has_E2[:, :-1] = True
    dc_x = face_dc(mx, up, down, torch.where(pos, has_W, has_E2),
                   torch.where(pos, W, E2))

    # y-faces between (j, i) and (j+1, i)
    P, N = phi[:-1, :], phi[1:, :]
    pos = my >= 0
    up = torch.where(pos, P, N)
    down = torch.where(pos, N, P)
    S = F.pad(phi[:-2, :], (0, 0, 1, 0))
    has_S = torch.zeros_like(pos)
    has_S[1:, :] = True
    N2 = F.pad(phi[2:, :], (0, 0, 0, 1))
    has_N2 = torch.zeros_like(pos)
    has_N2[:-1, :] = True
    dc_y = face_dc(my, up, down, torch.where(pos, has_S, has_N2),
                   torch.where(pos, S, N2))

    b = torch.zeros_like(phi)
    b[:, :-1] += -dc_x
    b[:, 1:] += dc_x
    b[:-1, :] += -dc_y
    b[1:, :] += dc_y
    return b


def face_average_x(c: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of a cell field to internal x-faces."""
    return 0.5 * (c[:, :-1] + c[:, 1:])


def face_average_y(c: torch.Tensor) -> torch.Tensor:
    return 0.5 * (c[:-1, :] + c[1:, :])


def divergence_from_fluxes(mx: torch.Tensor, my: torch.Tensor) -> torch.Tensor:
    """Per-cell divergence of the internal-face fluxes."""
    ny, nx = mx.shape[0], my.shape[1]
    div = torch.zeros((ny, nx), dtype=mx.dtype, device=mx.device)
    div[:, :-1] += mx
    div[:, 1:] += -mx
    div[:-1, :] += my
    div[1:, :] += -my
    return div


def apply_momentum_operator(coeffs: MomentumCoeffs, phi: torch.Tensor,
                            aP_override: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Matrix-free A @ phi of the 5-point momentum stencil; ``phi`` may
    carry leading batch dimensions."""
    aP = coeffs.aP if aP_override is None else aP_override
    out = aP * phi
    out = out + coeffs.aE * F.pad(phi[..., :, 1:], (0, 1))
    out = out + coeffs.aW * F.pad(phi[..., :, :-1], (1, 0))
    out = out + coeffs.aN * F.pad(phi[..., 1:, :], (0, 0, 0, 1))
    out = out + coeffs.aS * F.pad(phi[..., :-1, :], (0, 0, 1, 0))
    return out
