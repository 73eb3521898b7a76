"""The collocated FV-SIMPLE cavity, worked out from its configuration, and
the judgement of a converged state.

Cells are (ny, nx) arrays indexed [j, i] on a uniform grid of [0, Lx] x
[0, Ly]; x-faces (ny, nx-1) sit between (j, i) and (j, i+1), y-faces
(ny-1, nx) between (j, i) and (j+1, i); wall faces carry no flux. The
discrete equations of the configuration (upwind convection with a TVD
deferred correction, MUSCL limiter in the extrapolated-upstream form,
central diffusion with half-cell wall distances, the lid as a Dirichlet
wall value, cell gradients by central differences, one-sided at walls,
with cell 0 pinned as the pressure gauge) hold at a converged SIMPLE
state, where under-relaxation cancels:

    a_P u_P + sum a_nb u_nb = b_u + DC(u) - (dp/dx)_P V,   likewise v,

with a_nb and the convection of the state's face mass fluxes m; p enters
through its gradient. So do the compact Rhie-Chow face fluxes, which the
pressure step makes:

    m_e = rho dy (avg(u) - avg(D) ((p_E - p_P) / dx - avg(dp/dx))),
    D = V / a_P (the unrelaxed diagonal), likewise on y-faces.

The judgement is the size of their residuals at the state it is handed,
cell by cell and face by face: ``mom``, the largest momentum residual
over the largest diagonal term a_P u; ``flux``, the largest distance of
the state's face fluxes from those worked out again from (u, p) over the
largest face flux. The nodewise maxima show a fault in one cell as
clearly as one spread over the grid.

``mass``, the largest cell divergence of the state's fluxes over the
largest face flux, is worked out and read, but no limit holds it: the
solver stops on the change of its velocities, and a state it reports
converged at N=128 Re=100 in float32 keeps a continuity defect in the
lid-corner cells that a bfloat16 rounding of the state does not raise
(1.9e-2 against 1.8e-2), so no limit lies between the two.
"""

from __future__ import annotations

import numpy as np

from .validation import fv_evaluator

RHO = 1.0


def _pad(a, axis, before):
    """Shift by one cell along ``axis`` with a zero entering."""
    out = np.zeros_like(a)
    if axis == 1:
        if before:
            out[:, 1:] = a[:, :-1]
        else:
            out[:, :-1] = a[:, 1:]
    else:
        if before:
            out[1:, :] = a[:-1, :]
        else:
            out[:-1, :] = a[1:, :]
    return out


def gradient(phi, dx, dy):
    """Cell-centred gradient: the mean of the one-sided differences to the
    neighbours present; cell 0 takes part in no difference and has none."""
    ny, nx = phi.shape
    has_e = np.ones((ny, nx)); has_e[:, -1] = 0
    has_w = np.ones((ny, nx)); has_w[:, 0] = 0
    has_n = np.ones((ny, nx)); has_n[-1, :] = 0
    has_s = np.ones((ny, nx)); has_s[0, :] = 0
    has_w[0, 1] = 0
    has_s[1, 0] = 0
    e, w = _pad(phi, 1, False), _pad(phi, 1, True)
    n, s = _pad(phi, 0, False), _pad(phi, 0, True)
    gx = (has_e * (e - phi) + has_w * (phi - w)) / dx / np.maximum(
        has_e + has_w, 1)
    gy = (has_n * (n - phi) + has_s * (phi - s)) / dy / np.maximum(
        has_n + has_s, 1)
    gx[0, 0] = gy[0, 0] = 0.0
    return gx, gy


def coefficients(mx, my, mu, dx, dy, wall_n):
    """(aP, aE, aW, aN, aS, b) of upwind convection and central diffusion,
    the north wall at ``wall_n`` (the others at rest)."""
    ny, nx = mx.shape[0], my.shape[1]
    cx, cy = mu * dy / dx, mu * dx / dy
    mxp, mxn = np.maximum(mx, 0), np.maximum(-mx, 0)
    myp, myn = np.maximum(my, 0), np.maximum(-my, 0)
    aE = np.zeros((ny, nx)); aE[:, :-1] = -(mxn + cx)
    aW = np.zeros((ny, nx)); aW[:, 1:] = -(mxp + cx)
    aN = np.zeros((ny, nx)); aN[:-1, :] = -(myn + cy)
    aS = np.zeros((ny, nx)); aS[1:, :] = -(myp + cy)
    aP = np.zeros((ny, nx))
    aP[:, :-1] += mxp + cx
    aP[:, 1:] += mxn + cx
    aP[:-1, :] += myp + cy
    aP[1:, :] += myn + cy
    aP[:, 0] += 2 * cx
    aP[:, -1] += 2 * cx
    aP[0, :] += 2 * cy
    aP[-1, :] += 2 * cy
    b = np.zeros((ny, nx))
    b[-1, :] += 2 * cy * wall_n
    return aP, aE, aW, aN, aS, b


def deferred_correction(phi, mx, my):
    """The TVD source: on each face m (phi_face - phi_upwind), phi_face =
    up + psi (down - up) / 2 with the MUSCL psi of r = d / (d + 1e-12),
    taken out of the owner and into the neighbour."""
    def psi(d):
        r = d / (d + 1e-12)
        lim = np.maximum(np.minimum(np.minimum(2 * r, 2.0), 0.5 * (1 + r)),
                         0.0)
        return np.where(r > 0, lim, 0.0)

    b = np.zeros_like(phi)
    P, N = phi[:, :-1], phi[:, 1:]
    d = np.where(mx >= 0, N - P, P - N)
    dc = mx * 0.5 * psi(d) * d
    b[:, :-1] -= dc
    b[:, 1:] += dc
    P, N = phi[:-1, :], phi[1:, :]
    d = np.where(my >= 0, N - P, P - N)
    dc = my * 0.5 * psi(d) * d
    b[:-1, :] -= dc
    b[1:, :] += dc
    return b


def apply(aP, aE, aW, aN, aS, phi):
    return (aP * phi + aE * _pad(phi, 1, False) + aW * _pad(phi, 1, True)
            + aN * _pad(phi, 0, False) + aS * _pad(phi, 0, True))


def rhie_chow(u, v, p, aP, dx, dy):
    """The compact Rhie-Chow face fluxes (mx, my) of (u, v, p), with
    D = V / a_P."""
    gx, gy = gradient(p, dx, dy)
    d = dx * dy / (aP + 1e-14)
    ax = lambda c: 0.5 * (c[:, :-1] + c[:, 1:])
    ay = lambda c: 0.5 * (c[:-1, :] + c[1:, :])
    mx = RHO * dy * (ax(u) - ax(d) * ((p[:, 1:] - p[:, :-1]) / dx - ax(gx)))
    my = RHO * dx * (ay(v) - ay(d) * ((p[1:, :] - p[:-1, :]) / dy - ay(gy)))
    return mx, my


def divergence(mx, my):
    """Each cell's net outflow through its internal faces."""
    ny, nx = mx.shape[0], my.shape[1]
    d = np.zeros((ny, nx))
    d[:, :-1] += mx
    d[:, 1:] -= mx
    d[:-1, :] += my
    d[1:, :] -= my
    return d


def _ratio(num: float, den: float) -> float:
    """num / den; inf where the size it is measured against is nought."""
    return float(num / den) if den > 0 else float("inf")


def judge(params: dict, u, v, p, mx, my) -> dict:
    """``mom``: the largest momentum residual over the largest diagonal
    term a_P u; ``flux``: the largest distance of the face fluxes from the
    Rhie-Chow fluxes of (u, p) over the largest face flux; ``mass``: the
    largest cell divergence over the largest face flux."""
    ny, nx = np.shape(u)
    Lx, Ly = float(params.get("Lx", 1.0)), float(params.get("Ly", 1.0))
    speed = float(params.get("lid_velocity", 1.0))
    if str(params.get("corner_treatment", "none")) != "none":
        raise ValueError("the reference covers the constant lid")
    if str(params.get("convection_scheme")) != "TVD" or \
            str(params.get("limiter")) != "MUSCL" or \
            str(params.get("rhie_chow")) != "compact":
        raise ValueError("the reference covers TVD/MUSCL, compact Rhie-Chow")
    u, v, p, mx, my = (np.asarray(a, np.float64) for a in (u, v, p, mx, my))
    if not all(np.isfinite(a).all() for a in (u, v, p, mx, my)):
        return {"mom": float("inf"), "flux": float("inf"),
                "mass": float("inf")}
    dx, dy = Lx / nx, Ly / ny
    vol = dx * dy
    mu = RHO * speed * Lx / float(params["Re"])
    aP, aE, aW, aN, aS, b_u = coefficients(mx, my, mu, dx, dy,
                                           np.full(nx, speed))
    b_v = np.zeros_like(b_u)
    gx, gy = gradient(p, dx, dy)
    r_u = apply(aP, aE, aW, aN, aS, u) - (
        b_u + deferred_correction(u, mx, my) - gx * vol)
    r_v = apply(aP, aE, aW, aN, aS, v) - (
        b_v + deferred_correction(v, mx, my) - gy * vol)
    mom = _ratio(max(np.abs(r_u).max(), np.abs(r_v).max()),
                 max(np.abs(aP * u).max(), np.abs(aP * v).max()))
    rx, ry = rhie_chow(u, v, p, aP, dx, dy)
    big = max(np.abs(mx).max(), np.abs(my).max())
    flux = _ratio(max(np.abs(rx - mx).max(), np.abs(ry - my).max()), big)
    mass = _ratio(np.abs(divergence(mx, my)).max(), big)
    return {"mom": mom, "flux": flux, "mass": mass}


def lane_numbers(params: dict, n: int, state) -> dict:
    """The judged numbers of a lane's final state (u, v, p, mx, my)."""
    return judge(params, *state[:5])


def lane_evaluator(params: dict, n: int, state):
    """(u, v) at points of the lane's final state, for the validation."""
    return fv_evaluator(params, state[0], state[1])
