"""Botella & Peyret corner-singularity subtraction for the sharp-lid cavity.

The port's own copy of ``anap3_tpu/ops/singular.py`` (float64 numpy).

The sharp lid (u = U on the whole top wall, no-slip side walls) makes the
velocity discontinuous at the two top corners, so every spectral treatment in
the reference regularizes the lid instead (smoothing / Saad profiles,
src/solvers/spectral/operators/corner.py) — which solves a *different*
problem: the measured v-centerline gap vs Ghia's sharp-lid tables at
Re >= 7500 (0.10-0.24) is structural to the smoothed lid, and the Botella &
Peyret Re=1000 vortex benchmarks (data/validation/botella/*.csv) are sharp-lid
values a smoothed solver can never match to their accuracy.

This module implements the subtraction method of Botella & Peyret (1998): the
leading corner singularity is the Stokes "scraper" flow of Taylor (1962). For
a 90-degree corner between a moving lid and a fixed wall, the local Stokes
streamfunction is

    psi = r * f(theta),
    f(theta) = A sin(theta) + C theta sin(theta) + D theta cos(theta)

(r, theta) polar about the corner with theta = 0 on the lid ray, and the
coefficients fixed by no-slip on both rays: for lid speed u_r(theta=0) = -U
(a lid moving *toward* the corner),

    A = -pi^2 U / (pi^2 - 4),  C = 2 pi U / (pi^2 - 4),  D = 4 U / (pi^2 - 4).

Both top corners of the cavity reduce to this one f: seen from the top-right
corner B = (Lx, Ly) the lid moves toward the corner, and the top-left corner
A = (0, Ly) mirror-maps onto the same profile with v negated (derivations in
the per-corner term functions below; every sign is FD-verified in
tests/test_singular.py).

The solver decomposes u = u_tilde + u_s with u_s = (corner A) + (corner B).
Because u_s is an exact Stokes solution, nu*lap(u_s) - grad(p_s) == 0 drops
out of the momentum residual and the evolved u_tilde sees only

  - convection built from the TOTAL velocity (analytic u_s derivatives —
    the singular part is never differentiated spectrally),
  - boundary values  u_tilde = u_BC_sharp - u_s  which are CONTINUOUS at the
    corners (the subtraction absorbs the discontinuity),

so u_tilde is smooth enough for spectral accuracy on the sharp-lid problem.
div(u_s) = 0 analytically, so the continuity residual is unchanged in form.

Everything here is host-side float64 setup math; the sampled fields become
per-run constants of the jitted stepper (models/spectral_sg.py).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "corner_coefficients",
    "singular_fields_on_grid",
    "eval_singular_uv",
    "eval_singular_psi",
    "singular_min_n",
]


def singular_min_n(Re: float) -> int:
    """Minimum stable polynomial order for a COLD-START singular-mode solve.

    The subtraction adds a reaction-like convection term (u_tilde . grad)u_s
    with |grad u_s| ~ 1/r near the corners and O(1) tangential boundary data
    on every wall; under-resolved cold starts blow up in the pseudo-time
    transient (independent of dt — reproduced at CFL 0.1, f32 AND f64).
    With the REST initial state (initial_state: u_tilde = -u_s interior, so
    the total flow starts at rest) the measured stable/diverged brackets
    (this box, 40-60k cold steps) are

        Re=400: 16/12,  Re=1000: 24/16,  Re=3200: 40/-

    i.e. ~0.7 sqrt(Re); the 0.75 coefficient covers the untested marginals
    while keeping every measured stable point admissible.
    (The earlier u_tilde = 0 start — total flow = the O(1) corner field —
    needed 20/32/96 at Re=400/1000/3200: most of the danger was the
    non-physical initial transient.) Warm starts (Re-continuation,
    multigrid prolongation) can run below this floor; the floor gates the
    COARSEST (cold) level of FSG hierarchies and warns on cold single-grid
    solves.
    """
    return int(np.ceil(0.75 * np.sqrt(float(Re))))


def corner_coefficients(lid_velocity: float = 1.0):
    """(A, C, D) of f(theta) for lid speed ``lid_velocity`` toward the corner."""
    U = float(lid_velocity)
    denom = np.pi**2 - 4.0
    return (-np.pi**2 * U / denom, 2.0 * np.pi * U / denom, 4.0 * U / denom)


def _angular(theta, U):
    """f, f', G = f + f'', G' at ``theta`` (vectorized, float64)."""
    A, C, D = corner_coefficients(U)
    s, c = np.sin(theta), np.cos(theta)
    f = A * s + C * theta * s + D * theta * c
    fp = A * c + C * (s + theta * c) + D * (c - theta * s)
    G = 2.0 * C * c - 2.0 * D * s
    Gp = -2.0 * C * s - 2.0 * D * c
    return f, fp, G, Gp


def _corner_terms(xi, eta, U, v_sign, dth_dx_sign, dwx_sign):
    """All singular fields of ONE corner, in GLOBAL (x, y) components.

    ``xi``/``eta`` are the local wall-aligned coordinates (lid ray, wall ray,
    both >= 0 inside the cavity). The two corners differ only in three signs
    (exactly as ``_both_corners`` passes them; FD-pinned by the tests):

    - corner B (lid toward corner): xi = Lx-x, eta = Ly-y; global u = -u_xi,
      v = -u_eta; dtheta/dx = +eta/r^2 => ``v_sign=+1, dth_dx_sign=+1,
      dwx_sign=-1``;
    - corner A (lid away from corner): xi = x, eta = Ly-y; global u = +u_xi,
      v = -u_eta, worked through the auxiliary streamfunction chi = -psi of
      the left-handed frame => ``v_sign=-1, dth_dx_sign=-1, dwx_sign=+1``.

    Singular quantities (all derivative fields, omega, grad omega, p/nu) are
    zeroed AT the corner node itself (r == 0): those samples only ever feed
    boundary-node diagnostics whose values the BC enforcement overwrites.
    """
    xi = np.asarray(xi, float)
    eta = np.asarray(eta, float)
    r2 = xi * xi + eta * eta
    at_corner = r2 == 0.0
    r2s = np.where(at_corner, 1.0, r2)
    r = np.sqrt(r2s)
    theta = np.arctan2(eta, xi)  # atan2(0,0)=0: corner node takes the lid limit
    f, fp, G, Gp = _angular(theta, U)
    s, c = np.sin(theta), np.cos(theta)

    u = -(fp * c + f * s)                     # same global form at both corners
    v = v_sign * (-(fp * s - f * c))
    # velocity depends on theta only: d(.)/d{x,y} = (.)' * dtheta/d{x,y}
    dth_dx = dth_dx_sign * eta / r2s
    dth_dy = -xi / r2s                        # same at both corners
    Pp = -G * c                               # u' (theta)
    Qp = v_sign * (-G * s)                    # v' (theta)
    z = lambda a: np.where(at_corner, 0.0, a)
    out = {
        "u": u,
        "v": v,
        "dudx": z(Pp * dth_dx),
        "dudy": z(Pp * dth_dy),
        "dvdx": z(Qp * dth_dx),
        "dvdy": z(Qp * dth_dy),
        "psi": np.where(at_corner, 0.0, r * f),
        "omega": z(-G / r),
        # grad(omega) in local coords: d(-G/r)/dxi = (G' eta + G xi)/r^3 ...
        "dwx": z(dwx_sign * (Gp * eta + G * xi) / (r2s * r)),
        "dwy": z((Gp * xi - G * eta) / (r2s * r)),
        # Stokes pressure p = -nu G'(theta)/r (+const); corner A's chi = -psi
        # frame flips the sign (FD-verified against nu*lap(u) = grad(p))
        "p_over_nu": z(-v_sign * Gp / r),
    }
    return out


def _both_corners(X, Y, lid_velocity, Lx, Ly):
    A = _corner_terms(X, Ly - Y, lid_velocity,
                      v_sign=-1.0, dth_dx_sign=-1.0, dwx_sign=+1.0)
    B = _corner_terms(Lx - X, Ly - Y, lid_velocity,
                      v_sign=+1.0, dth_dx_sign=+1.0, dwx_sign=-1.0)
    # corner A's pressure has the opposite sign structure: p_A = +nu G'/r
    return {k: A[k] + B[k] for k in A}


def singular_fields_on_grid(x_nodes: np.ndarray, y_nodes: np.ndarray,
                            lid_velocity: float = 1.0,
                            Lx: float = 1.0, Ly: float = 1.0) -> dict:
    """Sampled singular fields on the tensor grid, (nx, ny) arrays [i, j] =
    (x_i, y_j) matching the solver's layout (spectral_sg.py grids)."""
    X, Y = np.meshgrid(np.asarray(x_nodes, float), np.asarray(y_nodes, float),
                       indexing="ij")
    return _both_corners(X, Y, lid_velocity, Lx, Ly)


def eval_singular_uv(x, y, lid_velocity: float = 1.0,
                     Lx: float = 1.0, Ly: float = 1.0):
    """(u_s, v_s) at scattered points — exact analytic evaluation, used by the
    validation/centerline paths on top of the spectral u_tilde interpolant."""
    fields = _both_corners(np.asarray(x, float), np.asarray(y, float),
                           lid_velocity, Lx, Ly)
    return fields["u"], fields["v"]


def eval_singular_psi(x, y, lid_velocity: float = 1.0,
                      Lx: float = 1.0, Ly: float = 1.0):
    """psi_s at scattered points (vanishes on the lid and side walls)."""
    fields = _both_corners(np.asarray(x, float), np.asarray(y, float),
                           lid_velocity, Lx, Ly)
    return fields["psi"]
