"""The PN-PN-2 Chebyshev collocation cavity, worked out from its
configuration, and the judgement of a marched steady state.

Velocities live on the (N+1)^2 Chebyshev-Gauss-Lobatto grid of [0, Lx] x
[0, Ly] (row index x, column index y, the lid at y = Ly), pressure on the
(N-1)^2 inner nodes. The semi-discrete artificial-compressibility system
is

    du/dt = -(u.grad)u - grad p + (1/Re) lap u,   dp/dt = -beta^2 div u,

with grad p the derivative of the pressure's degree N-2 interpolant on
the full grid, and the divergence taken on the inner nodes. The
pseudo-time march is the four-stage scheme u_k = u_0 + a_k dt R(u_{k-1}),
a = (1/4, 1/3, 1/2, 1), with the wall values re-imposed after each stage
and the CFL step of the configuration. A steady state of the march is a
zero of R; the judgement is the relative change that one step of this
march makes to the state it is handed, the measure the solver's own
stopping rule (``tolerance``) applies to u and v.

Differentiation and interpolation use the barycentric formulas of
Berrut & Trefethen (SIAM Review 46, 2004).
"""

from __future__ import annotations

import numpy as np

ALPHAS = (0.25, 1.0 / 3.0, 0.5, 1.0)


def cgl_nodes(n: int, length: float) -> np.ndarray:
    """The n + 1 Chebyshev-Gauss-Lobatto nodes of [0, length], ascending."""
    return 0.5 * length * (1.0 - np.cos(np.pi * np.arange(n + 1) / n))


def bary_weights(x: np.ndarray) -> np.ndarray:
    """Barycentric weights of arbitrary distinct nodes, scaled to max 1."""
    d = x[:, None] - x[None, :]
    np.fill_diagonal(d, 1.0)
    w = 1.0 / np.prod(d * (4.0 / (x.max() - x.min())), axis=1)
    return w / np.abs(w).max()


def diff_matrix(x: np.ndarray) -> np.ndarray:
    """First derivative at the nodes of the nodes' interpolant."""
    w = bary_weights(x)
    d = x[:, None] - x[None, :]
    np.fill_diagonal(d, 1.0)
    D = (w[None, :] / w[:, None]) / d
    np.fill_diagonal(D, 0.0)
    np.fill_diagonal(D, -D.sum(axis=1))
    return D


def interp_matrix(x_from: np.ndarray, x_to: np.ndarray) -> np.ndarray:
    """Values at ``x_to`` of the interpolant through ``x_from``."""
    w = bary_weights(x_from)
    d = x_to[:, None] - x_from[None, :]
    hit = np.isclose(d, 0.0, rtol=0.0, atol=1e-14)
    d[hit] = 1.0
    M = w[None, :] / d
    M /= M.sum(axis=1, keepdims=True)
    rows = hit.any(axis=1)
    M[rows] = hit[rows].astype(float)
    return M


def lid(x: np.ndarray, width: float, speed: float, length: float):
    """The smoothed lid: a cosine ramp over ``width * length`` at each
    corner, ``speed`` between."""
    w = width * length
    u = np.full_like(x, speed)
    if w > 0:
        left, right = x < w, x > length - w
        u[left] = 0.5 * (1.0 - np.cos(np.pi * x[left] / w)) * speed
        u[right] = 0.5 * (1.0 - np.cos(np.pi * (length - x[right]) / w)) \
            * speed
    return u


class Cavity:
    """The collocation operators of one order, from the parameters."""

    def __init__(self, n: int, p: dict):
        if str(p.get("basis_type", "chebyshev")) != "chebyshev":
            raise ValueError("the reference covers the Chebyshev basis")
        if str(p.get("corner_treatment", "smoothing")) != "smoothing":
            raise ValueError("the reference covers the smoothed lid")
        Lx, Ly = float(p.get("Lx", 1.0)), float(p.get("Ly", 1.0))
        self.x, self.y = cgl_nodes(n, Lx), cgl_nodes(n, Ly)
        self.Dx, self.Dy = diff_matrix(self.x), diff_matrix(self.y)
        self.Ix = interp_matrix(self.x[1:-1], self.x)
        self.Iy = interp_matrix(self.y[1:-1], self.y)
        self.nu = 1.0 / float(p["Re"])
        self.beta2 = float(p["beta_squared"])
        self.cfl = float(p["CFL"])
        self.speed = float(p.get("lid_velocity", 1.0))
        self.h_x = float(np.min(np.diff(self.x)))
        self.h_y = float(np.min(np.diff(self.y)))
        nf = n + 1
        self.wall = np.ones((nf, nf), bool)
        self.wall[1:-1, 1:-1] = False
        self.bc_u = np.zeros((nf, nf))
        self.bc_u[:, -1] = lid(self.x, float(p["corner_smoothing"]),
                               self.speed, Lx)

    def rhs(self, u, v, p):
        """(R_u, R_v, R_p) of the semi-discrete system."""
        Dx, Dy = self.Dx, self.Dy
        ux, uy = Dx @ u, u @ Dy.T
        vx, vy = Dx @ v, v @ Dy.T
        lap_u = Dx @ ux + uy @ Dy.T
        lap_v = Dx @ vx + vy @ Dy.T
        p_full = self.Ix @ p @ self.Iy.T
        px, py = Dx @ p_full, p_full @ Dy.T
        R_u = -(u * ux + v * uy) - px + self.nu * lap_u
        R_v = -(u * vx + v * vy) - py + self.nu * lap_v
        R_p = -self.beta2 * (ux + vy)[1:-1, 1:-1]
        return R_u, R_v, R_p

    def dt(self, u, v) -> float:
        """The CFL pseudo-time step: acoustic and viscous rates of the
        largest speeds on the finest spacing."""
        um = max(float(np.abs(u).max()), self.speed)
        vm = max(float(np.abs(v).max()), 1e-10)
        lam_x = (um + np.sqrt(um * um + self.beta2)) / self.h_x \
            + self.nu / self.h_x ** 2
        lam_y = (vm + np.sqrt(vm * vm + self.beta2)) / self.h_y \
            + self.nu / self.h_y ** 2
        return self.cfl / (lam_x + lam_y)

    def step(self, u, v, p):
        """One step of the four-stage march, walls re-imposed."""
        dt = self.dt(u, v)
        ui, vi, pi = u, v, p
        for a in ALPHAS:
            R_u, R_v, R_p = self.rhs(ui, vi, pi)
            ui = np.where(self.wall, self.bc_u, u + a * dt * R_u)
            vi = np.where(self.wall, 0.0, v + a * dt * R_v)
            pi = p + a * dt * R_p
        return ui, vi, pi


def _rel(new, old) -> float:
    """The largest change over the largest value."""
    return float(np.abs(new - old).max() / (np.abs(old).max() + 1e-300))


def judge(params: dict, n: int, u, v, p) -> dict:
    """The numbers that judge a final state (u, v on the full grid, p on
    the inner grid, any float dtype): ``uv_step``, the largest change of u
    or v over one reference step relative to the largest speed, ``p_step``
    that of p relative to the largest pressure, and ``wall``, the largest
    distance of u, v from the wall values."""
    cav = Cavity(n, params)
    u, v, p = (np.asarray(a, np.float64) for a in (u, v, p))
    if not all(np.isfinite(a).all() for a in (u, v, p)):
        return {"uv_step": float("inf"), "p_step": float("inf"),
                "wall": float("inf")}
    un, vn, pn = cav.step(u, v, p)
    wall = max(float(np.abs(u - cav.bc_u)[cav.wall].max()),
               float(np.abs(v)[cav.wall].max()))
    speed = max(np.abs(u).max(), np.abs(v).max())
    uv = max(np.abs(un - u).max(), np.abs(vn - v).max()) / speed
    return {"uv_step": float(uv), "p_step": _rel(pn, p), "wall": wall}


def evaluate(n: int, params: dict, field, xs, ys):
    """The field's interpolant at the points (xs[k], ys[k]) of a tensor
    grid: xs and ys are that grid's 1-D coordinates."""
    Lx, Ly = float(params.get("Lx", 1.0)), float(params.get("Ly", 1.0))
    Mx = interp_matrix(cgl_nodes(n, Lx), np.asarray(xs, float))
    My = interp_matrix(cgl_nodes(n, Ly), np.asarray(ys, float))
    return Mx @ np.asarray(field, np.float64) @ My.T


def lane_numbers(params: dict, n: int, state) -> dict:
    """The judged numbers of a lane's final state (u, v, p)."""
    return judge(params, n, *state[:3])


def lane_evaluator(params: dict, n: int, state):
    """(u, v) at points of the lane's final state, for the validation."""
    from .validation import spectral_evaluator  # validation imports this

    return spectral_evaluator(n, params, state[0], state[1])
