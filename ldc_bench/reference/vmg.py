"""A float64 FAS V-cycle of the PN-PN-2 Chebyshev cavity, and the judgement
of a steady state by the measure a V-cycle solver's stopping rule applies.

The full approximation scheme (FAS) of Zhang & Xi (2010), as the
program's module docstring sets it out in seven steps, for the
artificial-compressibility system of ``spectral.py``, on a ladder of
orders fine to coarse. A cycle on level h with coarse level H:

1. NU1 pre-smoothing steps of the four-stage march with the level's
   forcing tau_h (none on the finest level) added to every stage residual;
2. the defect d_h = R_h(u_h) + tau_h, its velocity parts set to zero on
   the wall nodes;
3. the coarse state u_H0 by injection on the nested Chebyshev-Gauss-Lobatto
   nodes (velocity and pressure), the coarse wall values imposed;
4. tau_H = I(d_h) - R_H(u_H0), with I the Chebyshev modal truncation of
   the velocity defects (the degree-N_H part of their fine interpolant's
   Chebyshev series, at the coarse nodes) and injection of the pressure
   defect;
5. the same cycle on level H with tau_H, or NU_COARSE forced steps on the
   coarsest level;
6. u_h += P(u_H - u_H0), P the polynomial interpolation from the coarse
   nodes to the fine ones (on the inner nodes for the pressure), the wall
   values imposed again;
7. NU2 post-smoothing steps.

The ladder is the floor-guarded halving ladder: N, N/2, ... for at most
``n_levels`` orders while the next order stays at or above the coarsest
order the scheme resolves at this Re, max(12, ceil(2.4 sqrt(Re)),
ceil(Re pi / 220)).

Departures from the published scheme, each the port's by design:

- the pressure lives on the inner nodes, which form no Chebyshev grid of
  their own, so its defect is restricted by injection (the interpolation
  of its polynomial at the nested coarse inner nodes), not by modal
  truncation;
- a correction with a non-finite entry is dropped (the cycle goes on with
  the smoothed state), so that a coarse level that blows up in the
  impulsive-start transient does not end the solve;
- the smoother is the cavity's own four-stage pseudo-time march with its
  CFL step (``spectral.py``), with the step counts above, as the program
  smooths; no smoother of its own is tuned for the cycle.

The reference covers the Chebyshev basis, the smoothed lid and the plain
lid (``corner_treatment`` "none": the lid speed at every lid node, the
top corners included), and nested ladders only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import spectral as S

NU1, NU2, NU_COARSE = 2, 2, 30
# the coarsest order the FAS scheme resolves: c sqrt(Re), and the cell
# Peclet bound Re pi / (2 N) <= PE_MAX
FLOOR_COEFF, PE_MAX, MIN_ORDER = 2.4, 110.0, 12
F64 = torch.float64


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64)


def ladder(params: dict, n: int) -> list:
    """The floor-guarded halving ladder, fine to coarse."""
    Re = float(params["Re"])
    floor = max(MIN_ORDER, math.ceil(FLOOR_COEFF * math.sqrt(Re)),
                math.ceil(Re * math.pi / (2.0 * PE_MAX)))
    orders = [int(n)]
    while len(orders) < int(params.get("n_levels", 1)) and \
            orders[-1] // 2 >= floor:
        orders.append(orders[-1] // 2)
    return orders


def _lid(x, params: dict, length: float):
    kind = str(params.get("corner_treatment", "smoothing"))
    speed = float(params.get("lid_velocity", 1.0))
    if kind == "smoothing":
        return S.lid(x, float(params["corner_smoothing"]), speed, length)
    if kind == "none":
        return np.full_like(x, speed)
    raise ValueError(f"the V-cycle reference covers the smoothed and the "
                     f"plain lid, not {kind!r}")


def _chebyshev(xi: np.ndarray, degree: int) -> torch.Tensor:
    """T_0 .. T_degree at the points ``xi`` of [-1, 1], by the three-term
    recurrence: (len(xi), degree + 1)."""
    xi = _t(xi)
    cols = [torch.ones_like(xi), xi]
    for _ in range(1, degree):
        cols.append(2.0 * xi * cols[-1] - cols[-2])
    return torch.stack(cols[:degree + 1], dim=1)


class Level:
    """The operators of one order and the march on it."""

    def __init__(self, n: int, params: dict):
        if str(params.get("basis_type", "chebyshev")) != "chebyshev":
            raise ValueError("the V-cycle reference covers the Chebyshev "
                             "basis")
        Lx, Ly = float(params.get("Lx", 1.0)), float(params.get("Ly", 1.0))
        self.n = n
        self.x, self.y = S.cgl_nodes(n, Lx), S.cgl_nodes(n, Ly)
        self.Lx, self.Ly = Lx, Ly
        self.Dx = _t(S.diff_matrix(self.x))
        self.Dy = _t(S.diff_matrix(self.y))
        self.Ix = _t(S.interp_matrix(self.x[1:-1], self.x))
        self.Iy = _t(S.interp_matrix(self.y[1:-1], self.y))
        self.nu = 1.0 / float(params["Re"])
        self.beta2 = float(params["beta_squared"])
        self.cfl = float(params["CFL"])
        self.speed = float(params.get("lid_velocity", 1.0))
        self.h_x = float(np.min(np.diff(self.x)))
        self.h_y = float(np.min(np.diff(self.y)))
        nf = n + 1
        self.inner = torch.zeros((nf, nf), dtype=torch.bool)
        self.inner[1:-1, 1:-1] = True
        self.bc_u = torch.zeros((nf, nf), dtype=F64)
        self.bc_u[:, -1] = _t(_lid(self.x, params, Lx))

    def walls(self, u, v):
        return (torch.where(self.inner, u, self.bc_u),
                torch.where(self.inner, v, torch.zeros_like(v)))

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

    def defect(self, state, tau):
        R = self.rhs(*state)
        return R if tau is None else tuple(r + t for r, t in zip(R, tau))

    def dt(self, u, v) -> float:
        um = max(float(u.abs().max()), self.speed)
        vm = max(float(v.abs().max()), 1e-10)
        lam_x = (um + math.sqrt(um * um + self.beta2)) / self.h_x \
            + self.nu / self.h_x ** 2
        lam_y = (vm + math.sqrt(vm * vm + self.beta2)) / self.h_y \
            + self.nu / self.h_y ** 2
        return self.cfl / (lam_x + lam_y)

    def smooth(self, state, tau, steps: int):
        """``steps`` steps of the march, ``tau`` added to every stage."""
        for _ in range(steps):
            u, v, p = state
            dt = self.dt(u, v)
            ui, vi, pi = state
            for a in S.ALPHAS:
                R_u, R_v, R_p = self.defect((ui, vi, pi), tau)
                ui, vi = self.walls(u + a * dt * R_u, v + a * dt * R_v)
                pi = p + a * dt * R_p
            state = (ui, vi, pi)
        return state


class Pair:
    """The transfers between a level and the next coarser one."""

    def __init__(self, fine: Level, coarse: Level):
        n, nc = fine.n, coarse.n
        if n % nc:
            raise ValueError(f"the V-cycle reference covers nested ladders, "
                             f"not {n} over {nc}")
        r = n // nc
        self.full = torch.arange(0, n + 1, r)         # coarse nodes in fine
        self.inner = torch.arange(r, n, r) - 1        # the same, inner grid
        # modal truncation: fine values -> Chebyshev coefficients -> the
        # first nc + 1 of them at the coarse nodes
        self.trunc_x, self.trunc_y = (
            _chebyshev(2.0 * xc / L - 1.0, nc)
            @ torch.linalg.inv(_chebyshev(2.0 * xf / L - 1.0, n))[:nc + 1]
            for xf, xc, L in ((fine.x, coarse.x, fine.Lx),
                              (fine.y, coarse.y, fine.Ly)))
        self.pro_x = _t(S.interp_matrix(coarse.x, fine.x))
        self.pro_y = _t(S.interp_matrix(coarse.y, fine.y))
        self.pro_xi = _t(S.interp_matrix(coarse.x[1:-1], fine.x[1:-1]))
        self.pro_yi = _t(S.interp_matrix(coarse.y[1:-1], fine.y[1:-1]))

    def inject(self, a, inner=False):
        idx = self.inner if inner else self.full
        return a[idx][:, idx]

    def truncate(self, a):
        return self.trunc_x @ a @ self.trunc_y.T

    def prolong(self, a, inner=False):
        if inner:
            return self.pro_xi @ a @ self.pro_yi.T
        return self.pro_x @ a @ self.pro_y.T


def hierarchy(params: dict, n: int, orders=None):
    """(levels, pairs) of the ladder (``orders`` forces one, fine first)."""
    orders = ladder(params, n) if orders is None else [int(o) for o in
                                                       orders]
    if orders[0] != int(n):
        raise ValueError(f"a ladder starts at the fine order {n}: {orders}")
    levels = [Level(o, params) for o in orders]
    return levels, [Pair(a, b) for a, b in zip(levels, levels[1:])]


def cycle(levels, pairs, state, tau=None, idx=0):
    """One V-cycle from level ``idx`` down: the new (u, v, p)."""
    lv = levels[idx]
    if idx == len(levels) - 1:
        return lv.smooth(state, tau, NU_COARSE)
    co, tr = levels[idx + 1], pairs[idx]
    state = lv.smooth(state, tau, NU1)
    d_u, d_v, d_p = lv.defect(state, tau)
    zero = torch.zeros_like(d_u)
    d_u, d_v = (torch.where(lv.inner, d, zero) for d in (d_u, d_v))
    u0, v0 = co.walls(tr.inject(state[0]), tr.inject(state[1]))
    coarse0 = (u0, v0, tr.inject(state[2], inner=True))
    R_u0, R_v0, R_p0 = co.rhs(*coarse0)
    tau_H = (tr.truncate(d_u) - R_u0, tr.truncate(d_v) - R_v0,
             tr.inject(d_p, inner=True) - R_p0)
    coarse = cycle(levels, pairs, coarse0, tau_H, idx + 1)
    e_u, e_v, e_p = (tr.prolong(c - c0, inner=k == 2)
                     for k, (c, c0) in enumerate(zip(coarse, coarse0)))
    if all(bool(torch.isfinite(e).all()) for e in (e_u, e_v, e_p)):
        u, v = lv.walls(state[0] + e_u, state[1] + e_v)
        state = (u, v, state[2] + e_p)
    return lv.smooth(state, tau, NU2)


def v_cycle(params: dict, n: int, state, orders=None):
    """One V-cycle of the ladder from the state (u, v, p): the new state,
    as float64 tensors."""
    levels, pairs = hierarchy(params, n, orders)
    return cycle(levels, pairs, tuple(_t(a) for a in state))


def _rel(new, old) -> float:
    """The largest change over the largest value."""
    return float((new - old).abs().max() / (old.abs().max() + 1e-300))


def lane_numbers(params: dict, n: int, state) -> dict:
    """``spectral.py``'s numbers of a lane's final state (u, v, p), and
    ``uv_cycle`` and ``p_cycle``: the largest change one reference V-cycle
    makes to u or v, over the largest speed, and to p, over the largest
    pressure."""
    nums = S.lane_numbers(params, n, state)
    u, v, p = (_t(a) for a in state[:3])
    if not all(bool(torch.isfinite(a).all()) for a in (u, v, p)):
        return dict(nums, uv_cycle=float("inf"), p_cycle=float("inf"))
    un, vn, pn = v_cycle(params, n, (u, v, p))
    speed = max(float(u.abs().max()), float(v.abs().max()))
    uv = max(float((un - u).abs().max()), float((vn - v).abs().max()))
    return dict(nums, uv_cycle=uv / speed, p_cycle=_rel(pn, p))


lane_evaluator = S.lane_evaluator
