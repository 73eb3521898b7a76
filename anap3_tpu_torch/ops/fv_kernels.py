"""Wrappers of the hand-written FV-SIMPLE CUDA kernels, each beside its plain
PyTorch version.

``csrc/`` holds two FV kernels (fv_bicgstab.cu, fv_pressure.cu; see the
note at the top of each, and fv_phases.cuh for the device functions they
share) and the C host entries (fv_host.cu) that this module calls through
``ctypes``:

- ``make_fv_step(params, ops, bicgstab_iters)`` has the contract of
  ``anap3_tpu/ops/pallas_fv.py:make_pallas_fv_step``: ``step(state) ->
  (state, metrics)`` with the six metric keys.
- ``make_fv_chunk_runner(params, ops, chunk, tolerance, warmup,
  bicgstab_iters)`` has the contract of ``make_pallas_fv_chunk_runner``:
  ``chunk_fn(state, start_iter, ref_norm) -> (state, done, conv_iter,
  converged, rows[chunk, 7], ref_norm)``, rows in runner.METRIC_KEYS order
  and in the working dtype.

Both run the arithmetic of the Pallas body ``_make_iterate`` (the plain
version ``fv_iterate_plain`` is that body in torch): a FIXED number K of
warm-started Jacobi-BiCGSTAB iterations with the breakdown guard
``active = ||r||^2 > 1e-16 (||rhs||^2 + 1e-30)`` (the guard constants are
the Pallas kernel's float32 choices and stay the same in float64), the
deferred correction with psi == 1, Rhie-Chow compact, the tensor-product
pressure solve with ``ops.n_refine`` refinement steps and the p'[0,0]
gauge, and the FD-ghost metrics whose lid ghost uses the constant lid
velocity. The kernels take every N >= 3 and nx != ny (the Pallas VMEM caps
are not ported); MUSCL-sharp and rhie_chow=averaged raise ``ValueError``.

Dispatch is by the state's device and nothing else: a CPU tensor takes the
plain version; a CUDA tensor launches the kernels or raises (a failed build
or launch is an error, never a fall-back).

The kernels take B lanes per launch (``ops/fv_lane_kernels.py`` runs sweep
lanes through them); the wrappers here are the B = 1 case. The scalars (mu,
dx, dy, alpha_uv, alpha_p, rho, lid) reach the kernels as a device table in
the working dtype (``scalar_table``).

Launch counts: ``LAUNCHES`` counts the kernel launches the wrappers made,
by kernel. A SIMPLE iteration is 2 launches in float32 and in float64, and
a step or a chunk adds none: fv_bicgstab 1 (one cooperative launch for the
assembly and the K-iteration solve; plain version ``plain_momentum``) and
fv_pressure 1 (one cooperative launch for Rhie-Chow, the pressure solve
with its n_refine refinement steps, the corrections, the metrics and
control; its grid is ``pressure_grid``; plain version
``plain_pressure_launch``). ``PLAIN_CALLS`` counts calls of the plain
versions ("fv_step", "fv_chunk") and of the unfused ``models/fv.fv_step``
on a CUDA solve ("fv_unfused"). ``reset_counts()`` zeroes both.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.fv import FVOps, FVState, _fd_gradient, fd_vorticity, fv_step
from ..models.runner import WARMUP_ITERS, control_step
from . import fv_stencils as st
from .fv_stencils import shift_e, shift_n, shift_s, shift_w

__all__ = ["make_fv_step", "make_fv_chunk_runner", "fv_iterate_plain",
           "step_plain", "chunk_plain", "chunk_body", "validate", "statics",
           "scalar_table", "workspace", "chunk_workspace", "unfused_step",
           "bench_workspace",
           "bench_kernel", "pad_state", "unpad_state", "LAUNCHES",
           "PLAIN_CALLS", "STEPS", "KERNELS", "reset_counts", "METRIC_NAMES",
           "plain_momentum", "plain_pressure_stage", "plain_control",
           "plain_pressure_launch", "pressure_grid", "coresident",
           "check_launch", "MAX_ITEMS"]

KERNELS = ("fv_bicgstab", "fv_pressure")
LAUNCHES = {k: 0 for k in KERNELS}
PLAIN_CALLS = {"fv_step": 0, "fv_chunk": 0, "fv_unfused": 0}
# iterations asked of the chunk runners: a chunk's n, once per call
STEPS = {"fv_chunk": 0}
METRIC_NAMES = ("u_eq", "v_eq", "continuity", "energy", "enstrophy",
                "palinstrophy")
N_COLS = 7
EPS = 1e-30          # every BiCGSTAB divisor (pallas_fv.py:266)
GUARD = 1e-16        # the breakdown guard's relative threshold

# pointer-table order of csrc/fv_common.cuh:Ptr
_PTR_NAMES = (
    "V1", "V2", "inv_lam", "A1", "A2", "aP_bc", "b_bc_u",
    "u", "v", "p", "mx", "my",
    "gpx", "gpy", "aPr", "aE", "aW", "aN", "aS", "Du",
    "x", "r", "rh", "pv0", "pv1", "vv0", "vv1", "s", "t",
    "mxs", "mys", "rhsp", "res", "g1", "g2", "g3", "pp",
    "part_rhs", "part_r", "part_v", "part_t", "part_m", "part_m2",
    "part_c", "part_q", "slots", "metrics", "rows", "flags", "ref_norm",
    "lsc")
_PARTS = {"part_rhs": 2, "part_r": 4, "part_v": 2, "part_t": 4,
          "part_m": 1, "part_m2": 1, "part_c": 7, "part_q": 3}
_NSLOT = 3  # the BiCGSTAB start values rho, alpha, omega
_TILE = 16
MAX_ITEMS = 64  # (tile, lane) items a block of the pressure launch may take


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in PLAIN_CALLS:
        PLAIN_CALLS[k] = 0
    STEPS["fv_chunk"] = 0


def validate(ops: FVOps) -> None:
    """The configurations the fused iteration implements (the Pallas
    kernel's rejections, without its VMEM caps)."""
    if str(ops.limiter or "").lower() == "muscl-sharp":
        raise ValueError("MUSCL-sharp stays on the unfused fv_step path")
    if str(ops.rhie_chow) != "compact":
        raise ValueError("the fused FV iteration implements "
                         "rhie_chow=compact")
    if min(ops.nx, ops.ny) < 3:
        raise ValueError(f"the fused FV iteration needs nx, ny >= 3 "
                         f"(got {ops.nx} x {ops.ny})")


def unfused_step(ops: FVOps):
    """``models/fv.fv_step`` as the step of a CUDA solve whose configuration
    the fused kernels do not take, counted in PLAIN_CALLS["fv_unfused"]."""
    def step(state):
        PLAIN_CALLS["fv_unfused"] += 1
        return fv_step(ops, state)

    return step


def statics(params, ops: FVOps) -> dict:
    """Constant arrays and scalars of the fused iteration, in the working
    dtype on the ops' device (pallas_fv.py:_build_statics)."""
    nx, ny = ops.nx, ops.ny
    kw = dict(dtype=ops.dtype, device=ops.device)
    mu = float(ops.mu)
    lid = float(params.lid_velocity)
    Dxc = mu * ops.dy / ops.dx
    Dyc = mu * ops.dx / ops.dy
    aP_bc = np.zeros((ny, nx))
    aP_bc[:, 0] += 2 * Dxc
    aP_bc[:, -1] += 2 * Dxc
    aP_bc[0, :] += 2 * Dyc
    aP_bc[-1, :] += 2 * Dyc
    b_bc_u = np.zeros((ny, nx))
    b_bc_u[-1, :] = 2 * Dyc * ops.bc_u_n.detach().cpu().double().numpy()
    has_e, has_w, has_n, has_s = st.neighbor_masks((ny, nx), ops.dtype,
                                                   ops.device, False)
    t = lambda a: torch.as_tensor(a, **kw).contiguous()
    P = ops.poisson
    S = dict(has_e=has_e, has_w=has_w, has_n=has_n, has_s=has_s,
             aP_bc=t(aP_bc), b_bc_u=t(b_bc_u),
             V1=P.Vx.contiguous(), V2=P.Vy.contiguous(),
             inv_lam=P.inv_lam.contiguous(), A1=P.Ax.contiguous(),
             A2=P.Ay.contiguous())
    for name, val in (("mu", mu), ("dx", ops.dx), ("dy", ops.dy),
                      ("alpha_uv", ops.alpha_uv), ("alpha_p", ops.alpha_p),
                      ("rho", float(ops.rho)), ("lid", lid)):
        S[name] = torch.tensor(val, **kw)
    S["host_scalars"] = (mu, ops.dx, ops.dy, ops.alpha_uv, ops.alpha_p,
                         float(ops.rho), lid)
    S["upwind"] = str(ops.scheme).lower() == "upwind"
    S["n_refine"] = int(ops.n_refine)
    S["lsc"] = scalar_table([S])
    return S


def scalar_table(S_list) -> torch.Tensor:
    """The (lanes, 8) table of per-lane scalars in csrc/fv_common.cuh:Scal
    order (mu, dx, dy, alpha_uv, alpha_p, rho, lid, 0), in the working dtype
    on the statics' device: each value is the host double cast to the
    working type."""
    like = S_list[0]["mu"]
    return torch.tensor([list(S["host_scalars"]) + [0.0] for S in S_list],
                        dtype=like.dtype, device=like.device)


# ------------------------------------------------------------ plain version


def pad_state(state: FVState):
    """(u, v, p, mx, my) with the face fluxes zero-padded to (ny, nx)."""
    u, v, p, mx, my = state
    return u, v, p, torch.nn.functional.pad(mx, (0, 1)), \
        torch.nn.functional.pad(my, (0, 0, 0, 1))


def unpad_state(u, v, p, mx, my) -> FVState:
    """The inverse of ``pad_state``."""
    nx, ny = u.shape[1], u.shape[0]
    return FVState(u, v, p, mx[:, :nx - 1].contiguous(),
                   my[:ny - 1, :].contiguous())


def _gradient(S, phi):
    """Unlimited central gradient with the pinned cell 0."""
    return st.cell_gradient(phi, S["dx"], S["dy"], use_limiter=False)


def _divergence(fx, fy):
    """Divergence of face fluxes zero-padded to (ny, nx)."""
    return st.divergence_from_fluxes(fx[:, :-1], fy[:-1, :])


def plain_assemble(S, u, v, p, mx, my):
    """Phase (a): pressure gradient, momentum coefficients, deferred
    correction and the Patankar right-hand sides (padded faces)."""
    dx, dy = S["dx"], S["dy"]
    vol = dx * dy
    Dxc = S["mu"] * dy / dx
    Dyc = S["mu"] * dx / dy
    has_e, has_w, has_n, has_s = (S[k] for k in ("has_e", "has_w", "has_n",
                                                 "has_s"))
    gpx, gpy = _gradient(S, p)
    mx_pos, mx_neg = torch.clamp_min(mx, 0.0), torch.clamp_min(-mx, 0.0)
    my_pos, my_neg = torch.clamp_min(my, 0.0), torch.clamp_min(-my, 0.0)
    aE = -(mx_neg + Dxc) * has_e
    aW = -(shift_w(mx_pos) + Dxc) * has_w
    aN = -(my_neg + Dyc) * has_n
    aS = -(shift_s(my_pos) + Dyc) * has_s
    aP = ((mx_pos + Dxc) * has_e + (shift_w(mx_neg) + Dxc) * has_w
          + (my_pos + Dyc) * has_n + (shift_s(my_neg) + Dyc) * has_s
          + S["aP_bc"])

    def deferred(phi):
        if S["upwind"]:
            return torch.zeros_like(phi)
        # psi == 1: the face source is |m|*(N-P)/2 for both flux signs
        dc_x = 0.5 * torch.abs(mx) * (shift_e(phi) - phi) * has_e
        dc_y = 0.5 * torch.abs(my) * (shift_n(phi) - phi) * has_n
        return (-dc_x + shift_w(dc_x) * has_w - dc_y + shift_s(dc_y) * has_s)

    b_u = S["b_bc_u"] + deferred(u) - gpx * vol
    b_v = deferred(v) - gpy * vol
    aP_rel = aP / S["alpha_uv"]
    scale = (1.0 - S["alpha_uv"]) / S["alpha_uv"]
    return dict(gpx=gpx, gpy=gpy, aE=aE, aW=aW, aN=aN, aS=aS, aP=aP,
                aP_rel=aP_rel, rhs_u=b_u + scale * aP * u,
                rhs_v=b_v + scale * aP * v)


def plain_bicgstab(c, u, v, K: int):
    """K fixed BiCGSTAB iterations on the joint u/v system, warm-started
    from (u, v), with the breakdown guard and sel-frozen scalars."""
    aP_rel = c["aP_rel"]

    def A(x):
        return (aP_rel * x + c["aE"] * shift_e(x) + c["aW"] * shift_w(x)
                + c["aN"] * shift_n(x) + c["aS"] * shift_s(x))

    def dot2(a1, a2, b1, b2):
        return torch.sum(a1 * b1) + torch.sum(a2 * b2)

    one = torch.ones((), dtype=u.dtype, device=u.device)
    rhs_u, rhs_v = c["rhs_u"], c["rhs_v"]
    x1, x2 = u, v
    r1, r2 = rhs_u - A(x1), rhs_v - A(x2)
    rh1, rh2 = r1, r2
    rho_k = alpha_k = omega_k = one
    pv1 = pv2 = vv1 = vv2 = torch.zeros_like(u)
    rhs_nrm2 = dot2(rhs_u, rhs_v, rhs_u, rhs_v) + EPS
    for _ in range(int(K)):
        active = dot2(r1, r2, r1, r2) > GUARD * rhs_nrm2
        sel = lambda new, old: torch.where(active, new, old)
        rho1 = sel(dot2(rh1, rh2, r1, r2), rho_k)
        beta = (rho1 / (rho_k + EPS)) * (alpha_k / (omega_k + EPS))
        pv1 = sel(r1 + beta * (pv1 - omega_k * vv1), pv1)
        pv2 = sel(r2 + beta * (pv2 - omega_k * vv2), pv2)
        ph1, ph2 = pv1 / aP_rel, pv2 / aP_rel
        vv1 = sel(A(ph1), vv1)
        vv2 = sel(A(ph2), vv2)
        alpha_k = sel(rho1 / (dot2(rh1, rh2, vv1, vv2) + EPS), alpha_k)
        s1, s2 = r1 - alpha_k * vv1, r2 - alpha_k * vv2
        sh1, sh2 = s1 / aP_rel, s2 / aP_rel
        t1, t2 = A(sh1), A(sh2)
        omega_new = dot2(t1, t2, s1, s2) / (dot2(t1, t2, t1, t2) + EPS)
        omega_k = sel(omega_new, omega_k)
        x1 = sel(x1 + alpha_k * ph1 + omega_k * sh1, x1)
        x2 = sel(x2 + alpha_k * ph2 + omega_k * sh2, x2)
        r1 = sel(s1 - omega_k * t1, r1)
        r2 = sel(s2 - omega_k * t2, r2)
        rho_k = rho1
    return x1, x2


def plain_rhie_chow(S, c, u_star, v_star, p):
    """Phase (b): Rhie-Chow compact face fluxes and the pressure-correction
    right-hand side -div(mdot*)."""
    dx, dy = S["dx"], S["dy"]
    Du = dx * dy / (c["aP"] + 1e-14)
    ubar_x = 0.5 * (u_star + shift_e(u_star))
    vbar_y = 0.5 * (v_star + shift_n(v_star))
    De = 0.5 * (Du + shift_e(Du))
    Dn = 0.5 * (Du + shift_n(Du))
    gpx_f = 0.5 * (c["gpx"] + shift_e(c["gpx"]))
    gpy_f = 0.5 * (c["gpy"] + shift_n(c["gpy"]))
    Uf_x = (ubar_x - De * ((shift_e(p) - p) / dx - gpx_f)) * S["has_e"]
    Uf_y = (vbar_y - Dn * ((shift_n(p) - p) / dy - gpy_f)) * S["has_n"]
    mx_star = S["rho"] * Uf_x * dy
    my_star = S["rho"] * Uf_y * dx
    return Du, mx_star, my_star, -_divergence(mx_star, my_star)


def plain_pressure(S, rhs_p):
    """The tensor-product pressure solve with refinement and the gauge
    (the product phases of ``csrc/fv_pressure.cu``)."""
    V1, V2, inv_lam = S["V1"], S["V2"], S["inv_lam"]

    def psolve(f):
        return (V1 @ (((V1.T @ f) @ V2) * inv_lam)) @ V2.T

    rhs_p = rhs_p - torch.mean(rhs_p)
    p_prime = psolve(rhs_p)
    for _ in range(S["n_refine"]):
        res = rhs_p - (S["A1"] @ p_prime + p_prime @ S["A2"].T)
        res = res - torch.mean(res)
        p_prime = p_prime + psolve(res)
    return p_prime - p_prime[0, 0]


def plain_correct(S, Du, u_star, v_star, p, mx_star, my_star, p_prime):
    """Phase (c): corrections, the new state, and the six metrics."""
    dx, dy = S["dx"], S["dy"]
    gppx, gppy = _gradient(S, p_prime)
    u_prime = -Du * gppx
    v_prime = -Du * gppy
    u_new = u_star + u_prime
    v_new = v_star + v_prime
    p_new = p + S["alpha_p"] * p_prime
    mx_new = mx_star + S["rho"] * 0.5 * (u_prime + shift_e(u_prime)) * dy \
        * S["has_e"]
    my_new = my_star + S["rho"] * 0.5 * (v_prime + shift_n(v_prime)) * dx \
        * S["has_n"]
    mass = _divergence(mx_new, my_new)
    omega = fd_vorticity(u_new, v_new, dx, dy, S["lid"])
    dwx, dwy = _fd_gradient(omega, dx, dy)
    dA = dx * dy
    metrics = torch.stack([
        torch.sqrt(torch.sum(u_prime * u_prime)),
        torch.sqrt(torch.sum(v_prime * v_prime)),
        torch.sqrt(torch.sum(mass * mass)),
        0.5 * torch.sum(u_new * u_new + v_new * v_new) * dA,
        0.5 * torch.sum(omega * omega) * dA,
        0.5 * torch.sum(dwx * dwx + dwy * dwy) * dA])
    return (u_new, v_new, p_new, mx_new, my_new), metrics


def plain_pressure_stage(S, c, u_star, v_star, p):
    """The pressure stage (``csrc/fv_pressure.cu``'s one launch): Rhie-Chow
    from the assembly ``c`` of ``plain_assemble``, the momentum solution
    u*, v* and the pressure ``p``, the pressure solve with its refinement
    and gauge, and the corrections. Returns the new state (faces padded)
    and the six metrics."""
    Du, mx_star, my_star, rhs_p = plain_rhie_chow(S, c, u_star, v_star, p)
    p_prime = plain_pressure(S, rhs_p)
    return plain_correct(S, Du, u_star, v_star, p, mx_star, my_star, p_prime)


def plain_momentum(S, u, v, p, mx, my, K: int):
    """The momentum launch (``csrc/fv_bicgstab.cu``): the assembly
    ``plain_assemble`` of the padded state, then K iterations of
    ``plain_bicgstab`` from (u, v). Returns the assembly and u*, v*."""
    c = plain_assemble(S, u, v, p, mx, my)
    return (c,) + plain_bicgstab(c, u, v, K)


def plain_control(cur, new, metrics, idx, flags, ref_norm, tolerance,
                  warmup, use_residual=False):
    """Control, the last phase of the pressure launch, for one iteration of
    a chunk that started from the padded state ``cur`` and reached ``new``
    with the six ``metrics``: rel_iter, the history row and the state
    machine ``runner.control_step`` (global iteration ``idx``, flags
    (done, conv_iter, converged), the residual criterion's ``ref_norm``).
    Returns the state (``cur`` where the lane began done), the row, the new
    flags and ref_norm."""
    done, conv_iter, converged = flags
    nrm = lambda a: torch.sqrt(torch.sum(a * a))
    rel = torch.maximum(nrm(new[0] - cur[0]) / (nrm(cur[0]) + 1e-12),
                        nrm(new[1] - cur[1]) / (nrm(cur[1]) + 1e-12))
    row, now_done, conv_iter, converged, ref_norm = control_step(
        torch.cat([rel.reshape(1), metrics]), idx, done, conv_iter,
        converged, ref_norm, tolerance, warmup, use_residual)
    state = tuple(torch.where(done, a, b) for a, b in zip(cur, new))
    return state, row, (now_done, conv_iter, converged), ref_norm


def plain_pressure_launch(S, c, u_star, v_star, cur, ctl=None):
    """The pressure launch (``csrc/fv_pressure.cu``): the pressure stage
    (``plain_pressure_stage``) from the padded start state ``cur``, its
    assembly ``c`` and u*, v*, then control. A step (``ctl`` None) returns
    the new state and the six metrics; an iteration of a chunk passes
    ``ctl`` = (idx, flags, ref_norm, tolerance, warmup, use_residual) and
    returns what ``plain_control`` returns."""
    new, metrics = plain_pressure_stage(S, c, u_star, v_star, cur[2])
    if ctl is None:
        return new, metrics
    return plain_control(cur, new, metrics, *ctl)


def _iterate_padded(S, K, cur, ctl=None):
    c, u_star, v_star = plain_momentum(S, *cur, K)
    return plain_pressure_launch(S, c, u_star, v_star, cur, ctl)


def fv_iterate_plain(S: dict, state: FVState, K: int):
    """One fused SIMPLE iteration in plain torch (``_make_iterate``):
    ``(new_state, metrics[6])`` for the statics ``S`` of ``statics()``."""
    new, metrics = _iterate_padded(S, K, pad_state(state))
    return unpad_state(*new), metrics


def step_plain(S, state: FVState, K: int):
    """The step kernel's plain version."""
    PLAIN_CALLS["fv_step"] += 1
    new, m = fv_iterate_plain(S, state, K)
    return new, dict(zip(METRIC_NAMES, m.unbind()))


def chunk_plain(S, state: FVState, start_iter, ref_norm, chunk: int,
                tolerance: float, warmup: int, K: int):
    """The chunk kernel's plain version (pallas_fv.py:471-541)."""
    PLAIN_CALLS["fv_chunk"] += 1
    return chunk_body(S, state, start_iter, ref_norm, chunk, tolerance,
                      warmup, K)


def chunk_body(S, state: FVState, start_iter, ref_norm, chunk: int,
               tolerance: float, warmup: int, K: int,
               use_residual: bool = False, carry=None):
    """``chunk_plain`` without its count, starting from the flags ``carry``
    = (done, conv_iter, converged) of a previous chunk (fresh when None): a
    lane of ``ops/fv_lane_kernels.lanes_plain``. The rel_iter criterion, or
    with ``use_residual`` the residual criterion (``runner.control_step``)
    normalized by ``ref_norm``. Returns (state, done, conv_iter, converged,
    rows, ref_norm)."""
    cur = pad_state(state)
    dev, dt = state.u.device, state.u.dtype
    if carry is None:
        carry = (torch.zeros((), dtype=torch.bool, device=dev),
                 torch.full((), -1, dtype=torch.int32, device=dev),
                 torch.zeros((), dtype=torch.bool, device=dev))
    ref_norm = torch.as_tensor(ref_norm, dtype=dt, device=dev)
    rows = []
    for i in range(int(chunk)):
        cur, row, carry, ref_norm = _iterate_padded(
            S, K, cur, (int(start_iter) + i, carry, ref_norm, tolerance,
                        warmup, use_residual))
        rows.append(row)
    done, conv_iter, converged = carry
    return (unpad_state(*cur), done, conv_iter, converged, torch.stack(rows),
            ref_norm)


# ------------------------------------------------------------ CUDA path


def _dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.float64:
        return 1
    raise TypeError(f"the FV kernels take float32 or float64, not {dtype}")


def _check(name, t: torch.Tensor, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(ops: FVOps, state: FVState) -> bool:
    """Check the state against the operators; True for the kernel path."""
    ny, nx = ops.ny, ops.nx
    for name, t, shape in zip(FVState._fields, state,
                              ((ny, nx), (ny, nx), (ny, nx), (ny, nx - 1),
                               (ny - 1, nx))):
        _check(f"state.{name}", t, shape, ops.dtype, ops.device)
    if ops.device.type not in ("cuda", "cpu"):
        raise ValueError("the FV kernels run on cuda, and their plain "
                         f"versions on cpu, not on {ops.device}")
    return ops.device.type == "cuda"


def _tiles(n: int) -> int:
    return (n + _TILE - 1) // _TILE


def pressure_grid(ny: int, nx: int, lanes: int, coresident: int) -> int:
    """Blocks of the pressure stage's cooperative launch for ``lanes`` lanes
    of ny x nx cells on a card where ``coresident`` of its blocks fit at
    once: a block a (16x16 tile, lane) item, at most ``coresident``; block
    b takes items b, b + blocks, ... (item i is lane i // tiles, tile
    i % tiles, tiles row-major) in every phase. Raises ValueError where a
    block would take more than ``MAX_ITEMS`` items: such a launch is
    refused (csrc/fv_pressure.cu:pressure_grid, the same rule), never run
    another way."""
    if min(ny, nx, lanes, coresident) < 1:
        raise ValueError(f"no pressure launch for {ny}x{nx}, {lanes} lanes, "
                         f"{coresident} co-resident blocks")
    items = _tiles(ny) * _tiles(nx) * lanes
    blocks = min(items, coresident)
    if -(-items // blocks) > MAX_ITEMS:
        raise ValueError(f"{ny}x{nx}, {lanes} lanes: {items} pressure items "
                         f"on {blocks} co-resident blocks is more than "
                         f"{MAX_ITEMS} a block")
    return blocks


_CORESIDENT = {}


def coresident(dtype: torch.dtype) -> int:
    """Co-resident blocks of the pressure kernel on the current card (asked
    once a dtype)."""
    code = _dtype_code(dtype)
    if code not in _CORESIDENT:
        lib = _lib()
        most = ctypes.c_int(0)
        _raise_on(lib, lib.fv_pressure_coresident(code, ctypes.byref(most)),
                  "fv_pressure_coresident")
        _CORESIDENT[code] = most.value
    return _CORESIDENT[code]


def check_launch(ops: FVOps, lanes: int = 1) -> None:
    """Raise ValueError before any launch where the card cannot take the
    pressure stage of ``lanes`` lanes of this grid (``pressure_grid``)."""
    pressure_grid(ops.ny, ops.nx, lanes, coresident(ops.dtype))


def workspace(S, ops: FVOps, state: FVState, K: int, chunk: int, lsc,
              flags, lanes=None, ref_norm=None, **statics) -> dict:
    """Every buffer of one kernel call for ``lanes`` lanes (None: one, with
    no lane axis): the state cloned in (the kernels update it in place),
    scratch, partial sums, the BiCGSTAB start values, the scalar table
    ``lsc``, the flags and the residual normalizations ``ref_norm`` (cloned
    in; inf when None) and the outputs (rows for a chunk, metrics for a
    step). The shared operators come from ``S``; the per-lane statics aP_bc
    and b_bc_u from ``statics`` (default ``S``'s)."""
    ny, nx = ops.ny, ops.nx
    lead = () if lanes is None else (int(lanes),)
    kw = dict(dtype=ops.dtype, device=ops.device)
    nb = _tiles(ny) * _tiles(nx)
    ws = {k: S[k] for k in ("V1", "V2", "inv_lam", "A1", "A2", "aP_bc",
                            "b_bc_u")}
    ws.update(statics)
    ws.update(zip(FVState._fields, (t.clone() for t in state)))
    for k in ("gpx", "gpy", "aPr", "aE", "aW", "aN", "aS", "Du", "mxs",
              "mys", "rhsp", "res", "g1", "g2", "g3", "pp"):
        ws[k] = torch.empty(lead + (ny, nx), **kw)
    for k in ("x", "r", "rh", "pv0", "pv1", "vv0", "vv1", "s", "t"):
        ws[k] = torch.empty(lead + (2, ny, nx), **kw)
    for k, ncol in _PARTS.items():
        ws[k] = torch.empty(lead + (nb, ncol), **kw)
    ws["slots"] = torch.empty(lead + (_NSLOT,), **kw)
    ws["metrics"] = torch.empty(lead + (6,), **kw)
    ws["rows"] = torch.empty((max(int(chunk), 1),) + lead + (N_COLS,), **kw)
    ws["flags"] = flags.clone()
    ws["ref_norm"] = (torch.full((int(lanes or 1),), float("inf"), **kw)
                      if ref_norm is None else ref_norm.clone())
    ws["lsc"] = lsc
    return ws


def chunk_workspace(S, ops: FVOps, state: FVState, K: int, chunk: int = 0,
                    lsc=None) -> dict:
    """The one-lane ``workspace`` from fresh flags; ``lsc`` is the scalar
    table (``S["lsc"]`` when not given)."""
    flags = torch.tensor([0, -1, 0], dtype=torch.int32, device=ops.device)
    return workspace(S, ops, state, K, chunk,
                     S["lsc"] if lsc is None else lsc, flags)


def _ptr_table(ws: dict):
    ptrs = [ws[n].data_ptr() for n in _PTR_NAMES]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.fv_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _count(counts):
    for k, n in zip(KERNELS, counts):
        LAUNCHES[k] += int(n)


def _lib():
    from ._build import load_library

    return load_library("fv")


def _common_args(S, ops, ws, K):
    return (_dtype_code(ops.dtype), ops.ny, ops.nx, _ptr_table(ws), int(K),
            S["n_refine"], int(S["upwind"]))


def _run_step(S, ops, state, K):
    lib = _lib()
    check_launch(ops)
    ws = chunk_workspace(S, ops, state, K)
    counts = (ctypes.c_int * len(KERNELS))()
    rc = lib.fv_step_run(*_common_args(S, ops, ws, K), counts, _stream())
    return ws, counts, lib, rc


def _step_kernel(S, ops, state, K):
    ws, counts, lib, rc = _run_step(S, ops, state, K)
    _count(counts)
    _raise_on(lib, rc, "fv_step_run")
    new = FVState(*(ws[k] for k in FVState._fields))
    return new, dict(zip(METRIC_NAMES, ws["metrics"].unbind()))


def make_fv_step(params, ops: FVOps, bicgstab_iters: int = 16):
    """One fused SIMPLE iteration: ``step(state) -> (state, metrics)``."""
    validate(ops)
    S = statics(params, ops)
    K = int(bicgstab_iters)

    def step(state):
        if _on_cuda(ops, state):
            return _step_kernel(S, ops, state, K)
        return step_plain(S, state, K)

    return step


def _chunk_kernel(S, ops, state, start_iter, ref_norm, chunk, tolerance,
                  warmup, K):
    lib = _lib()
    check_launch(ops)
    ws = chunk_workspace(S, ops, state, K, chunk)
    counts = (ctypes.c_int * len(KERNELS))()
    rc = lib.fv_chunk_run(*_common_args(S, ops, ws, K), int(chunk),
                          int(start_iter), int(warmup), float(tolerance),
                          counts, _stream())
    _count(counts)
    _raise_on(lib, rc, "fv_chunk_run")
    flags = ws["flags"]
    ref = torch.as_tensor(ref_norm, dtype=ops.dtype, device=ops.device)
    return (FVState(*(ws[k] for k in FVState._fields)), flags[0] > 0,
            flags[1], flags[2] > 0, ws["rows"], ref)


def make_fv_chunk_runner(params, ops: FVOps, chunk: int, tolerance: float,
                         warmup: int = WARMUP_ITERS,
                         bicgstab_iters: int = 16):
    """``chunk`` fused SIMPLE iterations with the rel_iter state machine, as
    one device-side loop (see the module docstring for the contract)."""
    validate(ops)
    S = statics(params, ops)
    args = dict(chunk=int(chunk), tolerance=float(tolerance),
                warmup=int(warmup), K=int(bicgstab_iters))

    def chunk_fn(state, start_iter, ref_norm):
        STEPS["fv_chunk"] += args["chunk"]
        if _on_cuda(ops, state):
            return _chunk_kernel(S, ops, state, start_iter, ref_norm, **args)
        return chunk_plain(S, state, start_iter, ref_norm, **args)

    return chunk_fn


def bench_workspace(S, ops: FVOps, state: FVState, K: int) -> dict:
    """The workspace of one kernel step from ``state`` (not counted in
    LAUNCHES): its buffers hold the step's intermediates (``x`` = u*, v*;
    ``rhsp`` = -div(mdot*); ``pp`` = p' before the gauge; ``metrics``) for
    checks against the plain phases, and real values for ``bench_kernel``."""
    ws, _, lib, rc = _run_step(S, ops, state, K)
    _raise_on(lib, rc, "fv_step_run")
    return ws


def bench_kernel(S, ops: FVOps, ws: dict, which: str, K: int,
                 reps: int, lanes: int = 1, folded: bool = True) -> None:
    """Enqueue ``reps`` times the launch one kernel makes in one SIMPLE
    iteration, on a workspace of ``bench_workspace`` (or of ``workspace``
    for ``lanes`` lanes), for timing only (not counted in LAUNCHES):
    fv_bicgstab the assembly and the K-iteration solve, fv_pressure the
    pressure stage and control (it updates the workspace's state in place;
    control writes the first row, and sets no flag). With ``folded`` False
    each launch leaves out the phase folded into it: the solve alone (from
    the workspace's last solve) and the pressure stage without control, so
    that the folded phase's cost is the difference."""
    lib = _lib()
    rc = lib.fv_bench_run(_dtype_code(ops.dtype), ops.ny, ops.nx, int(lanes),
                          _ptr_table(ws), int(K), S["n_refine"],
                          int(S["upwind"]), KERNELS.index(which),
                          int(bool(folded)), int(reps), _stream())
    _raise_on(lib, rc, f"fv_bench_run({which})")
