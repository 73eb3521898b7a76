"""The Schur-complement BiCGSTAB of the Newton steady solver's Stokes
preconditioner: the hand-written CUDA kernel's wrapper beside its plain
PyTorch version.

``schur_solve(S, rhs, inv_dt, inv_hlam, tol, maxiter) -> (dp, k)`` solves

    S(pp) = inv_dt pp - beta^2 (Dxi hx + hy DyTi),
    hx = H^{-1}(Gxr pp IyTr),  hy = H^{-1}(Ixr pp GyTr),
    H^{-1} f = Vx (((Vxi f) Vyi^T) * inv_hlam) Vy^T

for (ni x ni) float64 operands with the semantics of
``jax.scipy.sparse.linalg.bicgstab(S, rhs, tol=tol, maxiter=maxiter)``, as
the JAX package's ``anap3_tpu/models/steady.py:_StokesPreconditioner._apply``
runs it inside its jitted matvec. ``S`` is a ``SchurOps`` (the operators and
beta^2); ``k`` is the iterations taken or a breakdown code (-10, -11), a
0-d int32 tensor on the operands' device.

Dispatch is by the device of ``rhs`` and nothing else: a CPU tensor takes
the plain version ``schur_plain`` (``schur_bicgstab`` on ``schur_apply``, the
loop run to its whole budget with masked updates, which reads nothing back
to the host); a CUDA tensor launches ``csrc/nk_schur.cu:schur_kernel`` (one
cooperative launch a solve, which stops on the device where the JAX loop
stops) or raises.

Launch counts: ``LAUNCHES["nk_schur"]`` counts the kernel's launches on the
device. A launch enqueued while the stream is being captured into a CUDA
graph runs only when the graph is replayed: it adds to ``CAPTURED`` instead,
and the graph's owner adds its captured launches to ``LAUNCHES`` at every
replay (``count_replay``). ``PLAIN_CALLS["nk_schur"]`` counts calls of the
plain version. ``reset_counts()`` zeroes all three.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from .sg_kernels import _check

__all__ = ["SchurOps", "schur_solve", "schur_kernel", "schur_plain",
           "schur_apply", "schur_bicgstab", "hsolve", "grad", "div",
           "schur_flops", "schur_bytes", "KERNELS", "LAUNCHES", "CAPTURED",
           "PLAIN_CALLS", "reset_counts", "count_replay"]

KERNELS = ("nk_schur",)
LAUNCHES = {k: 0 for k in KERNELS}
CAPTURED = {k: 0 for k in KERNELS}
PLAIN_CALLS = {k: 0 for k in KERNELS}

# pointer-table order of csrc/nk_common.cuh:Ptr
_OPERATORS = ("Gxr", "IyTr", "Ixr", "GyTr", "Vxi", "VyiT", "VyT", "Vx",
              "Dxi", "DyTi")
_PTR_NAMES = _OPERATORS + ("inv_hlam", "inv_dt", "b", "x", "k", "r", "p0",
                           "p1", "q", "s", "t", "w", "part")
_TILE = 16
_N_PART = 6  # partial-sum columns (csrc/nk_common.cuh:Part)


def reset_counts() -> None:
    for counts in (LAUNCHES, CAPTURED, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def count_replay(launches: dict) -> None:
    """Add a replayed CUDA graph's captured kernel launches to LAUNCHES."""
    for k, n in launches.items():
        LAUNCHES[k] += int(n)


@dataclass
class SchurOps:
    """The operators of the Schur complement, (ni x ni) each, and beta^2.
    ``VyiT`` and ``VyT`` are contiguous copies of the transposes, for the
    kernel; the plain version multiplies by the transposed views, as the
    JAX package does."""

    Gxr: torch.Tensor
    IyTr: torch.Tensor
    Ixr: torch.Tensor
    GyTr: torch.Tensor
    Vxi: torch.Tensor
    Vyi: torch.Tensor
    Vx: torch.Tensor
    Vy: torch.Tensor
    Dxi: torch.Tensor
    DyTi: torch.Tensor
    beta_sq: float
    VyiT: torch.Tensor = field(init=False)
    VyT: torch.Tensor = field(init=False)

    def __post_init__(self):
        self.VyiT = self.Vyi.T.contiguous()
        self.VyT = self.Vy.T.contiguous()


# ------------------------------------------------------------- plain


def hsolve(S: SchurOps, f, inv_hlam):
    """H^{-1} f by the separable eigen-factors."""
    z = (S.Vxi @ f) @ S.Vyi.T * inv_hlam
    return S.Vx @ (z @ S.Vy.T)


def grad(S: SchurOps, pp):
    """The interior-restricted pressure gradient (x, y)."""
    return (S.Gxr @ pp) @ S.IyTr, (S.Ixr @ pp) @ S.GyTr


def div(S: SchurOps, ui, vi):
    return S.Dxi @ ui + vi @ S.DyTi


def schur_apply(S: SchurOps, pp, inv_dt, inv_hlam):
    """S(pp) = inv_dt pp - beta^2 Div H^{-1} Grad pp."""
    gx, gy = grad(S, pp)
    return inv_dt * pp - S.beta_sq * div(S, hsolve(S, gx, inv_hlam),
                                         hsolve(S, gy, inv_hlam))


def schur_bicgstab(A, b, tol: float, maxiter: int):
    """BiCGSTAB from x0 = 0 with the semantics of
    ``jax.scipy.sparse.linalg.bicgstab(A, b, tol=tol, maxiter=maxiter)``
    (no preconditioner), without a host sync.

    The stop test (||r||^2 <= tol^2 ||b||^2), the early exit on ||s||^2 and
    the breakdown codes (-11 for omega = 0 or alpha = 0, -10 for rho = 0)
    are 0-d device tensors. All ``maxiter`` iterations run; once the loop
    would have stopped, every update is masked off, so x is the stopping
    loop's x. Returns (x, k): k the iterations taken or the breakdown code,
    as a device tensor. r0 = b - A(0) = b: A is linear."""
    vdot = lambda a, c: torch.sum(a * c)
    atol2 = tol * tol * vdot(b, b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    x, r, rhat, p, q = torch.zeros_like(b), b, b, b, b
    rho = alpha = omega = one
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    # the iteration index bounds k, so k < maxiter holds in every pass
    for _ in range(int(maxiter)):
        active = (vdot(r, r) > atol2) & (k >= 0)
        rho_ = vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + beta * (p - omega * q)
        q_ = A(p_)
        alpha_ = rho_ / vdot(rhat, q_)
        s = r - alpha_ * q_
        exit_early = vdot(s, s) < atol2
        t = A(s)
        omega_ = vdot(t, s) / vdot(t, t)
        x_ = torch.where(exit_early, x + alpha_ * p_,
                         x + (alpha_ * p_ + omega_ * s))
        r_ = torch.where(exit_early, s, s - omega_ * t)
        k_ = torch.where((omega_ == 0) | (alpha_ == 0),
                         torch.full_like(k, -11), k + 1)
        k_ = torch.where(rho_ == 0, torch.full_like(k, -10), k_)
        x = torch.where(active, x_, x)
        r = torch.where(active, r_, r)
        p = torch.where(active, p_, p)
        q = torch.where(active, q_, q)
        rho = torch.where(active, rho_, rho)
        alpha = torch.where(active, alpha_, alpha)
        omega = torch.where(active, omega_, omega)
        k = torch.where(active, k_, k)
    return x, k


def schur_plain(S: SchurOps, rhs, inv_dt, inv_hlam, tol: float,
                maxiter: int):
    """The plain version: the masked loop on ``schur_apply``."""
    PLAIN_CALLS["nk_schur"] += 1
    return schur_bicgstab(lambda pp: schur_apply(S, pp, inv_dt, inv_hlam),
                          rhs, tol=tol, maxiter=maxiter)


# ------------------------------------------------------------ CUDA path


def _lib():
    from ._build import load_library

    return load_library("nk")


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.nk_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def schur_kernel(S: SchurOps, rhs, inv_dt, inv_hlam, tol: float,
                 maxiter: int):
    """The kernel on CUDA tensors: every operand float64, contiguous and
    (ni x ni); ``inv_dt`` a 0-d device tensor (a float is filled into one).
    Reads nothing back to the host, so it can be captured in a CUDA
    graph."""
    dev = rhs.device
    ni = int(rhs.shape[0])
    if dev.type != "cuda":
        raise ValueError(f"the Schur kernel runs on cuda, not on {dev}")
    if not isinstance(inv_dt, torch.Tensor):
        inv_dt = torch.full((), float(inv_dt), dtype=torch.float64,
                            device=dev)
    f64 = torch.float64
    _check("inv_dt", inv_dt, (), f64, dev)
    for name in _OPERATORS:
        _check(name, getattr(S, name), (ni, ni), f64, dev)
    _check("inv_hlam", inv_hlam, (ni, ni), f64, dev)
    _check("rhs", rhs, (ni, ni), f64, dev)
    if int(maxiter) < 0:
        raise ValueError(f"maxiter {maxiter} < 0")
    lib = _lib()
    tiles = (-(-ni // _TILE)) ** 2
    kw = dict(dtype=f64, device=dev)
    ws = {name: getattr(S, name) for name in _OPERATORS}
    ws.update(inv_hlam=inv_hlam, inv_dt=inv_dt, b=rhs,
              x=torch.empty((ni, ni), **kw),
              k=torch.empty((), dtype=torch.int32, device=dev),
              w=torch.empty((4, ni, ni), **kw),
              part=torch.empty((tiles, _N_PART), **kw))
    for name in ("r", "p0", "p1", "q", "s", "t"):
        ws[name] = torch.empty((ni, ni), **kw)
    ptrs = (ctypes.c_void_p * len(_PTR_NAMES))(
        *[ws[n].data_ptr() for n in _PTR_NAMES])
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, lib.nk_schur_run(ni, ptrs, float(tol) * float(tol),
                                    float(S.beta_sq), int(maxiter), stream),
              "nk_schur_run")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED["nk_schur"] += 1
    else:
        LAUNCHES["nk_schur"] += 1
    return ws["x"], ws["k"]


def schur_solve(S: SchurOps, rhs, inv_dt, inv_hlam, tol: float,
                maxiter: int):
    """(dp, k) of the Schur system: the kernel on CUDA, the plain version
    on the CPU."""
    if rhs.device.type == "cuda":
        return schur_kernel(S, rhs, inv_dt, inv_hlam, tol, maxiter)
    if rhs.device.type != "cpu":
        raise ValueError(f"the Schur solve runs on cuda, and its plain "
                         f"version on cpu, not on {rhs.device}")
    return schur_plain(S, rhs, inv_dt, inv_hlam, tol, maxiter)


def schur_flops(ni: int, iterations: int) -> float:
    """Operations of ``iterations`` BiCGSTAB iterations: two S-applies of
    14 (ni x ni) products each, and about 40 operations an element of
    vector work (the S-applies' epilogues, five dot products, the
    updates)."""
    return iterations * (28 * 2.0 * ni ** 3 + 40.0 * ni * ni)


def schur_bytes(ni: int) -> float:
    """Bytes a solve must move: the ten operators, inv_hlam and the
    right-hand side read once, dp written once (float64)."""
    return 8.0 * (10 + 3) * ni * ni
