"""Direct steady-state solver of the port: Newton-Krylov with
pseudo-transient continuation (PTC).

The counterpart of ``anap3_tpu/models/steady.py``, with the same numerics:
the steady PN-PN-2 artificial-compressibility system F(x) = 0 is solved by

    (I/dt_k - J(x_k)) delta = F(x_k),    x_{k+1} = x_k + s * delta

with switched-evolution-relaxation dt ramping on full steps, a nonmonotone
(worst of the last 5 accepted ||F||) backtracking line search and the
dt-floor escape. J*v is ``torch.func.jvp`` through the residual core
(``models/spectral_sg.residuals``), exact for every corner treatment. Each
linear system is solved by right-preconditioned GMRES whose Arnoldi basis
lives on the host in numpy float64; the preconditioner is the shifted
Stokes block

    P = [ I/dt - nu*Lap     G    ]   velocity block: separable, exact by a
        [ beta^2 * Div      I/dt ]   tensor-product eigendecomposition;
                                     pressure: Schur-complement BiCGSTAB.

Everything on the device is float64. As the JAX package compiles its
matvec once (``@jax.jit matvec_fused``, ``inv_dt`` and ``inv_hlam`` traced
arguments), a PTC solve on CUDA captures the preconditioned matvec once
into a CUDA graph over static buffers (``_Matvec``: x, y, the output,
``inv_dt`` as a 0-d device tensor and ``inv_hlam``); a PTC step copies its
x, ``inv_dt`` and ``inv_hlam`` in, and each GMRES vector copies y in,
replays the graph and reads the result back once. The Schur BiCGSTAB inside
it is the hand-written kernel ``ops/nk_kernels`` (one cooperative launch
that stops on the device, as JAX's ``while_loop`` stops); the rest of the
graph is the PyTorch the JAX package leaves to XLA (the outer H-solves and
``torch.func.jvp`` through the residual core). On the CPU the same buffers
run eagerly through the plain Schur loop (``nk_kernels.schur_plain``: the
whole budget with masked updates), by the caller's choice of device. The
``newton_prelude`` march runs the SG kernels (``ops/sg_kernels``).
"""

from __future__ import annotations

import logging
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as nnf

from ..ops import nk_kernels as nk
from . import spectral_sg as core
from .params import SpectralParameters
from .runner import METRIC_KEYS, IterationResult
from .spectral import SGSolver

log = logging.getLogger(__name__)

__all__ = ["NewtonSolver", "ptc_solve", "polish_state"]


def _host(t: torch.Tensor) -> np.ndarray:
    """A writable float64 numpy copy of a device vector."""
    return np.array(t.detach().to("cpu", torch.float64).numpy())


class _SteadyProblem:
    """Flattened interior/inner unknown vector x and residual F for one grid.

    Unknowns are the interior velocity nodes plus the full inner pressure
    grid; the boundary data (ops.bc_u / ops.bc_v) is fixed and re-embedded
    on every residual evaluation, so F's Jacobian is exactly the interior
    linearization with Dirichlet rows eliminated.
    """

    def __init__(self, ops: core.SpectralOps):
        self.ops = ops
        nf = ops.nf
        self.ni = nf - 2
        self.n_vel = self.ni * self.ni
        self.n_tot = 2 * self.n_vel + self.ni * self.ni

    def unflatten(self, x):
        ni, nv = self.ni, self.n_vel
        return (x[:nv].reshape(ni, ni), x[nv:2 * nv].reshape(ni, ni),
                x[2 * nv:].reshape(ni, ni))

    def flatten(self, ui, vi, pp):
        return torch.cat([ui.reshape(-1), vi.reshape(-1), pp.reshape(-1)])

    def embed(self, ui, vi):
        """The interior values inside the fixed boundary data, out of place
        (a padded interior selected by the mask), so that forward-mode AD
        carries the tangent through the interior and none onto the
        boundary."""
        ops = self.ops
        u = torch.where(ops.interior, nnf.pad(ui, (1, 1, 1, 1)), ops.bc_u)
        v = torch.where(ops.interior, nnf.pad(vi, (1, 1, 1, 1)), ops.bc_v)
        return u, v

    def to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.ops.dtype, device=self.ops.device)

    def state_to_x(self, state: core.SpectralState) -> torch.Tensor:
        u, v = core.enforce_bc(self.ops, state.u, state.v)
        return self.flatten(u[1:-1, 1:-1], v[1:-1, 1:-1], state.p)

    def x_to_state(self, x) -> core.SpectralState:
        ui, vi, pp = self.unflatten(self.to_device(x))
        u, v = self.embed(ui, vi)
        return core.SpectralState(u=u, v=v, p=pp.contiguous())

    def F(self, x) -> torch.Tensor:
        return self._residual_flat(self.to_device(x))

    def jvp(self, x, t) -> torch.Tensor:
        return torch.func.jvp(self._residual_flat, (self.to_device(x),),
                              (self.to_device(t),))[1]

    def _residual_flat(self, x):
        ui, vi, pp = self.unflatten(x)
        u, v = self.embed(ui, vi)
        R_u, R_v, R_p = core.residuals(self.ops, u, v, pp)
        return self.flatten(R_u[1:-1, 1:-1], R_v[1:-1, 1:-1], R_p)


class _StokesPreconditioner:
    """Shifted-Stokes block preconditioner for the PTC systems.

    The velocity block H = I/dt - nu*Lap_interior is separable: one host
    eigendecomposition of the 1D interior Dirichlet second-derivative
    matrices (numpy, as in the JAX package, then moved to the device once)
    turns every H-solve into four (ni x ni) products. The pressure block is
    the AC Schur complement S = I/dt - beta^2 * Div H^{-1} Grad, solved by
    BiCGSTAB to a loose tolerance (``nk_kernels.schur_solve``: the kernel on
    CUDA): it only preconditions. ``inv_dt`` may be a float or a 0-d tensor
    (the graphed matvec's buffer): both give the same bits.
    """

    def __init__(self, problem: _SteadyProblem, grid: dict,
                 schur_iters: int = 40):
        ops = problem.ops
        self.problem = problem
        self.schur_iters = int(schur_iters)
        Dxx_i = np.asarray(grid["Dxx"], np.float64)[1:-1, 1:-1]
        Dyy_i = np.asarray(grid["Dyy"], np.float64)[1:-1, 1:-1]
        # Chebyshev interior Dirichlet operators have real negative spectra;
        # eig may return conjugate noise at the 1e-14 level -- take reals.
        lx, Vx = np.linalg.eig(Dxx_i)
        ly, Vy = np.linalg.eig(Dyy_i)
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                        dtype=ops.dtype, device=ops.device)
        self.LAM = dev(np.real(lx)[:, None] + np.real(ly)[None, :])
        self.beta_sq = ops.beta_sq
        # interior-restricted gradient / divergence operators and the
        # eigen-factors of H
        self.schur = nk.SchurOps(
            Gxr=ops.Gx[1:-1, :].contiguous(),
            IyTr=ops.IyT[:, 1:-1].contiguous(),
            Ixr=ops.Ix[1:-1, :].contiguous(),
            GyTr=ops.GyT[:, 1:-1].contiguous(),
            Vxi=dev(np.linalg.inv(np.real(Vx))),
            Vyi=dev(np.linalg.inv(np.real(Vy))),
            Vx=dev(np.real(Vx)), Vy=dev(np.real(Vy)),
            Dxi=ops.Dx[1:-1, 1:-1].contiguous(),
            DyTi=ops.DyT[1:-1, 1:-1].contiguous(), beta_sq=self.beta_sq)

    def inv_hlam(self, inv_dt) -> torch.Tensor:
        """Eigenvalues of H^{-1} for the current shift (recomputed per dt)."""
        return 1.0 / (inv_dt - self.problem.ops.nu * self.LAM)

    def apply(self, r, inv_dt, inv_hlam) -> torch.Tensor:
        S = self.schur
        r_u, r_v, r_p = self.problem.unflatten(r)
        rhs = r_p - self.beta_sq * nk.div(
            S, nk.hsolve(S, r_u, inv_hlam), nk.hsolve(S, r_v, inv_hlam))
        dp, _ = nk.schur_solve(S, rhs.contiguous(), inv_dt, inv_hlam,
                               tol=1e-8, maxiter=self.schur_iters)
        gx, gy = nk.grad(S, dp)
        du = nk.hsolve(S, r_u - gx, inv_hlam)
        dv = nk.hsolve(S, r_v - gy, inv_hlam)
        return self.problem.flatten(du, dv, dp)


def matvec_fused(problem: _SteadyProblem, precond: _StokesPreconditioner,
                 x_dev, y, inv_dt, inv_hlam) -> torch.Tensor:
    """(I/dt - J(x)) P^{-1} y on the device: the preconditioner, then the
    shifted Jacobian product. No host read. ``inv_dt`` a float or a 0-d
    tensor."""
    z = precond.apply(y, inv_dt, inv_hlam)
    return z * inv_dt - problem.jvp(x_dev, z)


class _Matvec:
    """The preconditioned matvec of one PTC solve over static buffers: the
    counterpart of the JAX package's ``@jax.jit matvec_fused``.

    ``set_step(x, inv_dt)`` copies a PTC step's x, ``inv_dt`` (a 0-d
    float64 device tensor, never a literal of the graph) and ``inv_hlam``
    into the buffers. ``__call__(y)`` takes and returns host float64
    vectors: y is copied in, the matvec runs and its result is read back
    once (a copy, so the next run cannot overwrite it). On CUDA the matvec
    is captured into one CUDA graph at its first call, after a warm-up on a
    side stream, and every later call replays it; the Schur kernel's
    launches in the graph count in ``nk_kernels.LAUNCHES`` at each replay.
    On the CPU the same buffers run the matvec eagerly.
    ``precond_apply(y)`` is P^{-1} y, eager (once a step).
    """

    def __init__(self, problem: _SteadyProblem,
                 precond: _StokesPreconditioner):
        self.problem, self.precond = problem, precond
        kw = dict(dtype=torch.float64, device=problem.ops.device)
        ni = problem.ni
        self.x = torch.zeros(problem.n_tot, **kw)
        self.y = torch.zeros(problem.n_tot, **kw)
        self.inv_dt = torch.ones((), **kw)
        self.inv_hlam = torch.ones((ni, ni), **kw)
        self.graphed = problem.ops.device.type == "cuda"
        self.graph = None
        self.out = None
        self.launches = {}  # the kernel launches of one replay

    def set_step(self, x: np.ndarray, inv_dt: float) -> None:
        self.x.copy_(torch.from_numpy(np.asarray(x, np.float64)))
        self.inv_dt.fill_(inv_dt)
        self.inv_hlam.copy_(self.precond.inv_hlam(self.inv_dt))

    def _fused(self):
        return matvec_fused(self.problem, self.precond, self.x, self.y,
                            self.inv_dt, self.inv_hlam)

    def _capture(self) -> None:
        side = torch.cuda.Stream(self.x.device)
        side.wait_stream(torch.cuda.current_stream(self.x.device))
        with torch.cuda.stream(side):
            self._fused()  # warm-up: library, co-resident count, caches
        torch.cuda.current_stream(self.x.device).wait_stream(side)
        before = dict(nk.CAPTURED)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self._fused()
        self.launches = {k: nk.CAPTURED[k] - before[k] for k in before}
        self.graph = graph

    def __call__(self, y: np.ndarray) -> np.ndarray:
        self.y.copy_(torch.from_numpy(np.asarray(y, np.float64)))
        if not self.graphed:
            return _host(self._fused())
        if self.graph is None:
            self._capture()
        self.graph.replay()
        nk.count_replay(self.launches)
        return _host(self.out)

    def precond_apply(self, y: np.ndarray) -> np.ndarray:
        return _host(self.precond.apply(self.problem.to_device(y),
                                        self.inv_dt, self.inv_hlam))


def _gmres(matvec, precond, rhs, k, tol):
    """Right-preconditioned GMRES(k) with the Arnoldi basis on the host.

    ``matvec(y) -> (I/dt - J) P^{-1} y`` and ``precond(y) -> P^{-1} y``
    take and return host float64 vectors (each runs on the device and is
    read back once). Modified Gram-Schmidt, a least-squares check every
    10th column, and an exit on a non-finite matvec. Returns the
    UNpreconditioned update delta = P^{-1} (Q y*), the relative residual
    and the vectors used. The basis is stored one vector a row."""
    n = rhs.shape[0]
    Q = np.zeros((k + 1, n))
    H = np.zeros((k + 1, k))
    beta = float(np.linalg.norm(rhs))
    Q[0] = rhs / beta
    used = k
    rel = 1.0
    for j in range(k):
        w = np.array(matvec(Q[j]), np.float64)
        if not np.all(np.isfinite(w)):
            # a diverged inner solve must not poison H (lstsq would raise)
            used = max(j, 1)
            break
        for i in range(j + 1):
            H[i, j] = w @ Q[i]
            w -= H[i, j] * Q[i]
        H[j + 1, j] = np.linalg.norm(w)
        if H[j + 1, j] < 1e-14:
            used = j + 1
            break
        Q[j + 1] = w / H[j + 1, j]
        if (j + 1) % 10 == 0 or j == k - 1:
            e1 = np.zeros(j + 2)
            e1[0] = beta
            yk, *_ = np.linalg.lstsq(H[:j + 2, :j + 1], e1, rcond=None)
            rel = np.linalg.norm(H[:j + 2, :j + 1] @ yk - e1) / beta
            if rel < tol:
                used = j + 1
                break
    e1 = np.zeros(used + 1)
    e1[0] = beta
    yk, *_ = np.linalg.lstsq(H[:used + 1, :used], e1, rcond=None)
    rel = float(np.linalg.norm(H[:used + 1, :used] @ yk - e1) / beta)
    delta = np.asarray(precond(Q[:used].T @ yk), np.float64)
    return delta, rel, used


def ptc_solve(problem: _SteadyProblem, precond: _StokesPreconditioner,
              x0: np.ndarray, *, tol_rms: float, max_steps: int,
              gmres_vectors: int, dt0: float, dt_max: float,
              history: dict | None = None, conserved=None,
              stats: dict | None = None):
    """Run the PTC loop from x0 (host float64). Returns (x, converged,
    diverged, steps) with x on the host.

    ``history``: optional dict of lists receiving one row per ACCEPTED
    Newton step (rel_iter / u_eq / v_eq / continuity / energy / enstrophy /
    palinstrophy -- the runner's history contract). ``conserved(x)`` maps
    an unknown vector to the three conserved quantities. ``stats``, when
    given, receives the GMRES vectors of every attempted step
    (``"gmres_vectors"``) and the residual evaluations (``"F_evals"``).

    The line search is NONMONOTONE (accept when ||F|| beats the worst of
    the last 5 accepted values): a pseudo-time trajectory is not a descent
    path for ||F||, and near unstable steady states it must climb
    transiently. If even that fails at the dt floor, the escape takes the
    damped step and re-ramps from dt0.
    """
    x = np.array(x0, np.float64)
    rms = 1.0 / np.sqrt(problem.n_tot)
    matvec = _Matvec(problem, precond)
    nF_window = deque(maxlen=5)  # nonmonotone reference values
    if stats is not None:
        stats.setdefault("gmres_vectors", [])
        stats.setdefault("F_evals", 0)

    def F_host(x_):
        if stats is not None:
            stats["F_evals"] += 1
        return _host(problem.F(x_))

    Fk = F_host(x)
    nF = float(np.linalg.norm(Fk))
    nF_window.append(nF)
    dt = float(dt0)
    dt_floor = 1e-4 * float(dt0)
    converged = diverged = False
    steps = 0
    for k in range(max_steps):
        if not np.isfinite(nF):
            diverged = True
            break
        if nF * rms <= tol_rms:
            converged = True
            break
        matvec.set_step(x, 1.0 / dt)
        delta, rel, used = _gmres(matvec, matvec.precond_apply, Fk,
                                  gmres_vectors, tol=1e-4)
        if stats is not None:
            stats["gmres_vectors"].append(used)
        nF_ref = max(nF_window)
        step_len = 1.0
        for _ in range(8):
            x_try = x + step_len * delta
            F_try = F_host(x_try)
            nF_try = float(np.linalg.norm(F_try))
            if np.isfinite(nF_try) and nF_try < nF_ref:
                break
            step_len *= 0.5
        else:
            if dt <= dt_floor and np.isfinite(nF_try):
                # dt-floor escape: one damped physical marching step
                # (backward Euler at tiny dt IS the flow), then re-ramp
                log.info("PTC step %d: nonmonotone escape at dt floor "
                         "(||F|| %.3e -> %.3e)", k, nF, nF_try)
                dt = float(dt0)
            else:
                dt = max(dt * 0.2, dt_floor)
                log.info("PTC step %d: line search failed; dt -> %.2e",
                         k, dt)
                continue
        # only ACCEPTED steps count (and emit a history row), so
        # len(history) == steps always holds
        steps += 1
        dx_rel = float(np.linalg.norm(step_len * delta) /
                       max(np.linalg.norm(x), 1e-300))
        x, Fk, nF = x_try, F_try, nF_try
        nF_window.append(nF)
        if history is not None:
            r_u, r_v, r_p = problem.unflatten(Fk)
            history["rel_iter"].append(dx_rel)
            history["u_eq"].append(float(np.linalg.norm(r_u)))
            history["v_eq"].append(float(np.linalg.norm(r_v)))
            history["continuity"].append(float(np.linalg.norm(r_p)))
            if conserved is not None:
                e, z, pal = conserved(x)
                history["energy"].append(e)
                history["enstrophy"].append(z)
                history["palinstrophy"].append(pal)
        log.info("PTC %d: ||F||_rms %.3e dt %.2e gmres(rel %.1e, %d vec) "
                 "step %g", k, nF * rms, dt, rel, used, step_len)
        # switched-evolution relaxation: geometric ramp on full steps
        dt = min(dt * 3.0, dt_max) if step_len == 1.0 else dt * 0.5
    if nF * rms <= tol_rms:
        converged = True
    return x, converged, diverged, steps


def _conserved_fn(problem: _SteadyProblem):
    """x -> (energy, enstrophy, palinstrophy) as floats, one host read."""
    def conserved(x):
        s = problem.x_to_state(x)
        q = core.conserved_quantities(problem.ops, s.u, s.v)
        return tuple(float(a) for a in torch.stack(q).tolist())

    return conserved


def polish_state(params, state: core.SpectralState, *, tol_rms: float,
                 max_steps: int, gmres_vectors: int,
                 history: dict | None = None):
    """Float64 Newton polish of a (possibly float32) marched state.

    The marched solvers stop at their float32 criterion floors; a few PTC
    steps from their final state land on the EXACT discrete steady state.
    The float64 operators are built on the state's device.
    Returns ``(state64, converged, diverged, steps, final_rms)``. The start
    is already near-steady, so dt0 = 1.0 (SER ramps from there).
    """
    device = state.u.device
    ops, grid = core.build_spectral_ops(params, dtype=torch.float64,
                                        device=device)
    problem = _SteadyProblem(ops)
    precond = _StokesPreconditioner(
        problem, grid, schur_iters=int(params.newton_schur_iters))
    st = core.SpectralState(*(t.to(device=device, dtype=torch.float64)
                              for t in state))
    x0 = _host(problem.state_to_x(st))
    x, converged, diverged, steps = ptc_solve(
        problem, precond, x0, tol_rms=tol_rms, max_steps=max_steps,
        gmres_vectors=gmres_vectors, dt0=1.0,
        dt_max=float(params.newton_dt_max), history=history,
        conserved=_conserved_fn(problem) if history is not None else None)
    final_rms = float(np.linalg.norm(_host(problem.F(x)))
                      / np.sqrt(problem.n_tot))
    return problem.x_to_state(x), converged, diverged, steps, final_rms


class NewtonSolver(SGSolver):
    """Steady-state spectral solver (PTC Newton-GMRES).

    Drop-in for SGSolver/FSGSolver: the same Metrics/TimeSeries/Fields
    contract, every corner treatment (including ``singular``), any
    Chebyshev grid size. ``tolerance`` is the RMS norm of the STEADY
    residual F (momentum + beta^2-scaled continuity), a statement about the
    discrete steady state much stronger than the marched solvers' iterate
    change at the same value. ``max_iter`` is ignored: the PTC budget is
    ``newton_max_steps``.

    Cold starts work at moderate Re; at high Re warm-start by
    ``newton_prelude`` marched RK4 steps (the SG kernels on CUDA) or
    ``initial_state_path`` (npz with u, v, p, e.g. one of
    ``data/steady/sharp_Re*_N128.npz`` for Re-continuation). The solve runs
    in float64 whatever ``dtype`` asks.
    """

    Parameters = SpectralParameters
    SUPPORTS_SPATIAL_MESH = False

    def __init__(self, params=None, **kwargs):
        # Newton to ||F||_rms ~ 1e-6..1e-12 requires float64 end to end
        if params is not None:
            params.dtype = "float64"
        elif str(kwargs.get("dtype", "auto")).lower() != "float64":
            kwargs["dtype"] = "float64"
        super().__init__(params=params, **kwargs)
        # the last solve's GMRES vectors a step and residual evaluations
        self.newton_stats: dict = {}

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        p = self.params
        tol = p.tolerance if tolerance is None else tolerance
        t0 = time.time()
        problem = _SteadyProblem(self.ops)
        precond = _StokesPreconditioner(problem, self.grid,
                                        schur_iters=p.newton_schur_iters)

        state = self._initial_newton_state()
        if p.newton_prelude > 0:
            state = self._march_prelude(state, int(p.newton_prelude))
        x0 = _host(problem.state_to_x(state))

        # FD sanity of the linearization once per solve (catches a wrong
        # jvp before 40 GMRES cycles trust it)
        rng = np.random.default_rng(0)
        t = rng.standard_normal(problem.n_tot) * 1e-7
        fd = (_host(problem.F(x0 + t)) - _host(problem.F(x0 - t))) / 2.0
        an = _host(problem.jvp(x0, t))
        jvp_rel = float(np.linalg.norm(fd - an) /
                        max(np.linalg.norm(an), 1e-300))
        if jvp_rel > 1e-5:
            log.warning("Jacobian-vector FD check poor: rel %.2e", jvp_rel)

        conserved = _conserved_fn(problem)
        history = {k: [] for k in METRIC_KEYS}
        self.newton_stats = {}
        x, converged, diverged, steps = ptc_solve(
            problem, precond, x0,
            tol_rms=tol, max_steps=int(p.newton_max_steps),
            gmres_vectors=int(p.gmres_vectors),
            dt0=float(p.newton_dt0), dt_max=float(p.newton_dt_max),
            history=history, conserved=conserved, stats=self.newton_stats)

        self.state = problem.x_to_state(x)
        if not history["rel_iter"]:  # converged before the first step
            r_u, r_v, r_p = problem.unflatten(_host(problem.F(x)))
            e, z, pal = conserved(x)
            history["rel_iter"].append(0.0)
            history["u_eq"].append(float(np.linalg.norm(r_u)))
            history["v_eq"].append(float(np.linalg.norm(r_v)))
            history["continuity"].append(float(np.linalg.norm(r_p)))
            history["energy"].append(e)
            history["enstrophy"].append(z)
            history["palinstrophy"].append(pal)
        result = IterationResult(
            state=self.state, iterations=steps, converged=bool(converged),
            diverged=bool(diverged), wall_time=time.time() - t0,
            history=history)
        self._store_results(result)
        log.info("Newton steady solve: %d PTC steps, converged=%s (%.2fs)",
                 steps, converged, result.wall_time)

    # -- warm starts -----------------------------------------------------

    def _initial_newton_state(self) -> core.SpectralState:
        path = str(getattr(self.params, "initial_state_path", "") or "")
        if not path:
            return self.state
        d = np.load(Path(path))
        nf = self.ops.nf
        shapes = {"u": (nf, nf), "v": (nf, nf), "p": (nf - 2, nf - 2)}
        for key, want in shapes.items():
            if d[key].shape != want:
                raise ValueError(
                    f"initial_state_path field '{key}' has shape "
                    f"{d[key].shape}, does not match {want} for N={nf - 1}; "
                    f"prolongate/restrict it first ({path})")
        log.info("Newton warm start from %s", path)
        return core.state_from_numpy((d["u"], d["v"], d["p"]), self.device,
                                     torch.float64)

    def _march_prelude(self, state, n_steps: int) -> core.SpectralState:
        """A short RK4/AC march to pass the impulsive-start transient: the
        solver's step path (the SG step kernel on CUDA, the plain step on
        the CPU), ``n_steps`` times."""
        log.info("Newton prelude: %d marched RK4 steps", n_steps)
        step, _ = self._paths(self.ops)
        for _ in range(int(n_steps)):
            state = step(state)[0]
        return state
