"""Spectral solver classes of the port: single-grid (SG) and FSG multigrid.

The counterparts of ``anap3_tpu/models/spectral.py``: thin hosts around the
core in ``spectral_sg.py``. On CUDA every level runs the hand-written SG
kernels (``ops/sg_kernels.py``): one step wrapper and one chunk runner for
every N up to ``sg_kernels.MAX_KERNEL_N`` = 767, where the TPU package
picks among aligned, tiled and whole-step Pallas tiers by VMEM budget. A
level above that order runs the plain step, by design and by order alone
(the JAX package likewise runs its XLA step above ``MAX_TILED_N``); the
routing logs once per order. A kernel launch that fails raises: it never
falls back to the plain step. The FSG solve is the nested coarse-to-fine
iteration of the JAX package: a Pe-floored coarsest level, per-level
tolerance, spectral prolongation with BC re-enforcement, the NaN exit and
the synthesized one-row history.

``newton_polish=true`` ends every SG, FSG (and VMG/FMG) solve with the
float64 Newton polish of ``models/steady.py``; ``checkpoint_dir`` saves
and resumes an SG solve through ``utils/checkpoint.py`` (the JAX package
checkpoints no FSG, VMG or FMG level, and neither does the port).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from . import spectral_sg as core
from .base import CavitySolver
from .params import Fields, SpectralParameters
from .runner import (ENERGY_PLATEAU_CHUNKS, METRIC_KEYS, WARMUP_ITERS,
                     IterationResult, run_fixed_point)
from ..ops import basis as basis_ops
from ..ops.poisson import spectral_dirichlet_poisson
from ..ops.sg_kernels import (ALIGNED_METRICS_EVERY, MAX_KERNEL_N, MAX_X1_N,
                              make_sg_chunk_runner, make_sg_step,
                              x1_supported)
from ..ops.singular import eval_singular_uv, singular_min_n
from ..ops.transfer import (make_level_transfer_matrices,
                            nodal_interpolation_matrix)
from ..analysis.vortex import solve_streamfunction
from ..utils.profiling import span

log = logging.getLogger(__name__)

__all__ = ["SGSolver", "FSGSolver", "make_fused_paths", "effective_chunk",
           "scaled_plateau_chunks", "resolve_convergence_metric",
           "default_coarsest_n", "fsg_level_orders", "prolongate",
           "MAX_FUSED_N", "FSG_COARSEST_N"]

# "auto" resolves to the energy-plateau criterion from this order upward
# (rel-iter false-converges there; anap3_tpu/models/spectral.py)
AUTO_ENERGY_MIN_N = 128
# the FSG coarsest level keeps its cell Peclet number within this bound
# (anap3_tpu/models/spectral_vmg.py PE_COARSEST_MAX)
PE_COARSEST_MAX = 110.0
# matmul_algorithm=x6 routes orders up to this one, smoothed lids, to the
# contract of the x6 whole-step and chunk kernels (anap3_tpu/ops/
# pallas_step.py, pallas_chunk.py: MAX_FUSED_N): quadratures every step
MAX_FUSED_N = 192
# the reference's coarsest FSG order
FSG_COARSEST_N = 12


def resolve_convergence_metric(params, n: Optional[int] = None,
                               auto_large: str = "energy") -> str:
    """Resolve the ``convergence_metric`` knob: "auto" is ``auto_large``
    (energy) at N >= AUTO_ENERGY_MIN_N and the reference's rel_iter below;
    explicit criteria are returned as they are."""
    m = str(getattr(params, "convergence_metric", "rel_iter") or "rel_iter")
    if m != "auto":
        return m
    n = int(getattr(params, "nx", 0) if n is None else n)
    return auto_large if n >= AUTO_ENERGY_MIN_N else "rel_iter"


def scaled_plateau_chunks(n: int, chunk: int, anchor_n: int = 96,
                          anchor_window: int = 6000) -> int:
    """The energy-plateau window in chunks, grown as (n/anchor_n)^2 steps
    (dt ~ 1/N^2) so its physical duration does not shrink with N."""
    window = anchor_window * (max(int(n), anchor_n) / anchor_n) ** 2
    return max(ENERGY_PLATEAU_CHUNKS,
               int(np.ceil(window / max(int(chunk), 1))))


def effective_chunk(chunk_runner_factory, requested: int) -> int:
    """The chunk length to book with run_fixed_point: a factory may cap it
    with ``max_chunk``. The SG kernels take any chunk."""
    mc = getattr(chunk_runner_factory, "max_chunk", None)
    return int(requested) if not mc else min(int(requested), int(mc))


def default_coarsest_n(Re: float) -> int:
    """Coarsest order whose cell Peclet number stays within
    PE_COARSEST_MAX."""
    return max(12, int(np.ceil(float(Re) * np.pi / (2.0 * PE_COARSEST_MAX))))


def fsg_level_orders(params) -> list:
    """The FSG ladder, coarsest first: ``params.n_levels`` halvings of the
    fine order, stopped above the coarsest-level floor. The floor is the
    reference's order 12, raised by the cell-Peclet bound at high Re and,
    in singular mode, by the sharp-lid cold-start floor (the coarsest level
    starts from rest)."""
    floor = max(FSG_COARSEST_N, default_coarsest_n(float(params.Re)))
    if str(params.corner_treatment).lower() == "singular":
        floor = max(floor, singular_min_n(params.Re))
    orders = []
    n = int(params.nx)
    for _ in range(int(params.n_levels)):
        orders.append(n)
        if n // 2 < floor:
            break
        n = n // 2
    return orders[::-1]


def prolongate(params, state, n_coarse: int, n_fine: int, ops_fine):
    """Coarse -> fine transfer of one state with BC re-enforcement: the
    configured (DCT/polynomial) operator on the full grids, exact nodal
    interpolation on the inner pressure grid, as 2-D products in the
    working dtype. The FSG solver and the batched FSG sweep (lane by lane)
    share it, so a sweep lane repeats its single solve bit for bit."""
    bx = basis_ops.make_basis(params.basis_type, (0.0, params.Lx))
    P_full, _ = make_level_transfer_matrices(
        bx.nodes(n_coarse + 1), bx.nodes(n_fine + 1),
        params.prolongation_method, params.restriction_method,
        chebyshev=str(params.basis_type).lower().startswith("cheb"))
    P_inner = nodal_interpolation_matrix(
        bx.nodes(n_coarse + 1)[1:-1], bx.nodes(n_fine + 1)[1:-1])
    as_t = lambda a: torch.as_tensor(a, dtype=ops_fine.dtype,
                                     device=ops_fine.device)
    Pf, Pi = as_t(P_full), as_t(P_inner)
    u = Pf @ state.u @ Pf.T
    v = Pf @ state.v @ Pf.T
    p = Pi @ state.p @ Pi.T
    u, v = core.enforce_bc(ops_fine, u, v)
    return core.SpectralState(u, v, p)


def _matmul_policy(params, x1_runs: bool = True) -> None:
    """Check ``matmul_algorithm`` for a solve on the kernels. x1 (one bf16
    tensor-core pass) is float32 only, as the Pallas kernel that has it:
    under float64 it raises where x1 would run (``x1_runs``)."""
    alg = str(getattr(params, "matmul_algorithm", "auto") or "auto").lower()
    if alg not in ("auto", "x1", "x3", "x6"):
        raise ValueError(f"unknown matmul_algorithm {alg!r}")
    if alg == "x1" and x1_runs:
        if str(params.dtype) != "float32":
            raise ValueError(
                f"matmul_algorithm=x1 runs in float32 only (the bf16 "
                f"tensor-core kernels), not {params.dtype}")
        log.info("matmul_algorithm=x1: the SG chunks of the aligned orders "
                 "(N %% 8 == 0, 32 <= N <= %d) run one bf16 tensor-core "
                 "pass a product; the step and other orders exact FMA "
                 "products", MAX_X1_N)
        return
    log.info("matmul_algorithm=%s: the SG kernels run exact FMA products "
             "in %s", alg, params.dtype)


_PLAIN_ORDERS_LOGGED = set()


def make_fused_paths(ops, matmul_algorithm: str = "auto"):
    """``(step, chunk_runner_factory)`` of the SG kernels for this level.

    One step kernel and one chunk kernel serve every N up to MAX_KERNEL_N,
    where the JAX package picks a Pallas tier by N, lid mode and matmul
    algorithm. Above MAX_KERNEL_N the level takes the plain step and no
    chunk runner (``(step, None)``), by design, as JAX takes its XLA step
    above its Pallas tiers; the routing logs once per order. Only
    the chunk's quadrature cadence follows the JAX routing
    (``anap3_tpu/models/spectral.py:make_fused_paths``): every step for
    ``matmul_algorithm=x6`` at N <= MAX_FUSED_N with a smoothed lid (the x6
    chunk kernel's rows), else every ALIGNED_METRICS_EVERY-th step. The x6
    chunk kernel takes rel_iter only and JAX runs the residual criterion
    per step there; the port's chunk kernel takes both.

    ``matmul_algorithm=x1`` routes as JAX does: the chunk runner of an
    ``x1_supported`` order (JAX's aligned tier, either lid) runs the x1
    kernels; the step keeps the exact products (JAX's per-step fallback
    keeps x3); any other order logs JAX's warning and runs the exact
    kernels. ``auto`` never selects x1."""
    n = ops.nf - 1
    if n > MAX_KERNEL_N:
        if n not in _PLAIN_ORDERS_LOGGED:
            _PLAIN_ORDERS_LOGGED.add(n)
            log.info("SG N=%d is above the kernels' largest order %d: the "
                     "level runs the plain step", n, MAX_KERNEL_N)
        return (lambda s: core.sg_step(ops, s)), None
    step = make_sg_step(ops)
    alg = str(matmul_algorithm or "auto").lower()
    if alg == "x1" and not x1_supported(n):
        if ops.singular:
            log.warning("matmul_algorithm=x1 covers only the aligned tier; "
                        "singular N=%d runs x3", n)
        else:
            log.warning("matmul_algorithm=x1 covers only the aligned tier "
                        "(N %% 8 == 0, 32 <= N <= 320); N=%d runs x3", n)
        alg = "x3"
    m_every = ALIGNED_METRICS_EVERY
    if alg == "x6" and ops.nf - 1 <= MAX_FUSED_N and not ops.singular:
        m_every = 1

    def factory(chunk, tol_, metric_):
        return make_sg_chunk_runner(ops, chunk, tol_, WARMUP_ITERS,
                                    convergence_metric=metric_,
                                    metrics_every=m_every, x1=alg == "x1")

    return step, factory


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


class SGSolver(CavitySolver):
    """Single-grid PN-PN-2 artificial-compressibility solver.

    Setting ``spatial_mesh`` to a mesh with an ``"x"`` dimension (a
    ``DeviceMesh``, see ``parallel/spatial.py``) before ``solve()`` runs
    the x-sharded solve over its ranks, as the JAX package's
    ``_solve_sharded`` does; FSG, VMG and FMG stay unsharded, as there."""

    Parameters = SpectralParameters
    # False although the SG solve takes a mesh: main.py:244-254 hands a
    # solver that claims it a JAX Mesh from anap3_tpu.parallel.spatial,
    # which this solver cannot use; the port's mesh is set directly.
    SUPPORTS_SPATIAL_MESH = False
    # the port's driver (anap3_tpu_torch/main.py) sets ``spatial_mesh`` on
    # a solver whose class says True (machine.mesh_axes: [x])
    TAKES_SPATIAL_MESH = True

    def __init__(self, params=None, **kwargs):
        super().__init__(params=params, **kwargs)
        self.ops, self.grid = core.build_spectral_ops(self.params,
                                                      device=self.device)
        self.state = core.initial_state(self.ops)
        self._psi_poisson = None
        self._polish_info = None
        # the mesh of ONE x-sharded solve (parallel/spatial.py)
        self.spatial_mesh = None

    def _is_singular(self) -> bool:
        return self.grid.get("singular") is not None

    def _kernels_enabled(self) -> bool:
        """``use_pallas`` keeps its meaning: auto = the kernels on CUDA and
        the plain step on the CPU; true/false force the fused wrappers
        (plain on CPU tensors) or the plain step."""
        flag = self._use_pallas_flag()
        return self.device.type == "cuda" if flag is None else flag

    def _paths(self, ops, exact: bool = False):
        """The level's step and chunk-runner factory; ``exact`` keeps the
        exact products under x1 (a stage that JAX runs on its XLA step)."""
        if self._kernels_enabled():
            alg = str(self.params.matmul_algorithm or "auto").lower()
            return make_fused_paths(ops, "x3" if exact and alg == "x1"
                                    else alg)
        return (lambda s: core.sg_step(ops, s)), None

    def _check_options(self, x1_runs: bool = True) -> None:
        """``x1_runs``: False on paths that never take x1 (sweeps, the
        V-cycles), where it is not checked against the dtype."""
        if self._kernels_enabled():
            _matmul_policy(self.params, x1_runs)

    def _stall_chunks(self) -> int:
        sc = int(self.params.stall_chunks)
        return sc if sc > 0 else 0

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        tol = self.params.tolerance if tolerance is None else tolerance
        max_iter = self.params.max_iterations if max_iter is None else max_iter
        self._check_options()
        if self.spatial_mesh is not None:
            if self._is_singular():
                raise ValueError(
                    "tensor-parallel sharding (spatial_mesh) does not "
                    "support corner_treatment=singular yet; run unsharded "
                    "or use a regularized lid")
            return self._solve_sharded(tol, max_iter)
        if self._is_singular():
            floor = singular_min_n(self.params.Re)
            if int(self.params.nx) < floor:
                log.warning(
                    "corner_treatment=singular at N=%d is below the "
                    "measured cold-start stability floor N>=%d for Re=%g; "
                    "expect divergence unless warm-started",
                    self.params.nx, floor, self.params.Re)
        metric = resolve_convergence_metric(self.params)
        with span("level.setup"):
            step, chunk_runner = self._paths(self.ops)
            ckpt_mgr, start_iter = self._restore_checkpoint()
        chunk_eff = effective_chunk(chunk_runner, self.params.chunk_size)
        result = run_fixed_point(
            step, lambda s: (s.u, s.v), self.state,
            tolerance=tol, max_iterations=max_iter, chunk=chunk_eff,
            log_callback=self._log_callback,
            checkpoint_mgr=ckpt_mgr, start_iteration=start_iter,
            convergence_metric=metric, chunk_runner=chunk_runner,
            stall_chunks=self._stall_chunks(),
            energy_plateau_chunks=scaled_plateau_chunks(
                int(self.params.nx), chunk_eff))
        if result.stalled:
            log.warning(
                "Convergence stalled above tolerance %.1e after %d "
                "iterations (float32 criterion floor); stopping with the "
                "best attainable state.", tol, result.iterations)
        self.state = result.state
        result = self._maybe_newton_polish(result)
        self._store_results(result)

    def _solve_sharded(self, tol: float, max_iter: int) -> None:
        """The solve with rows split over ``spatial_mesh["x"]``.

        The chunk loop runs ``parallel.spatial.make_sharded_chunk_runner``
        (global reductions, the runner's criterion) on every rank with the
        same host decisions. A checkpoint is restored whole before the
        split, as in the JAX package; on save the fields are gathered and
        the group's rank 0 writes them. The final state is gathered on
        every rank."""
        from ..parallel import spatial

        mesh = self.spatial_mesh
        _, rank, world = spatial.mesh_axis(mesh, "x")
        nf = int(self.params.nx) + 1
        if nf % world:
            raise ValueError(
                f"grid rows ({nf}) must divide the x mesh axis ({world})")
        log.info("Sharded solve: N=%d over %d ranks (x axis)",
                 self.params.nx, world)
        whole_ops, _ = spatial.build_sharded_ops(
            self.params, dtype=self.ops.dtype, device=self.device)
        ops_sh = spatial.shard_ops(whole_ops, rank, world)
        whole = (self.state.u, self.state.v,
                 spatial.pad_pressure(self.state.p))
        ckpt_mgr, start_iter = None, 0
        if self.params.checkpoint_dir:
            ckpt_mgr = spatial.ShardedCheckpointManager(
                mesh, self.params.checkpoint_dir, self.params,
                every_chunks=self.params.checkpoint_every_chunks)
            whole, start_iter = ckpt_mgr.restore_or(whole)
            if start_iter:
                log.info("Resumed sharded solve from checkpoint at "
                         "iteration %d", start_iter)
        chunk = int(self.params.chunk_size)

        def runner_factory(chunk_, tol_, metric_):
            return spatial.make_sharded_chunk_runner(
                mesh, ops_sh, chunk_, tol_, WARMUP_ITERS,
                convergence_metric=metric_)

        result = run_fixed_point(
            None, lambda s: (s[0], s[1]), spatial.shard_state(mesh, whole),
            tolerance=tol, max_iterations=max_iter, chunk=chunk,
            log_callback=self._log_callback, checkpoint_mgr=ckpt_mgr,
            start_iteration=start_iter,
            convergence_metric=resolve_convergence_metric(self.params),
            chunk_runner=runner_factory, stall_chunks=self._stall_chunks(),
            energy_plateau_chunks=scaled_plateau_chunks(
                int(self.params.nx), chunk))
        u, v, p_pad = spatial.gather_state(mesh, result.state)
        self.state = core.SpectralState(
            u, v, spatial.unpad_pressure(p_pad).contiguous())
        result = dataclasses.replace(result, state=self.state)
        result = self._maybe_newton_polish(result)
        self._store_results(result)

    def _maybe_newton_polish(self, result: IterationResult) -> IterationResult:
        """Optional float64 Newton polish of the marched state.

        ``newton_polish=true``: after the march stops, a few PTC Newton
        steps (models/steady.py) drive the state to the EXACT discrete
        steady state (RMS steady residual <= newton_polish_tol), on the
        solver's device. The polish rows are appended to the history and
        the Metrics carry polish_steps / steady_residual_rms. The polished
        state is float64 whatever the march's dtype."""
        flag = self.params.newton_polish
        on = flag if isinstance(flag, bool) else \
            str(flag).lower() in ("true", "1", "yes")
        if not on or result.diverged:
            return result
        from .steady import polish_state

        t0 = time.time()
        hist = {k: [] for k in METRIC_KEYS}
        state64, conv, div, steps, rms = polish_state(
            self.params, self.state,
            tol_rms=float(self.params.newton_polish_tol),
            max_steps=int(self.params.newton_polish_steps),
            gmres_vectors=int(self.params.gmres_vectors), history=hist)
        wall = time.time() - t0
        log.info("Newton polish: %d PTC steps, ||F||_rms=%.2e, "
                 "converged=%s (%.1fs)", steps, rms, conv, wall)
        self.state = state64
        self._polish_info = {"steps": steps, "rms": rms, "wall": wall,
                             "converged": bool(conv)}
        for key, rows in hist.items():
            if rows and key in result.history and \
                    result.history[key] is not None:
                result.history[key].extend(rows)
        history_iters = getattr(result, "history_iters", None)
        if history_iters is not None and steps > 0:
            # keep the row <-> global-iteration alignment: polish rows
            # follow the march
            result = dataclasses.replace(
                result, history_iters=np.concatenate([
                    np.asarray(history_iters),
                    result.iterations + 1 + np.arange(steps)]))
        return dataclasses.replace(
            result, state=state64,
            converged=bool(result.converged or conv),
            diverged=bool(div),
            # a float32 criterion stall is moot once the polish converged
            stalled=bool(result.stalled and not conv),
            wall_time=result.wall_time + wall)

    def _analysis_ops(self) -> core.SpectralOps:
        """The operators in the state's dtype: a float64 polish of a
        float32 march leaves a float64 state beside float32 operators, and
        the analysis then takes float64 operators of the same grid."""
        if self.state.u.dtype == self.ops.dtype:
            return self.ops
        return core.build_spectral_ops(self.params, dtype=self.state.u.dtype,
                                       device=self.device)[0]

    # -- field plumbing --------------------------------------------------

    def _final_fields(self) -> Fields:
        X, Y = np.meshgrid(self.grid["x_nodes"], self.grid["y_nodes"],
                           indexing="ij")
        u, v, p_inner = (_np(t) for t in self.state)
        S = self.grid.get("singular")
        if S is not None:
            # exported fields are the TOTAL solution (remainder + analytic
            # corner flow; p_s = nu * p_over_nu on the inner grid)
            u = u + S["u"]
            v = v + S["v"]
            p_inner = p_inner + float(1.0 / self.params.Re) * \
                S["p_over_nu"][1:-1, 1:-1]
        p_full = core.extrapolate_inner_to_full(
            torch.as_tensor(p_inner)).numpy()
        return Fields(u=u.ravel(), v=v.ravel(), p=p_full.ravel(),
                      x=X.ravel(), y=Y.ravel())

    def _vorticity_full(self) -> np.ndarray:
        return _np(core.vorticity(self._analysis_ops(), self.state.u,
                                  self.state.v))

    def _streamfunction(self):
        if self._psi_poisson is None:
            self._psi_poisson = spectral_dirichlet_poisson(
                self.grid["Dxx"], self.grid["Dyy"], dtype=self.state.u.dtype,
                device=self.device)
        X, Y = np.meshgrid(self.grid["x_nodes"], self.grid["y_nodes"],
                           indexing="ij")
        S = self.grid.get("singular")
        if S is None:
            psi = solve_streamfunction(self._psi_poisson,
                                       self._vorticity_full())
            return psi, X, Y
        # singular mode: psi = psi_tilde + psi_s with lap(psi_tilde) =
        # -omega_tilde and psi_tilde = -psi_s on the walls, lifted through
        # the Laplacian's boundary columns
        omega_t = _np(core.vorticity(self._analysis_ops(), self.state.u,
                                     self.state.v, total=False))
        psi_b = np.zeros_like(omega_t)
        bdy = np.ones_like(omega_t, dtype=bool)
        bdy[1:-1, 1:-1] = False
        psi_b[bdy] = -S["psi"][bdy]
        Dxx, Dyy = self.grid["Dxx"], self.grid["Dyy"]
        lift = Dxx @ psi_b + psi_b @ Dyy.T
        rhs = -omega_t[1:-1, 1:-1] - lift[1:-1, 1:-1]
        psi_t = psi_b.copy()
        psi_t[1:-1, 1:-1] = _np(self._psi_poisson.solve(rhs))
        return psi_t + S["psi"], X, Y

    def _evaluate_at_points(self, x: np.ndarray, y: np.ndarray):
        """Global 2-D polynomial evaluation at points: modal coefficients
        A = Vx^-1 U Vy^-T, values G = Px A Py^T on the grid of the points'
        unique coordinates (the truth grid's 128 x 128 for its 16,384
        points), gathered back to the points."""
        xn, yn = self.grid["x_nodes"], self.grid["y_nodes"]

        def to_ref(vals, nodes):
            lo, hi = nodes[0], nodes[-1]
            return 2.0 * (np.asarray(vals, dtype=float) - lo) / (hi - lo) - 1.0

        Vx = basis_ops.jacobi_vandermonde(to_ref(xn, xn))
        Vy = basis_ops.jacobi_vandermonde(to_ref(yn, yn))
        ux, ix = np.unique(np.ravel(x), return_inverse=True)
        uy, iy = np.unique(np.ravel(y), return_inverse=True)
        Px = basis_ops.jacobi_vandermonde(to_ref(ux, xn), degree=xn.size - 1)
        Py = basis_ops.jacobi_vandermonde(to_ref(uy, yn), degree=yn.size - 1)

        def eval_field(F):
            coeff = np.linalg.solve(Vx, np.linalg.solve(Vy, F.T).T)
            return (Px @ coeff @ Py.T)[ix, iy].reshape(np.shape(x))

        u_pts = eval_field(_np(self.state.u))
        v_pts = eval_field(_np(self.state.v))
        if self._is_singular():
            # the corner flow is evaluated analytically at the points
            us, vs = eval_singular_uv(
                np.asarray(x, float), np.asarray(y, float),
                lid_velocity=self.params.lid_velocity,
                Lx=self.params.Lx, Ly=self.params.Ly)
            u_pts = u_pts + us
            v_pts = v_pts + vs
        return u_pts, v_pts

    def _vorticity_for_export(self, U, V, x, y):
        """Spectral vorticity for VTS export. U, V arrive (ny, nx); the
        operators act on (x, y)-indexed arrays. In singular mode the
        exporter's totals are not spectrally differentiable: use the
        remainder plus the sampled singular vorticity."""
        if self._is_singular():
            return self._vorticity_full().T
        ops = self._analysis_ops()
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a.T),
                                         dtype=ops.dtype, device=self.device)
        return _np(core.vorticity(ops, as_t(U), as_t(V))).T


class FSGSolver(SGSolver):
    """Full-single-grid nested-iteration multigrid spectral solver."""

    TAKES_SPATIAL_MESH = False

    def _level_orders(self) -> list:
        return fsg_level_orders(self.params)

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        tol = self.params.tolerance if tolerance is None else tolerance
        max_iter = self.params.max_iterations if max_iter is None else max_iter
        self._check_options()
        orders = self._level_orders()
        log.info("FSG hierarchy: N = %s", orders)
        dtype = self.ops.dtype
        # resolved once from the fine order and applied to every level
        metric = resolve_convergence_metric(self.params)

        t0 = time.time()
        total_iters = 0
        converged = False
        diverged = False
        compile_time = 0.0
        state: Optional[core.SpectralState] = None
        prev_n = None
        # per-level record: order, iterations, converged, wall and
        # first-chunk seconds
        self.levels = []

        for level_idx, n in enumerate(orders):
            level_tol = tol * (self.params.coarse_tolerance_factor
                               ** (len(orders) - 1 - level_idx))
            with span("level.setup"):
                if n == int(self.params.nx):
                    ops = self.ops
                else:
                    ops, _ = core.build_spectral_ops(self.params, n=n,
                                                     device=self.device)
                step, chunk_runner = self._paths(ops)
                if state is None:
                    state = core.initial_state(ops)
            if prev_n is not None:
                with span("level.prolong"):
                    state = self._prolongate(state, prev_n, n, ops)
            chunk_eff = effective_chunk(chunk_runner, self.params.chunk_size)
            result = run_fixed_point(
                step, lambda s: (s.u, s.v), state,
                tolerance=level_tol, max_iterations=max_iter,
                chunk=chunk_eff,
                log_callback=self._log_callback
                if level_idx == len(orders) - 1 else None,
                convergence_metric=metric, chunk_runner=chunk_runner,
                energy_plateau_chunks=scaled_plateau_chunks(n, chunk_eff))
            state = result.state
            total_iters += result.iterations
            converged = result.converged
            diverged = result.diverged
            compile_time += result.first_chunk_time
            self.levels.append({
                "n": n, "iterations": result.iterations,
                "converged": result.converged,
                "wall_time": result.wall_time,
                "first_chunk_time": result.first_chunk_time})
            log.info("FSG level %d (N=%d): %d iters, converged=%s",
                     level_idx, n, result.iterations, converged)
            if diverged:
                log.warning("FSG level %d diverged (NaN/Inf); aborting",
                            level_idx)
                if n != int(self.params.nx):
                    # a fine-shaped NaN state, so the analysis sees a
                    # well-formed (diverged) solution
                    nf = int(self.params.nx) + 1
                    nan = lambda shape: torch.full(
                        shape, float("nan"), dtype=dtype, device=self.device)
                    state = core.SpectralState(nan((nf, nf)), nan((nf, nf)),
                                               nan((nf - 2, nf - 2)))
                break
            prev_n = n

        wall = time.time() - t0
        self.state = state
        # the reference's single-row history: final residuals and
        # quadratures, rel-iter placeholder at tol (10x tol unconverged)
        with span("solve.finish"):
            R_u, R_v, R_p = core.residuals(self.ops, state.u, state.v,
                                           state.p)
            energy, enstrophy, palinstrophy = core.conserved_quantities(
                self.ops, state.u, state.v)
            history = {
                "rel_iter": [tol if converged else tol * 10],
                "u_eq": [float(torch.linalg.norm(R_u))],
                "v_eq": [float(torch.linalg.norm(R_v))],
                "continuity": [float(torch.linalg.norm(R_p))],
                "energy": [float(energy)],
                "enstrophy": [float(enstrophy)],
                "palinstrophy": [float(palinstrophy)],
            }
        result = IterationResult(
            state=state, iterations=total_iters,
            converged=bool(converged and not diverged),
            diverged=bool(diverged), wall_time=wall, history=history,
            first_chunk_time=compile_time)
        result = self._maybe_newton_polish(result)  # sets self.state if on
        self._store_results(result)
        log.info("FSG completed in %.2fs: %d iterations, converged=%s",
                 wall, total_iters, converged)

    def _prolongate(self, state, n_coarse, n_fine, ops_fine):
        return prolongate(self.params, state, n_coarse, n_fine, ops_fine)
