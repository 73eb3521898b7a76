"""FAS V-cycle (VMG) and full-multigrid (FMG) spectral solvers of the port.

The counterpart of ``anap3_tpu/models/spectral_vmg.py``, with the same FAS
scheme (Zhang & Xi 2010) for the artificial-compressibility equations. Per
V-cycle on level h with coarse level H:

1. nu1 pre-smoothing RK4 steps with the level's tau forcing;
2. defect d_h = R_h(u_h) + tau_h, velocity defects zeroed on the boundary
   ring;
3. state restriction by injection, u_H0 = Inj u_h Inj^T, with the coarse
   BCs enforced;
4. tau_H = I_res(d_h) - R_H(u_H0) (spectral truncation for smoothed lids,
   nodal injection in singular mode);
5. recurse, or nu_coarse smoothing steps on the coarsest level;
6. correction u_h += P(u_H - u_H0) with the BCs re-enforced; a correction
   with a non-finite entry is dropped (on the device: no host sync);
7. nu2 post-smoothing steps.

One outer iteration of the solver is one V-cycle, driven by
``models/runner.run_fixed_point``. On CUDA every smoothing sweep is one
call of the SG kernels' smoothing loop (``ops/sg_kernels.make_sg_smoother``,
host entry ``sg_smooth_run``), at every level and every N; the transfers
and the defect are ``torch.matmul`` products in the working dtype, as they
are XLA products at HIGHEST precision in the JAX package. FMG is the FSG
nested iteration with each level solved by V-cycles over the hierarchy
below it.

On CUDA a cycle is captured into one CUDA graph at its second call and
replayed from then on (``CapturedCycle``): the same kernels in the same
order on the same buffers, so the same bits, from one host entry where the
eager cycle makes ~300 launches (at N=48 it was host-bound: ~3 ms of
dispatch against ~1.5 ms of device work a cycle on an H100 host).

Under a profiler each level of a cycle opens the spans of ``SPANS``
(``utils/profiling.span``): ``vmg.smooth`` around every smoothing sweep
(pre, post and coarsest), ``vmg.restrict`` around steps 2-4 (the defect,
the state injection with its BCs, the coarse defect and tau_H, a span of
the name each) and ``vmg.prolong`` around step 6 (the correction; its BCs
and the finite check). Each of these spans but a plain sweep holds under a
hundred of the profiler's host events (a kernel sweep is one host entry),
so a trace reader that looks back a bounded number of them (``ldc_bench``:
256) finds it. A captured cycle opens them while it is run eagerly and
captured (its first two calls), and not at a replay, which runs no host
code of the cycle.

Where the port differs from the JAX package (the reference faults of
ROADMAP Queue 3, fixed here):

- ``build_vmg_levels(orders=...)`` rejects repeated orders and an
  ``orders[0]`` other than the fine order;
- on non-nested Chebyshev ladders the inner (pressure) state restriction is
  exact polynomial resampling, as the full-grid one is, not nearest-node
  injection.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from . import spectral_sg as core
from .runner import IterationResult, run_fixed_point
from .spectral import (FSGSolver, PE_COARSEST_MAX, SGSolver,
                       default_coarsest_n, resolve_convergence_metric,
                       scaled_plateau_chunks)
from ..ops import sg_kernels
from ..ops.basis import make_basis
from ..ops.sg_kernels import MAX_KERNEL_N, make_sg_smoother, smooth_plain
from ..ops.transfer import (fft_restriction_matrix,
                            injection_restriction_matrix,
                            make_level_transfer_matrices,
                            modal_restriction_matrix, nodal_injection_matrix,
                            nodal_interpolation_matrix)
from ..utils.profiling import span

log = logging.getLogger(__name__)

__all__ = ["VMGSolver", "FMGSolver", "VmgLevel", "build_vmg_levels",
           "make_v_cycle", "levels_from_jax", "fas_coarsest_n",
           "cell_peclet", "check_fp32_matmul", "PE_COARSEST_MAX",
           "PE_FULL_CORRECTION", "FAS_RESOLUTION_COEFF",
           "VMG_AUTO_ENERGY_MIN_N", "VMG_COLD_START_MAX_N", "SPANS",
           "CapturedCycle"]


@dataclass
class VmgLevel:
    """Operators of one level plus the transfers to the next-coarser level
    (None on the coarsest level)."""

    n: int
    ops: core.SpectralOps
    inj_full: Optional[torch.Tensor] = None    # (nc+1, nf+1) state injection
    inj_inner: Optional[torch.Tensor] = None   # (nc-1, nf-1)
    res_full: Optional[torch.Tensor] = None    # (nc+1, nf+1) defect restriction
    res_inner: Optional[torch.Tensor] = None
    pro_full: Optional[torch.Tensor] = None    # (nf+1, nc+1) prolongation
    pro_inner: Optional[torch.Tensor] = None


_TRANSFERS = ("inj_full", "inj_inner", "res_full", "res_inner", "pro_full",
              "pro_inner")

# the spans a V-cycle opens at its phase boundaries (see the module note)
SPANS = ("vmg.smooth", "vmg.restrict", "vmg.prolong")

# Undamped corrections below this cell Peclet number (the JAX package's
# calibration, anap3_tpu/models/spectral_vmg.py; PE_COARSEST_MAX, the FSG
# cascade's bound, lives in models/spectral.py).
PE_FULL_CORRECTION = 15.0
# FAS resolution floor: every level must resolve the lid boundary layer,
# coarsest N >= 2.4 sqrt(Re) (measured brackets in the JAX module).
FAS_RESOLUTION_COEFF = 2.4
# "auto" criterion: per-cycle rel_iter below this fine N, the energy
# plateau from it on (and in singular mode at every N).
VMG_AUTO_ENERGY_MIN_N = 256
# Largest fine N whose rest-started V-cycles are validated to reach the
# physical steady state; above it the solver warm-starts itself.
VMG_COLD_START_MAX_N = 256


def cell_peclet(Re: float, n: int) -> float:
    """Cell Peclet number of a CGL grid of order n: Re pi / (2n)."""
    return float(Re) * np.pi / (2.0 * n)


def fas_coarsest_n(Re: float, singular: bool = False) -> int:
    """Coarsest order admissible in a FAS hierarchy at this Re:
    max(12, ceil(c sqrt(Re))), c = 2.4 (2.0 in singular mode)."""
    coeff = 2.0 if singular else FAS_RESOLUTION_COEFF
    return max(12, int(np.ceil(coeff * np.sqrt(float(Re)))))


def _warn_if_degenerate(levels, params) -> None:
    if len(levels) == 1:
        log.warning(
            "VMG/FMG hierarchy at N=%d, Re=%g has a single level: the FAS "
            "resolution floor (coarsest N >= %d ~ 2.4*sqrt(Re)) admits no "
            "coarser grid, so the solver degenerates to single-grid SG. "
            "Use a finer grid, or solver=gpu/fsg whose cascade tolerates "
            "coarser levels.",
            int(params.nx), float(params.Re), fas_coarsest_n(float(params.Re)))


def check_fp32_matmul(device: torch.device) -> None:
    """Raise unless float32 products on ``device`` run in full float32.

    The FAS tau cancellation needs the smoother's residual operator (the
    CUDA kernels, exact FMA products) and the defect operator
    (``core.residuals`` through ``torch.matmul``) to agree to the working
    dtype's rounding; a TF32 defect (~1e-3 relative) would inject noise
    every cycle (the JAX package measured the same failure with a 1.4e-5
    mismatch). The settings are the caller's: they are checked, not set."""
    if torch.device(device).type != "cuda":
        return
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError as exc:  # the legacy and new TF32 APIs were mixed
        raise RuntimeError(
            "VMG/FMG cannot tell whether float32 matmuls use TF32: "
            f"{exc}") from exc
    if torch.backends.cuda.matmul.allow_tf32 or precision != "highest":
        raise RuntimeError(
            "VMG/FMG and the FSG sweep's prolongations on CUDA need "
            "full-float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest') (found "
            f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
            f"precision={precision!r})")


def build_vmg_levels(params, n_fine: Optional[int] = None,
                     coarsest_n: Optional[int] = None,
                     orders: Optional[List[int]] = None,
                     device=None, dtype=None) -> List[VmgLevel]:
    """Hierarchy from FINE (index 0) to COARSE, with per-pair transfers
    built in float64 numpy and cast to ``dtype`` (default
    ``params.dtype``) on ``device`` (default ``params.device``).

    ``orders`` forces an explicit, strictly decreasing ladder starting at
    the fine order and bypasses the resolution floor (the floor-bracketing
    experiment hook); production callers get the floor-guarded halving
    ladder."""
    n_top = int(params.nx if n_fine is None else n_fine)
    if orders is not None:
        orders = [int(n) for n in orders]
        if any(a <= b for a, b in zip(orders, orders[1:])):
            raise ValueError(
                f"orders must be strictly decreasing, fine to coarse: "
                f"{orders}")
        if not orders or orders[0] != n_top:
            raise ValueError(
                f"orders must start at the fine order {n_top}: {orders}")
    singular = str(params.corner_treatment).lower() == "singular"
    if coarsest_n is None:
        coarsest_n = max(fas_coarsest_n(float(params.Re), singular),
                         default_coarsest_n(float(params.Re)))
    if orders is None:
        orders = []
        n = n_top
        for _ in range(int(params.n_levels)):
            orders.append(n)
            if n // 2 < coarsest_n:
                break
            n = n // 2

    dtype = getattr(torch, str(params.dtype)) if dtype is None else dtype
    device = torch.device(params.device if device is None else device)
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64),
                                     dtype=dtype, device=device)
    is_cheb = str(params.basis_type).lower().startswith("cheb")
    bx = make_basis(params.basis_type, (0.0, params.Lx))
    levels: List[VmgLevel] = []
    for idx, n in enumerate(orders):
        ops, _ = core.build_spectral_ops(params, n=n, dtype=dtype,
                                         device=device)
        level = VmgLevel(n=n, ops=ops)
        if idx + 1 < len(orders):
            nc = orders[idx + 1]
            x_f, x_c = bx.nodes(n + 1), bx.nodes(nc + 1)
            x_fi, x_ci = x_f[1:-1], x_c[1:-1]
            inj_inner = nodal_injection_matrix(x_fi, x_ci)
            if is_cheb and n % nc != 0:
                # CGL(nc) does not nest in CGL(n): exact polynomial
                # resampling restricts the state on both grids; spectral
                # truncation still restricts the defect
                if singular:
                    raise ValueError(
                        "singular-mode FAS needs NESTED levels (nodal "
                        "injection cancellation); use a halving ladder")
                inj_full = nodal_interpolation_matrix(x_f, x_c)
                inj_inner = nodal_interpolation_matrix(x_fi, x_ci)
                res_full = fft_restriction_matrix(n + 1, nc + 1)
            elif is_cheb:
                inj_full = injection_restriction_matrix(n + 1, nc + 1)
                # singular mode restricts the defect by injection: the
                # sampled 1/r corner constants of fine and coarse grids
                # coincide at the nested nodes and cancel in tau
                res_full = inj_full if singular else \
                    fft_restriction_matrix(n + 1, nc + 1)
            else:
                # LGL grids do not nest: exact resampling of the state,
                # Legendre-modal truncation of the defect
                inj_full = nodal_interpolation_matrix(x_f, x_c)
                res_full = modal_restriction_matrix(x_f, x_c)
            P_full, _ = make_level_transfer_matrices(
                x_c, x_f, params.prolongation_method,
                params.restriction_method, chebyshev=is_cheb)
            level.inj_full = cast(inj_full)
            level.res_full = cast(res_full)
            level.pro_full = cast(P_full)
            level.inj_inner = cast(inj_inner)
            level.res_inner = cast(nodal_interpolation_matrix(x_fi, x_ci))
            level.pro_inner = cast(nodal_interpolation_matrix(x_ci, x_fi))
        levels.append(level)
    return levels


def levels_from_jax(jax_levels, device, dtype) -> List[VmgLevel]:
    """The port's hierarchy from an ``anap3_tpu`` one (any objects with
    the VmgLevel attributes, leaves readable as numpy arrays), so both
    packages cycle on the same matrices."""
    device = torch.device(device)
    out = []
    for lv in jax_levels:
        level = VmgLevel(n=int(lv.n),
                         ops=core.ops_from_jax(lv.ops, device, dtype))
        for name in _TRANSFERS:
            a = getattr(lv, name, None)
            if a is not None:
                setattr(level, name, torch.as_tensor(
                    np.array(a, np.float64, order="C"), dtype=dtype,
                    device=device))
        out.append(level)
    return out


def _sandwich(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return A @ X @ A.T


# one capture stream a device: cuBLAS keeps a workspace (32 MiB on an
# H100) for every stream it has run on, for the life of the process
_CAPTURE_STREAMS = {}


def _capture_stream(device) -> torch.cuda.Stream:
    """The device's capture stream, its cuBLAS workspace set up by a
    product outside any capture."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _CAPTURE_STREAMS:
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            a = torch.ones((2, 2), device=device)
            a @ a
        torch.cuda.current_stream(device).wait_stream(stream)
        _CAPTURE_STREAMS[device] = stream
    return _CAPTURE_STREAMS[device]


def _counter_tables() -> tuple:
    """The SG kernels' counters that a cycle's smoothing sweeps add to."""
    return (sg_kernels.LAUNCHES, sg_kernels.PART_LAUNCHES,
            sg_kernels.PLAIN_CALLS, sg_kernels.STEPS,
            sg_kernels.SMOOTH_STEPS)


class CapturedCycle:
    """A cycle step ``state -> (state, metrics)`` replayed from one CUDA
    graph.

    The first call runs the step eagerly: it loads the kernels' library,
    allocates the smoothers' scratch and sets up cuBLAS on the stream. The
    second captures the step over static input buffers (a capture runs
    nothing), and it and every later call copy their state into the
    buffers, replay the graph and return copies of its outputs, so a
    returned state or metric outlives the next call. A replay enqueues the
    kernels of an eager step in the same order, with the same arguments,
    so it gives the same bits.

    The smoothing sweeps count their launches and steps in
    ``ops/sg_kernels``'s counters when they are called, which in a capture
    is once for all replays: the counts of the capture are taken back and
    added again at every replay, so the counters read as for eager
    cycles."""

    def __init__(self, step):
        self.step = step
        self.calls = 0
        self.graph = None
        self.inputs = self.out = self.metrics = None
        self.counts = ()

    def _capture(self, state) -> None:
        self.inputs = type(state)(*(torch.empty_like(t) for t in state))
        before = [dict(t) for t in _counter_tables()]
        graph = torch.cuda.CUDAGraph()
        stream = _capture_stream(state[0].device)
        stream.wait_stream(torch.cuda.current_stream(state[0].device))
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out, self.metrics = self.step(self.inputs)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(state[0].device).wait_stream(stream)
        counts = []
        for table, was in zip(_counter_tables(), before):
            counts.append({k: n - was.get(k, 0) for k, n in table.items()
                           if n != was.get(k, 0)})
            table.clear()
            table.update(was)
        self.counts = tuple(counts)
        self.graph = graph

    def __call__(self, state):
        self.calls += 1
        if self.calls == 1:
            return self.step(state)
        if self.graph is None:
            self._capture(state)
        for buf, t in zip(self.inputs, state):
            buf.copy_(t)
        self.graph.replay()
        for table, counts in zip(_counter_tables(), self.counts):
            for k, n in counts.items():
                table[k] = table.get(k, 0) + n
        values = torch.stack(tuple(self.metrics.values()))
        return (type(state)(*(t.clone() for t in self.out)),
                dict(zip(self.metrics, values.unbind())))


def make_v_cycle(levels: List[VmgLevel], nu1: int = 2, nu2: int = 2,
                 nu_coarse: int = 30, damping: float = 1.0,
                 smoothers: Optional[dict] = None):
    """The V-cycle step ``state -> (state, metrics)`` over ``levels`` (fine
    first); metrics are those of the fine level's last post-smoothing step.

    ``smoothers`` ({level index: smooth(state, tau, n_steps)}, from
    ``ops/sg_kernels.make_sg_smoother``) runs each sweep as one call of the
    kernels' smoothing loop; without it a sweep is the loop's plain version
    (``smooth_plain``, a loop of ``core.sg_step``). ``damping``
    under-relaxes the prolongated correction (an experiment hook;
    production cycles run at full strength). On a CUDA card the step is a
    ``CapturedCycle`` (its ``step`` the eager cycle)."""
    smoothers = smoothers or {}
    masks = [lv.ops.interior.to(lv.ops.dtype) for lv in levels]

    def smooth(idx, state, tau, n_steps):
        sm = smoothers.get(idx)
        with span("vmg.smooth"):
            if sm is not None:
                return sm(state, tau, n_steps)
            return smooth_plain(levels[idx].ops, state, tau, n_steps)

    def defect(level, state, tau):
        R = core.residuals(level.ops, state.u, state.v, state.p)
        if tau is not None:
            R = tuple(r + t for r, t in zip(R, tau))
        return R

    def restrict(idx, state, tau):
        """(coarse0, tau_H): steps 2-4 of the cycle at level ``idx``, in
        four spans of one name (each within a trace reader's reach)."""
        level, coarse = levels[idx], levels[idx + 1]
        with span("vmg.restrict"):
            d_u, d_v, d_p = defect(level, state, tau)
            # zero on the boundary ring
            d_u, d_v = d_u * masks[idx], d_v * masks[idx]
        with span("vmg.restrict"):
            u_H0, v_H0 = core.enforce_bc(
                coarse.ops, _sandwich(level.inj_full, state.u),
                _sandwich(level.inj_full, state.v))
            coarse0 = core.SpectralState(u_H0, v_H0,
                                         _sandwich(level.inj_inner, state.p))
        with span("vmg.restrict"):
            R_u0, R_v0, R_p0 = defect(coarse, coarse0, None)
        with span("vmg.restrict"):
            cmask = masks[idx + 1]
            tau_H = (_sandwich(level.res_full, d_u) * cmask - R_u0,
                     _sandwich(level.res_full, d_v) * cmask - R_v0,
                     _sandwich(level.res_inner, d_p) - R_p0)
        return coarse0, tau_H

    def prolong(idx, state, coarse0, coarse):
        """Step 6 of the cycle at level ``idx``, the corrected state, in
        two spans of one name."""
        level, mask = levels[idx], masks[idx]
        with span("vmg.prolong"):
            e_u = _sandwich(level.pro_full, coarse.u - coarse0.u)
            e_v = _sandwich(level.pro_full, coarse.v - coarse0.v)
            e_p = _sandwich(level.pro_inner, coarse.p - coarse0.p)
        with span("vmg.prolong"):
            u, v = core.enforce_bc(level.ops,
                                   state.u + damping * (e_u * mask),
                                   state.v + damping * (e_v * mask))
            p = state.p + damping * e_p
            # a tau-forced coarse level can blow up in the impulsive-start
            # transient; FAS re-injects a fresh coarse state every cycle,
            # so a non-finite correction is dropped (a device select, no
            # host sync) and the fine level keeps smoothing
            ok = (torch.isfinite(e_u).all() & torch.isfinite(e_v).all()
                  & torch.isfinite(e_p).all())
            return core.SpectralState(torch.where(ok, u, state.u),
                                      torch.where(ok, v, state.v),
                                      torch.where(ok, p, state.p))

    def cycle(idx, state, tau):
        if idx == len(levels) - 1:  # coarsest: just smooth
            return smooth(idx, state, tau, nu_coarse)
        state, _ = smooth(idx, state, tau, nu1)
        coarse0, tau_H = restrict(idx, state, tau)
        coarse, _ = cycle(idx + 1, coarse0, tau_H)
        state = prolong(idx, state, coarse0, coarse)
        return smooth(idx, state, tau, nu2)

    def v_cycle_step(state):
        return cycle(0, state, None)

    if levels[0].ops.device.type == "cuda":
        return CapturedCycle(v_cycle_step)
    return v_cycle_step


def _cycle_chunk(params) -> int:
    return max(1, min(50, int(params.chunk_size) // 4))


def _auto_criterion(params) -> bool:
    return str(getattr(params, "convergence_metric", "auto")) == "auto"


class VMGSolver(SGSolver):
    """FAS V-cycle multigrid solver; one outer iteration = one V-cycle."""

    TAKES_SPATIAL_MESH = False

    NU1 = 2
    NU2 = 2
    NU_COARSE = 30
    SUPPORTS_SPATIAL_MESH = False

    def _smoothers(self, levels) -> Optional[dict]:
        """The kernels' smoothing loop at every level up to the kernels'
        largest order (the JAX package's build_fused_tau_steps), or None
        for the plain step; a level above that order smooths with the plain
        step, as ``make_fused_paths`` routes it."""
        if not self._kernels_enabled():
            return None
        return {i: make_sg_smoother(lv.ops) for i, lv in enumerate(levels)
                if lv.ops.nf - 1 <= MAX_KERNEL_N}

    def _reject_singular(self) -> bool:
        """Singular-mode FAS runs on Chebyshev hierarchies only (nested
        nodes make the injected singular constants cancel in tau); other
        bases fall back to the single-grid solve."""
        if not self._is_singular():
            return False
        if str(self.params.basis_type).lower().startswith("cheb"):
            return False
        log.warning(
            "FAS V-cycle multigrid supports corner_treatment=singular only "
            "on Chebyshev hierarchies (nested grids make the injected "
            "singular constants cancel in tau); falling back to the "
            "single-grid solve for basis_type=%s.", self.params.basis_type)
        return True

    def _cold_start_warm_state(self, levels, tol, max_iter):
        """Nested-iteration warm start for cold solves above the validated
        ceiling: the FMG cascade over every level below the finest (each
        solved by V-cycles over its sub-hierarchy), then prolongation to
        the finest level. Returns ``(fine_state, total_sub_iterations)``."""
        coarse_to_fine = levels[::-1]
        state = None
        total = 0
        # singular cycles carry a per-cycle rel_iter noise floor: the
        # prelude levels use the energy plateau there too
        metric = resolve_convergence_metric(self.params, auto_large="rel_iter")
        if _auto_criterion(self.params) and self._is_singular():
            metric = "energy"
        reached = 0
        cyc_chunk = _cycle_chunk(self.params)
        for k, level in enumerate(coarse_to_fine[:-1]):
            reached = k
            sub_levels = levels[len(levels) - 1 - k:]
            level_tol = tol * (self.params.coarse_tolerance_factor
                               ** (len(coarse_to_fine) - 1 - k))
            if state is None:
                state = core.initial_state(level.ops)
            else:
                state = FMGSolver._prolongate_fmg(
                    self, coarse_to_fine[k - 1], level, state)
            warm = state  # finite by construction
            if len(sub_levels) > 1:
                step = make_v_cycle(sub_levels, self.NU1, self.NU2,
                                    self.NU_COARSE,
                                    smoothers=self._smoothers(sub_levels))
                chunk_runner = None
                budget = max(1, max_iter // (self.NU1 + self.NU2))
                window = scaled_plateau_chunks(
                    level.n, cyc_chunk, anchor_n=192, anchor_window=150)
            else:
                # the coarsest single-level stage: the SG chunk kernel
                step, chunk_runner = self._paths(level.ops, exact=True)
                budget = max_iter
                window = scaled_plateau_chunks(level.n, cyc_chunk)
            result = run_fixed_point(
                step, lambda s: (s.u, s.v), state,
                tolerance=level_tol, max_iterations=budget, chunk=cyc_chunk,
                convergence_metric=metric, chunk_runner=chunk_runner,
                energy_plateau_chunks=window)
            state = result.state
            total += int(result.iterations)
            log.info("warm-start level %d (N=%d): %d iterations, "
                     "converged=%s", k, level.n, result.iterations,
                     result.converged)
            if result.diverged:
                # the diverging step is committed, so the result can be
                # NaN: fall back to the level's finite warm start
                if not bool(torch.isfinite(result.state.u).all()):
                    state = warm
                log.warning("warm-start level %d (N=%d) diverged; "
                            "continuing with its last finite state",
                            k, level.n)
                break
        # prolongate from the last level reached through every remaining
        # transfer pair
        for j in range(reached + 1, len(coarse_to_fine)):
            state = FMGSolver._prolongate_fmg(
                self, coarse_to_fine[j - 1], coarse_to_fine[j], state)
        return state, total

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        # the warm-start prelude mirrors FMGSolver.solve's per-level
        # cascade with another divergence policy: change them together
        tol = self.params.tolerance if tolerance is None else tolerance
        max_iter = self.params.max_iterations if max_iter is None else max_iter
        self._check_options(x1_runs=False)
        check_fp32_matmul(self.device)
        if self._reject_singular():
            super().solve(tolerance=tol, max_iter=max_iter)
            return
        levels = build_vmg_levels(self.params, device=self.device)
        self.ladder = [lv.n for lv in levels]
        log.info("VMG hierarchy: N = %s (FAS floor %d for Re=%g), "
                 "full-strength corrections", [lv.n for lv in levels],
                 fas_coarsest_n(float(self.params.Re), self._is_singular()),
                 float(self.params.Re))
        _warn_if_degenerate(levels, self.params)
        if len(levels) == 1:
            # degenerate: the SG solve path (per-step criterion, the chunk
            # kernel, max_iterations as fine steps)
            super().solve(tolerance=tol, max_iter=max_iter)
            return
        if (int(self.params.nx) > VMG_COLD_START_MAX_N
                and not bool((self.state.v != 0).any())):
            log.info(
                "VMG cold start at N=%d is above the validated ceiling "
                "(N=%d): warm-starting from the nested-iteration cascade "
                "to avoid the measured spurious FAS fixed point.",
                int(self.params.nx), VMG_COLD_START_MAX_N)
            self.state, pre_iters = self._cold_start_warm_state(
                levels, tol, max_iter)
            log.info("VMG warm-start prelude done (%d sub-level "
                     "iterations)", pre_iters)
        v_cycle = make_v_cycle(levels, self.NU1, self.NU2, self.NU_COARSE,
                               smoothers=self._smoothers(levels))
        # per-cycle work = nu1 + nu2 fine steps: max_iterations keeps its
        # fine-step meaning
        max_cycles = max(1, max_iter // (self.NU1 + self.NU2))
        # "auto": per-cycle rel_iter below VMG_AUTO_ENERGY_MIN_N, the energy
        # plateau from it on and in singular mode
        metric = resolve_convergence_metric(self.params, auto_large="rel_iter")
        if _auto_criterion(self.params) and (
                int(self.params.nx) >= VMG_AUTO_ENERGY_MIN_N
                or self._is_singular()):
            metric = "energy"
        cyc_chunk = _cycle_chunk(self.params)
        result = run_fixed_point(
            v_cycle, lambda s: (s.u, s.v), self.state,
            tolerance=tol, max_iterations=max_cycles, chunk=cyc_chunk,
            log_callback=self._log_callback, convergence_metric=metric,
            # cycle-based window anchored at the validated N=192 V-cycle
            energy_plateau_chunks=scaled_plateau_chunks(
                int(self.params.nx), cyc_chunk, anchor_n=192,
                anchor_window=150))
        self.state = result.state
        result = self._maybe_newton_polish(result)
        self._store_results(result)


class FMGSolver(SGSolver):
    """Full multigrid: FSG nested iteration with V-cycle solves per
    level."""

    TAKES_SPATIAL_MESH = False

    NU1 = VMGSolver.NU1
    NU2 = VMGSolver.NU2
    NU_COARSE = VMGSolver.NU_COARSE
    SUPPORTS_SPATIAL_MESH = False

    _reject_singular = VMGSolver._reject_singular
    _smoothers = VMGSolver._smoothers

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        tol = self.params.tolerance if tolerance is None else tolerance
        max_iter = self.params.max_iterations if max_iter is None else max_iter
        self._check_options(x1_runs=False)
        check_fp32_matmul(self.device)
        if self._reject_singular():
            super().solve(tolerance=tol, max_iter=max_iter)
            return
        levels = build_vmg_levels(self.params, device=self.device)
        coarse_to_fine = levels[::-1]
        log.info("FMG hierarchy: N = %s", [lv.n for lv in coarse_to_fine])
        _warn_if_degenerate(levels, self.params)

        t0 = time.time()
        total_iters = 0
        converged = False
        diverged = False
        first_chunk_time = 0.0
        state = None
        cyc_chunk = _cycle_chunk(self.params)
        # per-level record: order, iterations, converged, wall and
        # first-chunk seconds
        self.levels = []
        for k, level in enumerate(coarse_to_fine):
            sub_levels = levels[len(levels) - 1 - k:]  # this level down
            level_tol = tol * (self.params.coarse_tolerance_factor
                               ** (len(coarse_to_fine) - 1 - k))
            if state is None:
                state = core.initial_state(level.ops)
            else:
                state = self._prolongate_fmg(coarse_to_fine[k - 1], level,
                                             state)
            if len(sub_levels) > 1:
                step = make_v_cycle(sub_levels, self.NU1, self.NU2,
                                    self.NU_COARSE,
                                    smoothers=self._smoothers(sub_levels))
                chunk_runner = None
                budget = max(1, max_iter // (self.NU1 + self.NU2))
                window = scaled_plateau_chunks(
                    level.n, cyc_chunk, anchor_n=192, anchor_window=150)
            else:
                # the coarsest single-level stage: the SG chunk kernel
                step, chunk_runner = self._paths(level.ops, exact=True)
                budget = max_iter
                window = scaled_plateau_chunks(level.n, cyc_chunk)
            metric = resolve_convergence_metric(self.params,
                                                auto_large="rel_iter")
            if (_auto_criterion(self.params)
                    and k == len(coarse_to_fine) - 1
                    and level.n >= VMG_AUTO_ENERGY_MIN_N):
                # the finest level: per-cycle rel_iter exits prematurely
                # at N >= 256; coarser levels only feed warm starts
                metric = "energy"
            result = run_fixed_point(
                step, lambda s: (s.u, s.v), state,
                tolerance=level_tol, max_iterations=budget, chunk=cyc_chunk,
                log_callback=self._log_callback
                if k == len(coarse_to_fine) - 1 else None,
                convergence_metric=metric, chunk_runner=chunk_runner,
                energy_plateau_chunks=window)
            state = result.state
            total_iters += result.iterations
            converged = result.converged
            diverged = result.diverged
            first_chunk_time += result.first_chunk_time
            self.levels.append({
                "n": level.n, "iterations": result.iterations,
                "converged": result.converged,
                "wall_time": result.wall_time,
                "first_chunk_time": result.first_chunk_time})
            log.info("FMG level %d (N=%d): %d outer iterations, "
                     "converged=%s", k, level.n, result.iterations, converged)
            if diverged:
                log.warning("FMG level %d (N=%d) diverged (NaN/Inf); "
                            "aborting", k, level.n)
                if level.n != int(self.params.nx):
                    # a fine-shaped NaN state, as FSGSolver leaves it
                    nf = int(self.params.nx) + 1
                    nan = lambda shape: torch.full(
                        shape, float("nan"), dtype=self.ops.dtype,
                        device=self.device)
                    state = core.SpectralState(nan((nf, nf)), nan((nf, nf)),
                                               nan((nf - 2, nf - 2)))
                break

        self.state = state
        wall = time.time() - t0
        # the single-row history of FSGSolver: final residuals and
        # quadratures, the rel_iter placeholder at tol (10x unconverged)
        R_u, R_v, R_p = core.residuals(self.ops, state.u, state.v, state.p)
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
            first_chunk_time=first_chunk_time)
        result = self._maybe_newton_polish(result)  # sets self.state if on
        self._store_results(result)

    def _prolongate_fmg(self, coarse_level, fine_level, state):
        """Coarse -> fine state transfer: FSGSolver's prolongation."""
        return FSGSolver._prolongate(self, state, coarse_level.n,
                                     fine_level.n, fine_level.ops)
