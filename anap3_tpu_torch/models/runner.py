"""Chunked convergence-checked iteration harness.

The counterpart of ``anap3_tpu/models/runner.py`` with the same host
semantics. A chunk of ``chunk`` iterations runs on the device with no host
sync: the ``done`` flag, ``conv_iter`` and the residual normalization stay
device tensors, a done (converged or diverged) state is frozen and its rows
are NaN, so the result equals a per-iteration Python loop with an early
break. The host reads one bundle of flags and rows per chunk, after the
next chunk has already been dispatched.

``make_chunk_runner`` is the plain chunk over any ``step_fn``; the SG
kernels bring their own chunk runner with the same contract
(``ops/sg_kernels.make_sg_chunk_runner``):

    chunk_fn(state, start_iter, ref_norm)
        -> (state, done, conv_iter, converged, rows[chunk, 7], ref_norm)

with rows in METRIC_KEYS order and in the working dtype.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..utils.profiling import span

log = logging.getLogger(__name__)

__all__ = ["IterationResult", "run_fixed_point", "make_chunk_runner",
           "control_step", "freeze", "rel_change", "LaneCarry", "fresh_carry",
           "METRIC_KEYS", "WARMUP_ITERS", "ENERGY_PLATEAU_CHUNKS"]

WARMUP_ITERS = 10  # convergence gate + history start (reference base.py)
# consecutive plateaued chunks required by convergence_metric="energy"
ENERGY_PLATEAU_CHUNKS = 3

METRIC_KEYS = ("rel_iter", "u_eq", "v_eq", "continuity", "energy",
               "enstrophy", "palinstrophy")


@dataclass
class IterationResult:
    """Host-side result of an iterative solve (see anap3_tpu's runner)."""

    state: Any
    iterations: int
    converged: bool
    diverged: bool
    wall_time: float
    # metric histories from iteration WARMUP_ITERS on, stride-decimated on
    # long runs; history_iters holds each entry's global iteration
    history: Dict[str, List[float]]
    # wall time of the first chunk (it includes the kernels' build)
    first_chunk_time: float = 0.0
    # the criterion plateaued above tolerance and stall detection stopped
    stalled: bool = False
    history_iters: Optional[np.ndarray] = None
    # FSG sweeps: the lane's per-level records (order, iterations, converged)
    levels: Optional[list] = None


class LaneCarry(NamedTuple):
    """The per-lane state machine that one chunk of a batched sweep hands
    to the next: ``flags`` (B, 3) int32 rows (done, conv_iter, converged)
    and the residual criterion's normalization ``ref_norm`` (B,). A lane
    done in one chunk stays done, frozen, in the next."""

    flags: torch.Tensor
    ref_norm: torch.Tensor


def fresh_carry(lanes: int, dtype, device) -> LaneCarry:
    """The carry of a sweep's first chunk: no lane done, no normalization."""
    flags = torch.tensor([[0, -1, 0]] * int(lanes), dtype=torch.int32,
                         device=device)
    return LaneCarry(flags, torch.full((int(lanes),), float("inf"),
                                       dtype=dtype, device=device))


def rel_change(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """|new - old| / (|old| + 1e-12), Frobenius norms."""
    return torch.linalg.norm(new - old) / (torch.linalg.norm(old) + 1e-12)


def control_step(row, idx, done, conv_iter, converged, ref_norm, tolerance,
                 warmup, use_residual):
    """One step of the convergence state machine, on device tensors.

    ``row`` holds the step's METRIC_KEYS values; ``idx`` is the 0-based
    global iteration (a host int). Returns the recorded row (NaN once
    done), the new ``done``, ``conv_iter``, ``converged`` and ``ref_norm``.
    The residual criterion normalizes the continuity norm by its value at
    the warmup iteration."""
    row = torch.where(done, torch.full_like(row, float("nan")), row)
    rel = row[0]
    if use_residual:
        resid = row[3]
        if idx == warmup:
            ref_norm = resid
        crit = resid / torch.clamp_min(ref_norm, 1e-30)
    else:
        crit = rel
    finite = torch.isfinite(rel)
    newly_converged = finite & (crit < tolerance) & (idx >= warmup)
    now_done = done | newly_converged | ~finite
    conv_iter = torch.where(~done & now_done,
                            torch.full_like(conv_iter, idx + 1), conv_iter)
    return row, now_done, conv_iter, converged | newly_converged, ref_norm


def freeze(done, state, new_state):
    """``state`` where ``done`` else ``new_state``, field by field."""
    return type(state)(*(torch.where(done, a, b)
                         for a, b in zip(state, new_state)))


def make_chunk_runner(step_fn: Callable, get_uv: Callable, chunk: int,
                      tolerance: float, warmup: int = WARMUP_ITERS,
                      convergence_metric: str = "rel_iter"):
    """The plain chunk: ``chunk`` calls of ``step_fn(state) -> (state,
    metrics)`` (the METRIC_KEYS scalars but rel_iter, which is computed
    here from ``get_uv``'s velocities), each followed by the state machine.

    ``convergence_metric`` is "rel_iter" (the relative iterate change, the
    reference's definition) or "residual" (continuity norm relative to its
    warmup value); run_fixed_point maps "energy" to rel_iter with tolerance
    0 and tests the energy plateau on the host."""
    use_residual = convergence_metric == "residual"

    def chunk_fn(state, start_iter, ref_norm):
        u_prev, v_prev = get_uv(state)
        dev, mdtype = u_prev.device, u_prev.dtype
        done = torch.zeros((), dtype=torch.bool, device=dev)
        converged = torch.zeros((), dtype=torch.bool, device=dev)
        conv_iter = torch.full((), -1, dtype=torch.int32, device=dev)
        rows = []
        for offset in range(chunk):
            idx = int(start_iter) + offset
            new_state, m = step_fn(state)
            u_new, v_new = get_uv(new_state)
            rel = torch.maximum(rel_change(u_new, u_prev),
                                rel_change(v_new, v_prev))
            row = torch.stack([rel] + [m[k] for k in METRIC_KEYS[1:]]
                              ).to(mdtype)
            row, now_done, conv_iter, converged, ref_norm = control_step(
                row, idx, done, conv_iter, converged, ref_norm, tolerance,
                warmup, use_residual)
            rows.append(row)
            state = freeze(done, state, new_state)
            u_prev, v_prev = get_uv(state)
            done = now_done
        return state, done, conv_iter, converged, torch.stack(rows), ref_norm

    return chunk_fn


class _Pending:
    """A dispatched chunk whose control outputs are on their way to the
    host: one bundled copy, waited for by one event."""

    def __init__(self, out):
        self.out = out
        _, done, conv_iter, converged, rows, _ = out
        flags = torch.stack([done.to(torch.int32), conv_iter.to(torch.int32),
                             converged.to(torch.int32)])
        self.flags = flags.to("cpu", non_blocking=True)
        self.rows = rows.to("cpu", non_blocking=True)
        self.event = None
        if rows.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def read(self):
        if self.event is not None:
            self.event.synchronize()
        done, conv_iter, converged = (int(x) for x in self.flags.tolist())
        return bool(done), conv_iter, bool(converged), self.rows.numpy()


def run_fixed_point(step_fn, get_uv, state, tolerance: float,
                    max_iterations: int, chunk: int = 100,
                    warmup: int = WARMUP_ITERS,
                    log_callback: Optional[Callable] = None,
                    log_every: int = 50,
                    checkpoint_mgr=None,
                    start_iteration: int = 0,
                    convergence_metric: str = "rel_iter",
                    chunk_runner=None, stall_chunks: int = 0,
                    max_history_points: int = 4000,
                    energy_plateau_chunks: Optional[int] = None
                    ) -> IterationResult:
    """Run ``step_fn`` to convergence with the reference's semantics.

    The same contract as ``anap3_tpu.models.runner.run_fixed_point`` (see
    its docstring for the criteria, the energy plateau with its
    sqrt(n)*eps noise floor and net-drift gate, stall detection and the
    history decimation). ``chunk_runner`` is a factory ``(chunk, tol,
    metric) -> chunk_fn``; it receives the MAPPED criterion (energy arrives
    as rel_iter with tolerance 0).

    ``checkpoint_mgr`` (``utils/checkpoint.CheckpointManager``) is offered
    the state after every chunk that did not finish the solve, with the
    residual criterion's normalization ``ref_norm`` as its carry, and saves
    them every K chunks; ``start_iteration`` resumes the global iteration
    counter after a restore (pre-resume history is not replayed), and the
    manager's restored carry resumes ``ref_norm``. (The JAX package
    restarts it at inf, so a resumed residual-criterion run past warmup
    converges at its first step.) The energy plateau's host counters start
    afresh on a resume, as in the JAX package: it takes the plateau's
    chunks again.

    Chunk k+1 is dispatched before chunk k's flags are read. That is exact:
    a done state is frozen, so a speculated chunk past convergence changes
    nothing, and every chunk writes fresh output tensors, so chunk k's
    state is never overwritten by chunk k+1: a checkpoint of chunk k
    saves chunk k's state even while chunk k+1 runs.

    A chunk that would cross ``max_iterations`` runs only the steps below
    it, from a runner of that length, so the state is the state at the
    cap. (The JAX package runs the last chunk whole and reports the cap.)
    """
    chunk = int(min(chunk, max(1, max_iterations)))
    if convergence_metric not in ("rel_iter", "residual", "energy"):
        raise ValueError(
            f"unknown convergence_metric {convergence_metric!r}: expected "
            "'rel_iter', 'residual' or 'energy'")
    use_energy = convergence_metric == "energy"
    plateau_target = int(energy_plateau_chunks or ENERGY_PLATEAU_CHUNKS)
    inner_metric = "rel_iter" if use_energy else convergence_metric
    inner_tol = 0.0 if use_energy else tolerance
    runners = {}

    def dispatch(st, start, rn):
        """Chunk ``[start, start + n)`` with n = ``chunk``, or the remainder
        below ``max_iterations`` for the last one: a runner is built per
        length, so a capped solve never steps past its cap."""
        n = min(chunk, max_iterations - start)
        if n not in runners:
            with span("level.setup"):
                runners[n] = (chunk_runner(n, inner_tol, inner_metric)
                              if chunk_runner is not None else
                              make_chunk_runner(step_fn, get_uv, n, inner_tol,
                                                warmup, inner_metric))
        with span("chunk.dispatch"):
            return _Pending(runners[n](st, start, rn))

    rows_buf: List[np.ndarray] = []
    idx_buf: List[np.ndarray] = []
    n_kept = 0
    stride = 1
    last_row: Optional[np.ndarray] = None
    last_idx = -1
    iterations = start_iteration
    converged = False
    diverged = False
    stalled = False
    crit_col = METRIC_KEYS.index(
        "continuity" if convergence_metric == "residual" else "rel_iter")
    energy_col = METRIC_KEYS.index("energy")
    e_prev: Optional[float] = None
    e_window0 = 0.0
    plateau_count = 0
    best_crit = np.inf
    stall_count = 0
    log_time = 0.0
    t0 = time.time()

    it = start_iteration
    first_chunk_time = 0.0
    u0, _ = get_uv(state)
    carry = getattr(checkpoint_mgr, "carry", None) or {}
    ref_norm = torch.full((), carry.get("ref_norm", float("inf")),
                          dtype=u0.dtype, device=u0.device)
    t_chunk = time.time()
    cur = None
    if it < max_iterations:
        cur = dispatch(state, it, ref_norm)
    while cur is not None:
        state_k, _, _, _, _, ref_k = cur.out
        nxt = None
        if it + chunk < max_iterations:
            nxt = dispatch(state_k, it + chunk, ref_k)
        # one bundled device->host read for chunk k's control flow
        with span("chunk.wait"):
            done_host, conv_iter_host, conv_flag, rows_host = cur.read()
        with span("chunk.control"):
            state = state_k
            if first_chunk_time == 0.0:
                first_chunk_time = time.time() - t_chunk

            if done_host:
                n_ran = conv_iter_host - it
                iterations = conv_iter_host
                converged = conv_flag
                diverged = not converged
            else:
                n_ran = min(chunk, max_iterations - it)
                iterations = it + n_ran
            gis = np.arange(it, it + n_ran)
            keep = (gis >= warmup) & ((gis - warmup) % stride == 0)
            if keep.any():
                rows_buf.append(rows_host[:n_ran][keep])
                idx_buf.append(gis[keep])
                n_kept += int(keep.sum())
            if n_ran > 0 and gis[-1] >= warmup:
                last_row = rows_host[n_ran - 1]
                last_idx = int(gis[-1])
            if n_kept > 2 * max_history_points:
                all_rows = np.concatenate(rows_buf, axis=0)[::2]
                all_idx = np.concatenate(idx_buf)[::2]
                rows_buf, idx_buf = [all_rows], [all_idx]
                n_kept = all_rows.shape[0]
                stride *= 2

            if log_callback is not None:
                t_log = time.time()
                for off in range(n_ran):
                    gi = it + off
                    if gi % log_every == 0 or (done_host
                                               and gi == iterations - 1):
                        log_callback(gi, dict(zip(METRIC_KEYS,
                                                  rows_host[off].tolist())))
                log_time += time.time() - t_log

            it += n_ran
            if checkpoint_mgr is not None and not done_host:
                t_ck = time.time()
                checkpoint_mgr.maybe_save(state, it, {"ref_norm": ref_k})
                log_time += time.time() - t_ck
            if done_host:
                break  # a speculated chunk is dropped; state is chunk k's
            if use_energy and it > warmup:
                vals = rows_host[:n_ran, energy_col]
                vals = vals[np.isfinite(vals)]
                if vals.size:
                    e_last = float(vals[-1])
                    # floored at the energy dtype's rounding walk over n steps
                    eff_tol = max(tolerance, float(np.sqrt(n_ran))
                                  * float(np.finfo(rows_host.dtype).eps))
                    if e_prev is not None and abs(e_last - e_prev) <= (
                            eff_tol * max(abs(e_last), 1e-30)):
                        if plateau_count == 0:
                            e_window0 = e_prev
                        plateau_count += 1
                        if plateau_count >= plateau_target:
                            # net-drift gate: noise walks ~sqrt(window), a
                            # drift grows linearly and fails
                            if abs(e_last - e_window0) <= (
                                    eff_tol * max(abs(e_last), 1e-30)
                                    * max(1.0, plateau_target ** 0.5)):
                                if eff_tol > tolerance:
                                    log.info(
                                        "energy plateau converged at the %s "
                                        "noise floor (effective tol %.1e > "
                                        "requested %.1e)", rows_host.dtype,
                                        eff_tol, tolerance)
                                converged = True
                                iterations = it
                                break
                            plateau_count = 0
                    else:
                        plateau_count = 0
                    e_prev = e_last
            if stall_chunks > 0 and not use_energy and it > warmup:
                vals = rows_host[:n_ran, crit_col]
                vals = vals[np.isfinite(vals)]
                if vals.size:
                    chunk_min = float(vals.min())
                    if chunk_min < best_crit * 0.98:
                        best_crit = chunk_min
                        stall_count = 0
                    else:
                        stall_count += 1
                    if stall_count >= stall_chunks:
                        stalled = True
                        iterations = it
                        break
        cur = nxt

    wall = time.time() - t0 - log_time

    with span("chunk.control"):
        if rows_buf:
            all_rows = np.concatenate(rows_buf, axis=0)
            all_idx = np.concatenate(idx_buf)
        else:
            all_rows = np.zeros((0, len(METRIC_KEYS)))
            all_idx = np.zeros((0,), np.int64)
        mask = all_idx < iterations
        all_rows, all_idx = all_rows[mask], all_idx[mask]
        if last_row is not None and last_idx < iterations and (
                all_idx.size == 0 or int(all_idx[-1]) != last_idx):
            all_rows = np.concatenate([all_rows, last_row[None]], axis=0)
            all_idx = np.concatenate([all_idx, [last_idx]])
        history = {key: all_rows[:, i].tolist()
                   for i, key in enumerate(METRIC_KEYS)}
    return IterationResult(
        state=state, iterations=iterations, converged=converged,
        diverged=diverged, wall_time=wall, history=history,
        first_chunk_time=first_chunk_time, stalled=stalled,
        history_iters=all_idx)
