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
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

__all__ = ["IterationResult", "run_fixed_point", "make_chunk_runner",
           "control_step", "freeze", "rel_change", "METRIC_KEYS",
           "WARMUP_ITERS", "ENERGY_PLATEAU_CHUNKS"]

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
                    convergence_metric: str = "rel_iter",
                    chunk_runner=None, stall_chunks: int = 0,
                    max_history_points: int = 4000,
                    energy_plateau_chunks: Optional[int] = None
                    ) -> IterationResult:
    """Run ``step_fn`` to convergence with the reference's semantics.

    The same contract as ``anap3_tpu.models.runner.run_fixed_point`` (see
    its docstring for the criteria, the energy plateau with its
    sqrt(n)*eps noise floor and net-drift gate, stall detection and the
    history decimation), without the checkpoint hooks. ``chunk_runner`` is
    a factory ``(chunk, tol, metric) -> chunk_fn``; it receives the MAPPED
    criterion (energy arrives as rel_iter with tolerance 0).

    Chunk k+1 is dispatched before chunk k's flags are read. That is exact:
    a done state is frozen, so a speculated chunk past convergence changes
    nothing, and every chunk writes fresh output tensors, so chunk k's
    state is never overwritten by chunk k+1.
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
    if chunk_runner is not None:
        runner = chunk_runner(chunk, inner_tol, inner_metric)
    else:
        runner = make_chunk_runner(step_fn, get_uv, chunk, inner_tol, warmup,
                                   inner_metric)

    rows_buf: List[np.ndarray] = []
    idx_buf: List[np.ndarray] = []
    n_kept = 0
    stride = 1
    last_row: Optional[np.ndarray] = None
    last_idx = -1
    iterations = 0
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

    it = 0
    first_chunk_time = 0.0
    u0, _ = get_uv(state)
    ref_norm = torch.full((), float("inf"), dtype=u0.dtype, device=u0.device)
    t_chunk = time.time()
    cur = None
    if it < max_iterations:
        cur = _Pending(runner(state, it, ref_norm))
    while cur is not None:
        state_k, _, _, _, _, ref_k = cur.out
        nxt = None
        if it + chunk < max_iterations:
            nxt = _Pending(runner(state_k, it + chunk, ref_k))
        # one bundled device->host read for chunk k's control flow
        done_host, conv_iter_host, conv_flag, rows_host = cur.read()
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
                if gi % log_every == 0 or (done_host and gi == iterations - 1):
                    log_callback(gi, dict(zip(METRIC_KEYS,
                                              rows_host[off].tolist())))
            log_time += time.time() - t_log

        it += n_ran
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
