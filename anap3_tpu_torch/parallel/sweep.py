"""Batched parameter sweeps: many (Re, corner_smoothing, ...) solves of one
grid, run side by side as lanes.

The counterpart of ``anap3_tpu/parallel/sweep.py``. Lanes share the operator
matrices (same N); per-lane scalars, boundary values and singular fields
ride a ``StackedOps``; every chunk advances every lane. A lane that goes
NaN/Inf is frozen without touching the others and reported as diverged
(the reference's divergence handling, multigrid/fsg.py:1184-1190).

Three things differ from the JAX package, all on purpose:

- The per-lane state machine is carried from chunk to chunk
  (``runner.LaneCarry``): a lane that converged or diverged stays frozen,
  and its iteration count is the step it converged at. The JAX batched
  chunk restarts every chunk with no lane done, so a lane that converged in
  an earlier chunk takes one more step in every later chunk and reports the
  first step of the last chunk as its iterations (ROADMAP Queue 3).
- ``convergence_metric="residual"`` is honoured per lane, each lane with
  its own normalization, as the B=1 runner does; the JAX sweep supports
  rel_iter and energy only, and ``main.py`` downgrades residual to rel_iter.
- A chunk that would cross ``max_iterations`` runs only the steps below it
  (a chunk function of that length), as ``runner.run_fixed_point`` does;
  the JAX sweep runs it whole, past its cap.

With a ``mesh`` (a ``DeviceMesh`` with a ``"sweep"`` dimension, one rank a
card or CPU worker), every rank passes the whole batch, as every process
does in the JAX package's multi-process path, and runs lanes
``[r B/W, (r+1) B/W)`` as one local batch, through the lane kernels on
CUDA (the JAX sweep drops its Pallas lane runner under a mesh; the
arithmetic of a lane is the same, and lane b of a launch gives the bits of
a one-lane launch). All ranks take the same chunks: the chunk-end "all my
lanes are done" flag is combined by ``all_reduce(MIN)`` on the host, over
gloo, so the speculative dispatch of chunk k+1 stays in place and no rank
leaves a collective behind. At the end states, iterations, flags and the
history are gathered, so every rank returns the whole ``SweepResult``.

A batched chunk function has the contract of ``ops/sg_lane_kernels.py``:
``chunk_fn(states, start_iter, carry) -> (states, carry, rows[chunk, B, 7])``.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.runner import (ENERGY_PLATEAU_CHUNKS, METRIC_KEYS, WARMUP_ITERS,
                             LaneCarry, control_step, fresh_carry, freeze,
                             rel_change)
from ..utils.profiling import span

__all__ = ["SweepResult", "StackedOps", "stack_ops", "stack_states",
           "lane_state", "make_batched_chunk_runner", "run_batched_sweep",
           "PLAIN_CALLS", "reset_counts"]

# chunks of the plain batched path (the sweep without lane kernels)
PLAIN_CALLS = {"batched_chunk": 0}


def reset_counts() -> None:
    PLAIN_CALLS["batched_chunk"] = 0


@dataclass
class SweepResult:
    """Per-lane outcome of a batched sweep."""

    states: Any                     # batched final state, (B, ...) fields
    iterations: np.ndarray          # (B,)
    converged: np.ndarray           # (B,) bool
    diverged: np.ndarray            # (B,) bool
    wall_time: float
    history: Dict[str, np.ndarray]  # key -> (B, n_recorded)
    # global iteration of each recorded history column (stride-decimated
    # on long sweeps, so not necessarily consecutive)
    history_iters: np.ndarray = None
    first_chunk_time: float = 0.0


class StackedOps:
    """The operators of B lanes (one dataclass type, e.g. ``SpectralOps`` or
    ``FVOps``), field by field: a tensor equal in every lane is kept once
    (the operator matrices), a tensor that differs is stacked to (B, ...)
    (boundary values, singular fields, FV's 0-d mu and lid), a float
    becomes a (B,) tensor (nu, beta_sq, CFL, lid_velocity, inv_dx_min,
    inv_dy_min; FV's alpha_uv, alpha_p) and anything else (strings, solver
    objects) is kept from lane 0. ``lane(b)`` is lane b's own operators."""

    def __init__(self, ops_list: Sequence[Any]):
        if not ops_list:
            raise ValueError("need at least one lane")
        self.lanes = list(ops_list)
        o0 = self.lanes[0]
        like = next(v for v in (getattr(o0, f.name)
                                for f in dataclasses.fields(o0))
                    if isinstance(v, torch.Tensor) and v.is_floating_point())
        self.shared: Dict[str, Any] = {}
        self.stacked: Dict[str, torch.Tensor] = {}
        for f in dataclasses.fields(o0):
            vals = [getattr(o, f.name) for o in self.lanes]
            v0 = vals[0]
            if isinstance(v0, torch.Tensor):
                # a span a field: a batch's comparisons hold many of the
                # profiler's events
                with span("level.setup"):
                    if all(v.shape == v0.shape and torch.equal(v, v0)
                           for v in vals[1:]):
                        self.shared[f.name] = v0
                    else:
                        self.stacked[f.name] = torch.stack(vals)
            elif isinstance(v0, float):
                self.stacked[f.name] = torch.tensor(
                    vals, dtype=like.dtype, device=like.device)
            else:
                self.shared[f.name] = v0

    def __len__(self) -> int:
        return len(self.lanes)

    def __getattr__(self, name):
        for table in ("stacked", "shared"):
            d = self.__dict__.get(table, {})
            if name in d:
                return d[name]
        raise AttributeError(name)

    def lane(self, b: int):
        return self.lanes[b]


def stack_ops(ops_list: Sequence[Any]) -> StackedOps:
    """The lanes' operators as one ``StackedOps``."""
    return StackedOps(ops_list)


def stack_states(states: Sequence[Any]):
    """B states (NamedTuples of tensors) as one state of (B, ...) fields."""
    return type(states[0])(*(torch.stack(f) for f in zip(*states)))


def lane_state(states, b: int):
    """Lane b's state of a batched state."""
    return type(states)(*(t[b] for t in states))


def make_batched_chunk_runner(step_fn: Callable, get_uv: Callable, ops,
                              chunk: int, tolerance: float,
                              warmup: int = WARMUP_ITERS,
                              convergence_metric: str = "rel_iter"):
    """The plain batched chunk (``sweep.py:53-104``): every lane computes
    every step with ``step_fn(ops.lane(b), state_b) -> (state, metrics)``
    and runs the B=1 state machine (``runner.control_step``) on its own
    flags; a done lane keeps its state by a select and records NaN rows.
    ``parallel/batched.py`` takes it for FV lanes (``fv_step``); SG lanes
    take ``ops/sg_lane_kernels.plain_lane_runner``, which gives its bits
    with ``sg_step``. Counted in PLAIN_CALLS["batched_chunk"]."""
    if convergence_metric not in ("rel_iter", "residual"):
        raise ValueError(
            f"chunk runners take the mapped criterion (rel_iter or "
            f"residual), not {convergence_metric!r}")
    use_residual = convergence_metric == "residual"
    B = len(ops)

    def chunk_fn(states, start_iter, carry=None):
        PLAIN_CALLS["batched_chunk"] += 1
        lanes = [lane_state(states, b) for b in range(B)]
        u0 = get_uv(lanes[0])[0]
        if carry is None:
            carry = fresh_carry(B, u0.dtype, u0.device)
        done = [carry.flags[b, 0] > 0 for b in range(B)]
        conv_iter = [carry.flags[b, 1] for b in range(B)]
        converged = [carry.flags[b, 2] > 0 for b in range(B)]
        ref = [carry.ref_norm[b] for b in range(B)]
        rows = []
        for offset in range(int(chunk)):
            idx = int(start_iter) + offset
            step_rows = []
            for b in range(B):
                state = lanes[b]
                u_prev, v_prev = get_uv(state)
                new, m = step_fn(ops.lane(b), state)
                u_new, v_new = get_uv(new)
                rel = torch.maximum(rel_change(u_new, u_prev),
                                    rel_change(v_new, v_prev))
                row = torch.stack([rel] + [m[k] for k in METRIC_KEYS[1:]]
                                  ).to(u_prev.dtype)
                row, now_done, conv_iter[b], converged[b], ref[b] = \
                    control_step(row, idx, done[b], conv_iter[b],
                                 converged[b], ref[b], tolerance, warmup,
                                 use_residual)
                lanes[b] = freeze(done[b], state, new)
                done[b] = now_done
                step_rows.append(row)
            rows.append(torch.stack(step_rows))
        flags = torch.stack([torch.stack([d.to(torch.int32),
                                          c.to(torch.int32),
                                          v.to(torch.int32)])
                             for d, c, v in zip(done, conv_iter, converged)])
        return (stack_states(lanes), LaneCarry(flags, torch.stack(ref)),
                torch.stack(rows))

    return chunk_fn


class _MeshLanes:
    """This rank's share of a batch of ``lanes`` over the mesh's ``axis``
    dimension, and the collectives a sweep over it needs."""

    def __init__(self, mesh, lanes: int, axis: str = "sweep"):
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if axis not in names:
            raise ValueError(f"a sweep mesh needs a {axis!r} dimension, not "
                             f"{names}")
        dim = names.index(axis)
        self.group = mesh.get_group(dim)
        self.world = mesh.size(dim)
        rank = mesh.get_local_rank(dim)
        if lanes % self.world:
            raise ValueError(f"{lanes} lanes do not divide over the "
                             f"{self.world} ranks of the mesh's {axis!r} "
                             f"dimension")
        per = lanes // self.world
        self.lanes = slice(rank * per, (rank + 1) * per)
        # host decisions ride gloo: a device collective would wait for the
        # speculated chunk behind it
        self.host = None if dist.get_backend() == "gloo" else \
            dist.new_group(backend="gloo")

    def all(self, flag: bool) -> bool:
        """``flag`` on every rank (the MIN of 0/1 over all ranks)."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.host)
        return bool(t.item())

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim``, in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim)

    def gather_host(self, a: np.ndarray, axis: int = 0,
                    device=None) -> np.ndarray:
        """``gather`` of a host array, through the lanes' device."""
        a = np.ascontiguousarray(a)
        as_bool = a.dtype == bool
        t = torch.as_tensor(a.astype(np.uint8) if as_bool else a,
                            device=device)
        out = self.gather(t, axis).cpu().numpy()
        return out.astype(bool) if as_bool else out

    def close(self) -> None:
        if self.host is not None:
            dist.destroy_process_group(self.host)


class _Pending:
    """A dispatched batched chunk whose flags and rows are on their way to
    the host: one bundled copy each, waited for by one event."""

    def __init__(self, out):
        self.out = out
        _, carry, rows = out
        self.flags = carry.flags.to("cpu", non_blocking=True)
        self.rows = rows.to("cpu", non_blocking=True)
        self.event = None
        if rows.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def read(self):
        if self.event is not None:
            self.event.synchronize()
        return self.flags.numpy(), self.rows.numpy()


def run_batched_sweep(step_fn, get_uv, ops, states, tolerance: float,
                      max_iterations: int, chunk: int = 200,
                      warmup: int = WARMUP_ITERS, mesh=None,
                      max_history_points: int = 4000, lane_runner=None,
                      convergence_metric: str = "rel_iter",
                      energy_plateau_chunks: int = None) -> SweepResult:
    """Drive a batch of solves to convergence (``sweep.py:107-297``).

    ``ops`` is a ``StackedOps`` and ``states`` a state of (B, ...) fields.
    ``lane_runner`` is a function ``lanes -> factory or None`` that builds,
    for a slice of the lanes, a factory ``(chunk, tol, warmup, metric) ->
    chunk_fn`` of lane kernels (``ops/sg_lane_kernels.sg_lane_runner``;
    ``ops/fv_lane_kernels.maybe_fv_lane_runner`` on the slice's lanes);
    without one, or where it gives None, the plain batched chunk runs
    ``step_fn``.

    Chunk k+1 is dispatched before chunk k's flags are read, with fresh
    output buffers per chunk. The host history is stride-decimated once it
    holds more than twice ``max_history_points`` rows. Criteria:
    "rel_iter" and "residual" on the device, per lane; "energy" runs the
    device chunk at tolerance 0 (divergence freezing only) and the per-lane
    kinetic-energy plateau with its net-drift gate on the host: a
    plateaued lane is recorded converged at that chunk's end and keeps
    integrating until the batch finishes.

    ``mesh``: the lanes are split over its ``"sweep"`` dimension (see the
    module docstring); a batch that the rank count does not divide raises
    ValueError. Every rank returns the whole result."""
    if convergence_metric not in ("rel_iter", "residual", "energy"):
        raise ValueError(
            f"unknown convergence_metric {convergence_metric!r}: expected "
            "'rel_iter', 'residual' or 'energy'")
    chunk = int(min(chunk, max(1, max_iterations)))
    plateau_target = int(energy_plateau_chunks or ENERGY_PLATEAU_CHUNKS)
    use_energy = convergence_metric == "energy"
    inner_metric = "rel_iter" if use_energy else convergence_metric
    inner_tol = 0.0 if use_energy else tolerance
    split = None
    lanes = slice(0, len(ops))
    if mesh is not None:
        split = _MeshLanes(mesh, len(ops))
        lanes = split.lanes
        ops = stack_ops(ops.lanes[lanes])
        states = type(states)(*(t[lanes] for t in states))
    with span("level.setup"):
        chunk_runner = (lane_runner(lanes) if lane_runner is not None
                        else None)
    runners = {}

    def runner(n):
        """The chunk function of ``n`` steps (``chunk``, or the last
        chunk's remainder below ``max_iterations``), built once a length."""
        if n not in runners:
            with span("level.setup"):
                runners[n] = (
                    chunk_runner(n, inner_tol, warmup, inner_metric)
                    if chunk_runner is not None else
                    make_batched_chunk_runner(step_fn, get_uv, ops, n,
                                              inner_tol, warmup,
                                              inner_metric))
        return runners[n]

    try:
        res = _sweep_loop(runner, states, len(ops), tolerance,
                          max_iterations, chunk, warmup, max_history_points,
                          use_energy, plateau_target, split)
    finally:
        if split is not None:
            split.close()
    if split is not None:
        res = _gathered(res, split)
    return res


def _gathered(res: SweepResult, split: _MeshLanes) -> SweepResult:
    """Every rank's lanes of a sweep's result, in lane order."""
    dev = res.states[0].device
    lanes = lambda a, axis=0: split.gather_host(np.asarray(a), axis, dev)
    rows = {k: lanes(v) for k, v in res.history.items()}
    return dataclasses.replace(
        res, states=type(res.states)(*(split.gather(t) for t in res.states)),
        iterations=lanes(res.iterations),
        converged=lanes(res.converged), diverged=lanes(res.diverged),
        history=rows)


def _sweep_loop(runner, states, B, tolerance, max_iterations, chunk, warmup,
                max_history_points, use_energy, plateau_target,
                split) -> SweepResult:
    """The host loop of ``run_batched_sweep`` over this rank's lanes;
    ``runner(n)`` is the chunk function of ``n`` steps."""
    rows_buf: List[np.ndarray] = []
    idx_buf: List[np.ndarray] = []
    n_kept = 0
    stride = 1
    energy_col = METRIC_KEYS.index("energy")
    e_prev = None                # (B,) previous chunk-end energies
    plateau = None               # (B,) consecutive plateaued chunks
    conv_it_energy = None        # (B,) iteration of energy convergence
    e_w0 = None
    flags_h = np.tile(np.array([0, -1, 0], np.int64), (B, 1))
    first_chunk_time = 0.0
    t0 = time.time()
    it = 0
    cur = None
    def dispatch(st, start, carry):
        # the last chunk runs only the steps left below the cap
        n = min(chunk, max_iterations - start)
        run = runner(n)
        with span("chunk.dispatch"):
            return _Pending(run(st, start, carry))

    if it < max_iterations:
        cur = dispatch(states, it, None)
    while cur is not None:
        states, carry, _ = cur.out
        nxt = None
        if it + chunk < max_iterations:
            nxt = dispatch(states, it + chunk, carry)
        with span("chunk.wait"):
            flags_h, rows_h = cur.read()
        with span("chunk.control"):
            if first_chunk_time == 0.0:
                first_chunk_time = time.time() - t0
            n_ran = min(chunk, max_iterations - it)
            rows_h = rows_h[:n_ran]  # (n, B, K)
            gis = np.arange(it, it + n_ran)
            keep = (gis >= warmup) & ((gis - warmup) % stride == 0)
            if keep.any():
                rows_buf.append(rows_h[keep])
                idx_buf.append(gis[keep])
                n_kept += int(keep.sum())
            if n_kept > 2 * max_history_points:
                all_rows = np.concatenate(rows_buf, axis=0)[::2]
                all_idx = np.concatenate(idx_buf)[::2]
                rows_buf, idx_buf = [all_rows], [all_idx]
                n_kept = all_rows.shape[0]
                stride *= 2
            it += n_ran
            if use_energy and it > warmup:
                e_rows = rows_h[:, :, energy_col]  # (n, B)
                if plateau is None:
                    plateau = np.zeros(B, np.int64)
                    conv_it_energy = np.full(B, -1, np.int64)
                    e_w0 = np.full(B, np.nan)
                # last finite energy per lane (done lanes record NaN)
                e_last = np.full(B, np.nan)
                for b in range(B):
                    finite = np.isfinite(e_rows[:, b])
                    if finite.any():
                        e_last[b] = e_rows[np.flatnonzero(finite)[-1], b]
                if e_prev is not None:
                    flat = (np.abs(e_last - e_prev)
                            <= tolerance * np.maximum(np.abs(e_last), 1e-30))
                    flat &= np.isfinite(e_last)
                    e_w0 = np.where(flat & (plateau == 0), e_prev, e_w0)
                    plateau = np.where(flat, plateau + 1, 0)
                    reached = plateau >= plateau_target
                    # net-drift gate: the window's net change within
                    # sqrt(window) per-chunk budgets
                    net_ok = (np.abs(e_last - e_w0)
                              <= tolerance * np.maximum(np.abs(e_last), 1e-30)
                              * max(1.0, plateau_target ** 0.5))
                    newly = reached & net_ok & (conv_it_energy < 0)
                    conv_it_energy[newly] = it
                    plateau = np.where(reached & ~net_ok, 0, plateau)
                e_prev = np.where(np.isfinite(e_last), e_last,
                                  e_prev if e_prev is not None else e_last)
            lane_done = flags_h[:, 0] > 0
            if use_energy and conv_it_energy is not None:
                lane_done = lane_done | (conv_it_energy >= 0)
            all_done = bool(lane_done.all())
            if split is not None:
                all_done = split.all(all_done)
            if all_done:
                break  # a speculated chunk is dropped
        cur = nxt
    wall = time.time() - t0

    with span("chunk.control"):
        done_h = flags_h[:, 0] > 0
        conv_iter_h = flags_h[:, 1]
        if use_energy:
            if conv_it_energy is None:
                conv_it_energy = np.full(B, -1, np.int64)
            converged = conv_it_energy >= 0
            iterations = np.where(converged, conv_it_energy, it)
        else:
            converged = flags_h[:, 2] > 0
            iterations = np.where(conv_iter_h > 0, conv_iter_h, it)
        diverged = done_h & ~converged

        if rows_buf:
            rows_all = np.concatenate(rows_buf, axis=0)  # (T', B, K)
            idx_all = np.concatenate(idx_buf)
        else:
            rows_all = np.zeros((0, B, len(METRIC_KEYS)))
            idx_all = np.zeros((0,), np.int64)
        hist = {key: rows_all[:, :, ki].T
                for ki, key in enumerate(METRIC_KEYS)}
    return SweepResult(states=states, iterations=iterations,
                       converged=converged, diverged=diverged,
                       wall_time=wall, history=hist, history_iters=idx_all,
                       first_chunk_time=first_chunk_time)
