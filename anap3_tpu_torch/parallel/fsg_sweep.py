"""Batched FSG sweeps: many Re / corner lanes through one FSG cascade.

The counterpart of ``anap3_tpu/parallel/fsg_sweep.py``: for lanes sharing N,
n_levels, basis, dtype, tolerance and max_iterations, every level is one
batched sweep (``sweep.run_batched_sweep``) through the SG lane kernels, and
each level's end state is prolongated to the next order.

Two differences from the JAX package:

- The ladder is the FSG solver's (``models/spectral.fsg_level_orders``):
  its coarsest level keeps the cell-Peclet floor and, in singular mode, the
  sharp-lid floor. The JAX sweep halves down to a fixed 12, so at N=128
  Re=5000 it runs [64, 128] where the single solve runs [128] (ROADMAP
  Queue 3). Lanes whose floors give different ladders run as separate
  groups, one after the other.
- The prolongation is the FSG solver's routine (``models/spectral.
  prolongate``) applied lane by lane, so a lane repeats its single FSG
  solve: the same per-level iterations and, the lane kernels being bitwise
  per lane, the same bits.
"""

from __future__ import annotations

import logging
import time
from typing import List, Sequence

import numpy as np
import torch

from ..models import spectral_sg as core
from ..models.params import SpectralParameters
from ..models.runner import IterationResult
from ..models.spectral import (fsg_level_orders, prolongate,
                               resolve_convergence_metric,
                               scaled_plateau_chunks)
from ..models.spectral_vmg import check_fp32_matmul
from ..ops.sg_lane_kernels import sg_lane_runner
from ..utils.profiling import span
from .sweep import lane_state, run_batched_sweep, stack_ops, stack_states

log = logging.getLogger(__name__)

__all__ = ["run_batched_fsg", "lane_ladders"]


def lane_ladders(param_list: Sequence[SpectralParameters]) -> List[list]:
    """Each lane's FSG ladder, coarsest first (the FSG solver's)."""
    return [fsg_level_orders(p) for p in param_list]


def _run_group(param_list, orders, chunk, mesh=None):
    """One cascade over ``orders`` for lanes that share it; returns the
    final states, per-lane iterations, converged and diverged flags, the
    per-level records and the summed first-chunk seconds."""
    p0 = param_list[0]
    B = len(param_list)
    tol = float(p0.tolerance)
    max_iter = int(p0.max_iterations)
    iters = np.zeros(B, dtype=int)
    converged = np.zeros(B, dtype=bool)
    diverged = np.zeros(B, dtype=bool)
    levels = [[] for _ in range(B)]
    first_chunk = 0.0
    states = None
    prev_n = None
    ops_list = None
    for level_idx, n in enumerate(orders):
        level_tol = tol * (p0.coarse_tolerance_factor
                           ** (len(orders) - 1 - level_idx))
        # a span a lane, so that each holds few of the profiler's events
        ops_list = []
        for p in param_list:
            with span("level.setup"):
                ops_list.append(core.build_spectral_ops(p, n=n)[0])
        if states is None:
            with span("level.setup"):
                lanes = [core.initial_state(o) for o in ops_list]
        else:
            lanes = []
            for b, p in enumerate(param_list):
                with span("level.prolong"):
                    lanes.append(prolongate(p, lane_state(states, b), prev_n,
                                            n, ops_list[b]))
        with span("level.setup"):
            states = stack_states(lanes)
        stacked = stack_ops(ops_list)
        # the finest level takes the lanes' criterion ("auto" is the energy
        # plateau at N >= 128); coarser levels only give warm starts, where
        # rel_iter is enough (fsg_sweep.py:102-111)
        if level_idx == len(orders) - 1:
            metric = resolve_convergence_metric(p0, n=n)
        else:
            metric = "rel_iter"
        res = run_batched_sweep(
            core.sg_step, lambda s: (s.u, s.v), stacked, states,
            tolerance=level_tol, max_iterations=max_iter, chunk=chunk,
            convergence_metric=metric, mesh=mesh,
            lane_runner=sg_lane_runner(ops_list, p0),
            energy_plateau_chunks=scaled_plateau_chunks(n, chunk))
        states = res.states
        iters += np.asarray(res.iterations, dtype=int)
        converged = np.asarray(res.converged)
        diverged |= np.asarray(res.diverged)
        first_chunk += res.first_chunk_time
        for b in range(B):
            levels[b].append({"n": n, "iterations": int(res.iterations[b]),
                              "converged": bool(res.converged[b])})
        log.info("  level %d (N=%d): median %d iterations, %d/%d converged",
                 level_idx, n, int(np.median(res.iterations)),
                 int(res.converged.sum()), B)
        prev_n = n
    return states, ops_list, iters, converged, diverged, levels, first_chunk


def run_batched_fsg(param_list: Sequence[SpectralParameters],
                    mesh=None) -> List[IterationResult]:
    """FSG-solve a batch of parameter lanes; one result per lane, in order.

    Lanes must share nx/ny, n_levels, basis, dtype, device, tolerance,
    max_iterations and chunk_size (the caller's batchability check); Re,
    the corner treatment and smoothing, CFL and beta_squared may vary.
    Each result
    carries its lane's per-level records in ``levels``, the one-row history
    of the FSG solver (final residual norms and quadratures, rel_iter at
    tol, or 10 tol when unconverged) and the SHARED batch wall in
    ``wall_time``, as the JAX package records it. ``mesh`` splits every
    level's lanes over its ``"sweep"`` dimension (each ladder group's lane
    count must divide it); every rank returns every lane's result."""
    p0 = param_list[0]
    if str(p0.dtype) == "float32":
        check_fp32_matmul(torch.device(p0.device))  # the prolongations
    chunk = int(p0.chunk_size)
    tol = float(p0.tolerance)
    ladders = lane_ladders(param_list)
    groups = {}
    for b, orders in enumerate(ladders):
        groups.setdefault(tuple(orders), []).append(b)
    t0 = time.time()
    out = {}
    for orders, members in groups.items():
        log.info("Batched FSG: %d lanes, hierarchy N = %s", len(members),
                 list(orders))
        out[orders] = (members, _run_group([param_list[b] for b in members],
                                           list(orders), chunk, mesh))
    wall = time.time() - t0

    results: List[IterationResult] = [None] * len(param_list)
    for members, (states, ops_list, iters, converged, diverged, levels,
                  first_chunk) in out.values():
        for k, b in enumerate(members):
            ops, st = ops_list[k], lane_state(states, k)
            with span("solve.finish"):
                R_u, R_v, R_p = core.residuals(ops, st.u, st.v, st.p)
                energy, enstrophy, palinstrophy = core.conserved_quantities(
                    ops, st.u, st.v)
                ok = bool(converged[k] and not diverged[k])
                history = {
                    "rel_iter": [tol if ok else tol * 10],
                    "u_eq": [float(torch.linalg.norm(R_u))],
                    "v_eq": [float(torch.linalg.norm(R_v))],
                    "continuity": [float(torch.linalg.norm(R_p))],
                    "energy": [float(energy)],
                    "enstrophy": [float(enstrophy)],
                    "palinstrophy": [float(palinstrophy)],
                }
            results[b] = IterationResult(
                state=st, iterations=int(iters[k]), converged=ok,
                diverged=bool(diverged[k]), wall_time=wall, history=history,
                first_chunk_time=first_chunk, levels=levels[k])
    return results
