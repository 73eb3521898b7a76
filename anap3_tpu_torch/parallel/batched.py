"""Run a group of the port's solvers as one batched sweep.

The counterpart of the solver half of ``main.py:run_multirun_batched``
(``main.py:464-577``): which jobs may share a batch (``batchable``,
``batch_signature``), and ``run_batched(solvers)``, which runs FSG groups
through ``fsg_sweep.run_batched_fsg``, SG groups through the SG lane kernels
and FV groups through the FV lane kernels (chunk capped at 500), and stores
each lane's result into its solver. MLflow logging and plots stay in
``main.py``. ``main.py`` names only the JAX package's solvers as batchable,
so until it names these, ``main.py -m`` runs the port's solvers one by one.

With a ``mesh`` (a ``DeviceMesh`` with a ``"sweep"`` dimension, the one
``main.py:467-475`` builds for the JAX package), every rank passes the
whole group and runs its share of the lanes (``sweep.run_batched_sweep``);
every rank then stores every lane's result.

Unlike ``main.py``, lanes honour ``convergence_metric=residual`` (each
lane with its own normalization); ``main.py:485-492`` downgrades it to
rel_iter for SG and FSG and runs FV batches on rel_iter whatever they ask.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Sequence

from ..models.params import lane_kernels_on
from ..models.runner import IterationResult
from ..utils.profiling import span
from .sweep import lane_state, run_batched_sweep, stack_ops, stack_states

log = logging.getLogger(__name__)

__all__ = ["BATCHABLE_SOLVERS", "BATCHABLE_VARYING", "batchable",
           "batch_signature", "run_batched"]

BATCHABLE_SOLVERS = {
    "anap3_tpu_torch.models.spectral.SGSolver",
    "anap3_tpu_torch.models.spectral.FSGSolver",
    "anap3_tpu_torch.models.fv.FVSolver",
}
# solver keys that may differ between the lanes of one batch; everything
# else must be lane-identical
BATCHABLE_VARYING = {"Re", "corner_smoothing", "corner_treatment", "CFL",
                     "beta_squared", "lid_velocity"}
# the plain batched chunk's length (main.py:518); the lane kernels take the
# solver's chunk_size, FV capped at FV_LANE_CHUNK (main.py:536). The plain
# path of SG lanes is sg_lane_kernels.plain_lane_runner, that of FV lanes
# sweep.make_batched_chunk_runner over fv_step.
PLAIN_CHUNK = 200
FV_LANE_CHUNK = 500


def batchable(jobs) -> bool:
    """True when the job dicts (each with a "solver" config) may run as one
    batch: at least two, one batchable solver class, and equal solver keys
    apart from BATCHABLE_VARYING."""
    if len(jobs) < 2:
        return False
    first = jobs[0]["solver"]
    if first.get("_target_") not in BATCHABLE_SOLVERS:
        return False
    for cfg in jobs[1:]:
        s = cfg["solver"]
        if s.get("_target_") != first.get("_target_"):
            return False
        for key in set(first) | set(s):
            if key in BATCHABLE_VARYING:
                continue
            if s.get(key) != first.get(key):
                return False
    return True


def batch_signature(cfg):
    """Jobs sharing this signature can ride one batch; None for a solver
    that cannot be batched."""
    s = cfg["solver"]
    if s.get("_target_") not in BATCHABLE_SOLVERS:
        return None
    return tuple(sorted((k, repr(v)) for k, v in s.items()
                        if k not in BATCHABLE_VARYING))


def solver_job(solver) -> dict:
    """A solver as the job dict ``batchable`` reads: its class path and
    its parameters as the "solver" config."""
    cls = type(solver)
    return {"solver": {"_target_": f"{cls.__module__}.{cls.__qualname__}",
                       **dataclasses.asdict(solver.params)}}


def run_batched(solvers: Sequence, mesh=None) -> List[IterationResult]:
    """Solve every solver of a batchable group as one batched sweep, store
    each lane's result into its solver (state, fields, metrics, time
    series) and return the per-lane results. ``wall_time`` is the shared
    batch wall. A group that ``batchable`` refuses raises ValueError;
    ``mesh`` splits the lanes over its ``"sweep"`` dimension."""
    from ..models.fv import FVSolver, fv_step
    from ..models.spectral import (FSGSolver, SGSolver,
                                   resolve_convergence_metric,
                                   scaled_plateau_chunks)

    if len(solvers) > 1 and not batchable([solver_job(s) for s in solvers]):
        raise ValueError(
            "these solvers cannot share a batch: one batchable class, and "
            f"equal parameters apart from {sorted(BATCHABLE_VARYING)}")
    first = solvers[0]
    p0 = first.params
    log.info("Batched sweep: %d lanes of %s (N=%s)", len(solvers),
             type(first).__name__, p0.nx)
    if isinstance(first, (SGSolver, FSGSolver)):
        # sweeps pass no matmul algorithm (as the JAX package's): no x1
        first._check_options(x1_runs=False)
    if isinstance(first, FSGSolver):
        from .fsg_sweep import run_batched_fsg

        results = run_batched_fsg([s.params for s in solvers], mesh=mesh)
    else:
        ops_list = [s.ops for s in solvers]
        kernels = lane_kernels_on(p0, ops_list[0].device)
        if isinstance(first, SGSolver):
            from ..ops.sg_lane_kernels import sg_lane_runner

            step_fn = None  # both paths take a chunk runner
            chunk = int(p0.chunk_size) if kernels else PLAIN_CHUNK
            lane_runner = sg_lane_runner(ops_list, p0)
            metric = resolve_convergence_metric(p0)
            plateau = scaled_plateau_chunks(int(p0.nx), chunk)
        elif isinstance(first, FVSolver):
            from ..ops.fv_lane_kernels import maybe_fv_lane_runner

            step_fn = fv_step
            metric = resolve_convergence_metric(p0, auto_large="rel_iter")
            params_list = [s.params for s in solvers]
            chunk = (min(int(p0.chunk_size), FV_LANE_CHUNK) if kernels
                     else PLAIN_CHUNK)
            lane_runner = lambda lanes: maybe_fv_lane_runner(  # noqa: E731
                params_list[lanes], ops_list[lanes])
            plateau = None
        else:
            raise TypeError(f"{type(first).__name__} cannot run batched")
        stacked = stack_ops(ops_list)
        with span("level.setup"):
            states = stack_states([s.state for s in solvers])
        res = run_batched_sweep(
            step_fn, lambda s: (s.u, s.v), stacked, states,
            tolerance=float(p0.tolerance),
            max_iterations=int(p0.max_iterations), chunk=chunk, mesh=mesh,
            lane_runner=lane_runner, convergence_metric=metric,
            energy_plateau_chunks=plateau)
        results = []
        for k in range(len(solvers)):
            # recorded columns carry their global iteration (long sweeps
            # are decimated); keep those before this lane's end
            with span("solve.finish"):
                rec = res.history_iters < int(res.iterations[k])
                results.append(IterationResult(
                    state=lane_state(res.states, k),
                    iterations=int(res.iterations[k]),
                    converged=bool(res.converged[k]),
                    diverged=bool(res.diverged[k]), wall_time=res.wall_time,
                    history={key: res.history[key][k][rec].tolist()
                             for key in res.history},
                    first_chunk_time=res.first_chunk_time,
                    history_iters=res.history_iters[rec]))
    for solver, result in zip(solvers, results):
        solver.state = result.state
        if result.levels is not None:
            solver.levels = result.levels
        solver._store_results(result)
    return results
