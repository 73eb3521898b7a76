"""The benchmark's calls into the program (``anap3_tpu_torch``): build the
solvers of a job from its parameters, run the job through the entry a
user's run calls, validate it, and keep what the judgement and the
metrics read. The program is imported here, at set-up, and nowhere else.

A configuration's ``solver`` names one of the port's solver classes
(``program()["solvers"]``, one for each ``_target_`` of
``conf/solver/gpu/*.yaml``). A lane's ``iterations`` is the count its
solver reports (``IterationResult.iterations``) and ``levels`` its count
at each order, coarsest first, where the solver keeps that record (FSG,
FMG), else ``[(N, iterations)]``. What one iteration is, by solver:

- ``sg``, ``fsg``: an RK4 step (FSG: at each level of its ladder);
- ``vmg``: a V-cycle (NU1 + NU2 = 4 smoothing steps at each level above
  the coarsest, NU_COARSE = 30 there); a hierarchy of one level (where
  the FAS floor, ceil(2.4 sqrt(Re)), admits no coarser order) runs the SG
  solve and counts RK4 steps;
- ``fmg``: at each level: RK4 steps on the coarsest level, which runs the
  SG chunk, and V-cycles over the levels below on each finer one; the
  lane's ``iterations`` adds the two kinds;
- ``newton``: a PTC step (each a GMRES solve of up to ``gmres_vectors``
  vectors);
- ``fv``: a SIMPLE iteration.

``max_iterations``, which the warm-up sets to ``run.WARM_STEPS`` (64)
and a traced job to its mix's ``trace_steps``, caps by solver:

- ``sg``, ``fsg``, ``fv``: the iterations at each level;
- ``vmg``: max(1, max_iterations // (NU1 + NU2)) V-cycles (16 at 64);
- ``fmg``: the coarsest level's RK4 steps, and max(1, max_iterations //
  (NU1 + NU2)) V-cycles at each finer level;
- ``newton``: nothing: its budget is ``newton_max_steps``, so its warm-up
  and its traced job are whole solves.

A ``round`` job runs ``parallel.batched.run_batched``, which batches the
SG, FSG and FV solvers only; another solver's round is refused.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np

from .spec import SpecError


def program():
    """The program's modules the benchmark drives."""
    import anap3_tpu_torch.models.fv as fv
    import anap3_tpu_torch.models.spectral as spectral
    import anap3_tpu_torch.models.spectral_vmg as spectral_vmg
    import anap3_tpu_torch.models.steady as steady
    from anap3_tpu_torch.models.params import FVParameters, SpectralParameters
    from anap3_tpu_torch.ops import (fv_kernels, fv_lane_kernels, nk_kernels,
                                     sg_kernels, sg_lane_kernels)
    from anap3_tpu_torch.parallel import batched

    return {
        "solvers": {
            "sg": (spectral.SGSolver, SpectralParameters),
            "fsg": (spectral.FSGSolver, SpectralParameters),
            "vmg": (spectral_vmg.VMGSolver, SpectralParameters),
            "fmg": (spectral_vmg.FMGSolver, SpectralParameters),
            "newton": (steady.NewtonSolver, SpectralParameters),
            "fv": (fv.FVSolver, FVParameters),
        },
        "batchable": batched.BATCHABLE_SOLVERS,
        "run_batched": batched.run_batched,
        "counters": (sg_kernels, fv_kernels, sg_lane_kernels,
                     fv_lane_kernels, nk_kernels),
    }


def class_path(cls) -> str:
    return f"{cls.__module__}.{cls.__qualname__}"


def solver_class(prog, config: dict):
    """(solver class, parameter class) of the configuration's ``solver``."""
    solvers = prog["solvers"]
    if config["solver"] not in solvers:
        raise SpecError(f"no solver {config['solver']!r}: the harness knows "
                        f"{sorted(solvers)}")
    return solvers[config["solver"]]


def make_solver(prog, config: dict, lane: dict, device: str):
    cls, params_cls = solver_class(prog, config)
    names = {f.name for f in dataclasses.fields(params_cls)}
    unknown = set(lane) - names
    if unknown:
        raise ValueError(f"parameters the solver does not take: {unknown}")
    return cls(params=params_cls(**dict(lane, device=device)))


def launches(prog) -> int:
    """Kernel launches the program's wrappers have made, all kernels."""
    return sum(sum(mod.LAUNCHES.values()) for mod in prog["counters"])


def reset_launches(prog) -> None:
    for mod in prog["counters"]:
        mod.reset_counts()


def _sync(device: str) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


@dataclasses.dataclass
class Lane:
    """One solved lane: what the judgement reads."""

    params: dict
    n: int
    state: tuple          # numpy copies of the solver's state fields
    converged: bool
    iterations: int
    levels: list          # [(order, iterations)] coarsest first
    validation: dict      # the program's reported numbers


@dataclasses.dataclass
class Job:
    """One timed solve or round."""

    kind: str
    lanes: list
    build_s: float
    step_s: float
    validate_s: float
    wall_s: float

    @property
    def lane_steps(self) -> int:
        return sum(lane.iterations for lane in self.lanes)

    @property
    def batch_steps(self) -> int:
        """Steps the job marched: level by level, its slowest lane's."""
        depth = max(len(lane.levels) for lane in self.lanes)
        return sum(max(lane.levels[i][1] for lane in self.lanes
                       if i < len(lane.levels)) for i in range(depth))


def _levels(solver, iterations: int, n: int) -> list:
    lv = getattr(solver, "levels", None)
    if lv:
        return [(int(x["n"]), int(x["iterations"])) for x in lv]
    return [(n, int(iterations))]


def run_job(prog, config: dict, kind: str, lanes: list, device: str,
            root: Path, span=None, validate: int = None) -> Job:
    """Build, solve and validate one job (its first ``validate`` lanes,
    where given); ``span(name)`` is a context manager around each phase
    (the profiler's labels in a traced job)."""
    span = span or (lambda name: contextlib.nullcontext())
    if kind == "round" and \
            class_path(solver_class(prog, config)[0]) not in prog["batchable"]:
        raise SpecError(f"a round job needs a solver that run_batched "
                        f"batches, not {config['solver']!r}")
    t0 = time.perf_counter()
    with span("build"):
        solvers = [make_solver(prog, config, lane, device) for lane in lanes]
    t1 = time.perf_counter()
    with span("solve"):
        if kind == "solve":
            if len(solvers) != 1:
                raise ValueError("a solve job has one lane")
            solvers[0].solve()
        elif kind == "round":
            prog["run_batched"](solvers)
        else:
            raise ValueError(f"unknown job kind {kind!r}")
        _sync(device)
    t2 = time.perf_counter()
    with span("validate"):
        reported = [s.compute_validation_errors(base_dir=root,
                                                save_plots=False)
                    if validate is None or b < validate else {}
                    for b, s in enumerate(solvers)]
    t3 = time.perf_counter()
    out = []
    for lane, s, errs in zip(lanes, solvers, reported):
        m = s.metrics
        n = int(lane["nx"])
        out.append(Lane(
            params=dict(lane), n=n,
            state=tuple(t.detach().cpu().numpy() for t in s.state),
            converged=bool(m.converged), iterations=int(m.iterations),
            levels=_levels(s, m.iterations, n),
            validation={k: float(v) for k, v in errs.items()}))
    return Job(kind=kind, lanes=out, build_s=t1 - t0, step_s=t2 - t1,
               validate_s=t3 - t2, wall_s=t3 - t0)


def bf16(a) -> np.ndarray:
    """``a`` rounded to bfloat16 (to nearest, ties to even), as float64."""
    x = np.asarray(a, np.float32).copy()
    bits = x.view(np.uint32)
    bits += np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))
    bits &= np.uint32(0xFFFF0000)
    return x.astype(np.float64)
