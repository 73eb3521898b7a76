"""The port's driver: solve, sweep, optimize and plot LDC runs.

    python -m anap3_tpu_torch solver=gpu/fsg N=96 Re=1000          # one run
    python -m anap3_tpu_torch -m solver=gpu/sg N=64 Re=100,400,1000  # sweep
    python -m anap3_tpu_torch -m +experiment/validation/ghia=spectral
    python -m anap3_tpu_torch -m +experiment/optimization=corner_smoothing
    python -m anap3_tpu_torch solver=gpu/sg N=12 solver.device=cpu \\
        plots=false                                         # on the host

The counterpart of the root ``main.py`` over the same ``conf/`` tree, with
the same user-facing semantics: Hydra-style overrides (``utils/config``),
the MLflow-compatible file store (``utils/tracking``), the TPE optimizer
(``utils/optimize``) and the plots (``plotting/``). It imports torch, numpy
and the standard library; matplotlib (plots) and mlflow (a remote store)
only on the paths that use them.

Solver groups are the port's: ``fv`` and ``spectral/<name>`` are read as
``gpu/fv`` and ``gpu/<name>`` (``utils/config``). A solver runs on the card
unless the config asks for ``solver.device=cpu``.

Sweeps: ``-m`` groups the jobs by ``parallel/batched.batch_signature``; a
group of two or more that ``batchable`` accepts runs as one batch through
``parallel/batched.run_batched`` (the SG and FV lane kernels, or
``run_batched_fsg``), every other job one by one (``machine.n_jobs`` host
threads). Each round of the optimization is one such batch where the
trials can share it. The optimization starts when an ``interval(lo, hi)``
is given on the command line or in ``hydra.sweeper.params`` (the root
driver needs it on the command line). ``plots=false`` also skips a sweep's
comparison plots.

The device knobs:

- ``platform`` (root): ``cpu`` or ``cuda`` is every solver's device (null
  leaves ``solver.device`` as configured); any other value raises.
- Under ``torchrun`` (``WORLD_SIZE`` > 1) the process group starts first
  (``parallel/distributed.initialize_distributed``: NCCL on the card, gloo
  on the CPU). A batched sweep then splits its lanes over every rank
  (``global_mesh(("sweep",))``) when the rank count divides them, and
  ``machine.mesh_axes: [x]`` splits one SG solve's rows over the ranks
  (``parallel/spatial.spatial_mesh_from_config``, set on ``spatial_mesh``
  of a solver whose class has ``TAKES_SPATIAL_MESH``). Ranks other than 0
  solve alongside rank 0 but track into a temporary store, so the store
  holds each run once.
- The root driver's ``_lane_kernel_split`` has no counterpart: it splits a
  TPU group by the Pallas lane kernel's VMEM budget, and the CUDA lane
  kernels take any lane count.
"""

from __future__ import annotations

import logging
import math
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

from .analysis import validation as V
from .utils import config as C
from .utils import tracking as T
from .utils.config import Interval

REPO_ROOT = Path(__file__).resolve().parent.parent
CONF_DIR = REPO_ROOT / "conf"

log = logging.getLogger("main")

__all__ = ["main", "run_solver", "run_multirun", "run_optimization",
           "run_multirun_batched", "log_solver_results", "compute_objective"]

_LIVE_METRIC_NAMES = {
    "rel_iter": "rel_iter_residual",
    "u_eq": "u_residual",
    "v_eq": "v_residual",
    "continuity": "continuity_residual",
    "energy": "energy",
    "enstrophy": "enstrophy",
}
_PLATFORMS = ("cpu", "cuda")


def _load_dotenv(path=None):
    """Minimal .env loader: KEY=value lines into the environment, without
    overriding what is set."""
    path = Path(path or REPO_ROOT / ".env")
    if not path.exists():
        return
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#") and "=" in line:
            key, _, val = line.partition("=")
            os.environ.setdefault(key.strip(), val.strip())


def _setup_logging():
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=os.environ.get("LOGLEVEL", "INFO"),
            format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s")


def _pin_platform(cfg: dict) -> None:
    """The root ``platform`` knob as the solver's device."""
    platform = cfg.get("platform")
    if platform in (None, ""):
        return
    if str(platform) not in _PLATFORMS:
        raise C.ConfigError(
            f"platform={platform!r}: the port runs on {_PLATFORMS} "
            "(null keeps solver.device)")
    cfg["solver"]["device"] = str(platform)


def _device(cfg: dict) -> str:
    return str(cfg["solver"].get("device", "cuda"))


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _init_distributed_if_configured(cfg: dict) -> None:
    """Start the process group from torchrun's variables (``WORLD_SIZE`` >
    1) on the solver's device; a no-op for one process. Ranks other than 0
    track into a temporary store."""
    if int(os.environ.get("WORLD_SIZE", "0") or 0) <= 1:
        return
    import torch.distributed as dist

    from .parallel.distributed import initialize_distributed

    if initialize_distributed(device=_device(cfg)):
        log.info("Multi-process run: rank %d of %d", dist.get_rank(),
                 dist.get_world_size())


# the store of a rank other than 0: a temporary directory for the process
_RANK_STORE = []


def _tracking_uri(cfg: dict):
    if _rank() != 0:
        if not _RANK_STORE:
            _RANK_STORE.append(tempfile.TemporaryDirectory(
                prefix=f"mlruns-rank{_rank()}-"))
        return _RANK_STORE[0].name
    return cfg.get("mlflow", {}).get("tracking_uri", "./mlruns")


def get_experiment_name(cfg: dict) -> str:
    name = cfg.get("experiment_name", "LDC-Dev")
    prefix = cfg.get("mlflow", {}).get("project_prefix", "") or ""
    if prefix and not name.startswith("/"):
        return f"{prefix}/{name}"
    return name


def setup_tracking(cfg: dict) -> str:
    T.set_tracking_uri(_tracking_uri(cfg))
    name = get_experiment_name(cfg)
    try:
        T.set_experiment(name)
    except Exception as exc:  # a degraded store: a fresh experiment
        name = f"{name}-restored"
        log.warning("set_experiment failed (%s); using %r", exc, name)
        T.set_experiment(name)
    return name


def find_existing_run(cfg: dict) -> str:
    runs = T.search_runs(
        get_experiment_name(cfg),
        params={"Re": cfg["Re"], "nx": cfg["N"]},
        status="FINISHED",
    )
    if not runs:
        raise ValueError(f"No matching run found for N={cfg['N']}, "
                         f"Re={cfg['Re']}")
    run_id = runs[0]["run_id"]
    log.info("Found existing run: %s", run_id[:8])
    return run_id


def _tag_cluster_job():
    """Tag LSF job info when running under a scheduler."""
    job_id = os.environ.get("LSB_JOBID")
    if not job_id:
        return
    T.set_tag("lsf.job_id", job_id)
    desc = f"HPC Job: {os.environ.get('LSB_JOBNAME', '')} (ID: {job_id}"
    idx = os.environ.get("LSB_JOBINDEX", "")
    if idx:
        desc += f", Index: {idx}"
    T.set_tag("mlflow.note.content", desc + ")")


def _live_log(iteration, metrics):
    payload = {}
    for key, name in _LIVE_METRIC_NAMES.items():
        val = metrics.get(key)
        if val is not None and not (isinstance(val, float) and math.isnan(val)):
            if key in ("energy", "enstrophy") and iteration < 10:
                continue
            payload[name] = float(val)
    if payload:
        T.log_metrics(payload, step=iteration)


def _run_name(cfg: dict) -> str:
    # spectral runs are named by their node count N+1
    solver_name = cfg["solver"].get("name", "solver")
    n = cfg["N"] + 1 if solver_name.startswith("spectral") else cfg["N"]
    return f"{solver_name}_N{n}"


def log_solver_results(cfg: dict, solver, parent_run_id: str | None = None,
                       run=None, extra_tags: dict | None = None):
    """Log a SOLVED solver's results (params/metrics/artifacts/tables).

    Returns (run_id, validation_errors). ``run`` may be an already-open run
    (the live-logged path); otherwise one is created and closed here."""
    from .utils.profiling import span

    solver_name = cfg["solver"].get("name", "solver")
    own_run = run is None
    if own_run:
        tags = {"solver": solver_name}
        if extra_tags:
            tags.update(extra_tags)
        if parent_run_id:
            tags.update({"mlflow.parentRunId": parent_run_id,
                         "parent_run_id": parent_run_id, "sweep": "child"})
        with span("cli.track"):
            run = T.start_run(run_name=_run_name(cfg), tags=tags)
            T.log_params(solver.params.to_mlflow())
            T.log_dict(_plain(cfg), "config.yaml")
    try:
        reference_dir = cfg.get("validation", {}).get(
            "reference_dir", "data/validation/fv")
        validation_errors = solver.compute_validation_errors(
            reference_dir=reference_dir, base_dir=REPO_ROOT)
        with span("cli.track"):
            if validation_errors:
                T.log_metrics(validation_errors)

            metrics = solver.metrics.to_mlflow()
            wall = max(solver.metrics.wall_time_seconds, 1e-9)
            metrics["timesteps_per_sec"] = solver.metrics.iterations / wall
            # the first chunk's time (kernel builds and warm-up), so that
            # throughput can be judged net of it
            metrics["first_chunk_seconds"] = getattr(
                solver, "first_chunk_time", 0.0)
            T.log_metrics(metrics)
            if solver.time_series:
                batch = solver.time_series.to_batch()
                if batch:
                    T.log_batch(run.run_id, batch)

            table = solver.validation_table(base_dir=REPO_ROOT)
            if table:
                T.log_table(table, "validation_metrics.json")
            saad = solver.saad_table(base_dir=REPO_ROOT)
            if saad:
                T.log_table(saad, "saad_quantities.json")
            for plot in getattr(solver, "validation_error_plots", []) or []:
                T.log_artifact(plot)

        with span("cli.vts"), tempfile.TemporaryDirectory() as tmpdir:
            vts_path = Path(tmpdir) / "solution.vts"
            solver.save_vtk(vts_path)
            T.log_artifact(vts_path)
        log.info("Done: %d iter, converged=%s, time=%.2fs",
                 solver.metrics.iterations, solver.metrics.converged,
                 solver.metrics.wall_time_seconds)
        return run.run_id, validation_errors
    finally:
        if own_run:
            T.end_run()


def _spatial_mesh(cfg: dict, solver):
    """The x mesh ``machine.mesh_axes: [x]`` asks for, set on the solver."""
    if not getattr(solver, "TAKES_SPATIAL_MESH", False):
        if "x" in (cfg.get("machine", {}).get("mesh_axes") or []):
            log.info("machine.mesh_axes=[x] requested but %s does not "
                     "support spatial sharding; running unsharded",
                     cfg["solver"].get("name", "solver"))
        return
    from .parallel.spatial import spatial_mesh_from_config

    mesh = spatial_mesh_from_config(cfg.get("machine", {}),
                                    nf=int(cfg["N"]) + 1,
                                    device=solver.device)
    if mesh is not None:
        solver.spatial_mesh = mesh
        log.info("Spatial sharding: %d ranks on the x axis", mesh.size())


def run_solver(cfg: dict, parent_run_id: str | None = None):
    """Solve one configuration. Returns (run_id, validation_errors, solver).

    Phase wall times (setup/solve/analysis) are logged as
    ``time_<phase>_seconds`` metrics; the plots phase by generate_plots.
    ``ANAP3_TRACE_DIR`` traces the solve and the analysis (validation,
    tracking writes, VTS export) with torch.profiler."""
    from .utils.profiling import PhaseTimer, device_trace

    timer = PhaseTimer()
    with timer.phase("setup"):
        solver = C.instantiate(cfg["solver"])
        _spatial_mesh(cfg, solver)
    solver_name = cfg["solver"].get("name", "solver")

    parent_run_id = parent_run_id or os.environ.get("MLFLOW_PARENT_RUN_ID")
    tags = {"solver": solver_name}
    if parent_run_id:
        tags.update({"mlflow.parentRunId": parent_run_id,
                     "parent_run_id": parent_run_id, "sweep": "child"})

    with T.start_run(run_name=_run_name(cfg), tags=tags) as run:
        T.log_params(solver.params.to_mlflow())
        T.log_dict(_plain(cfg), "config.yaml")
        _tag_cluster_job()
        solver._log_callback = _live_log
        log.info("Solving: %s N=%s Re=%s", solver_name, cfg["N"], cfg["Re"])

        with device_trace(os.environ.get("ANAP3_TRACE_DIR")):
            with timer.phase("solve"):
                solver.solve()
            with timer.phase("analysis"):
                run_id, validation_errors = log_solver_results(
                    cfg, solver, parent_run_id, run=run)
        T.log_metrics(timer.as_metrics())
        return run_id, validation_errors, solver


# matplotlib's pyplot state machine is not thread-safe; plot generation is
# serialized even when solves run on the machine.n_jobs thread pool
_PLOT_LOCK = threading.Lock()


def generate_plots(cfg: dict, run_id: str, output_dir=None):
    if not cfg.get("plots", True):  # before the matplotlib import cost
        log.info("Plot generation disabled (plots=false)")
        return
    if _rank() != 0:
        return

    from .plotting import generate_plots_for_run
    from .utils.profiling import span

    t0 = time.time()
    try:
        with _PLOT_LOCK:
            generate_plots_for_run(
                run_id=run_id,
                tracking_uri=cfg.get("mlflow", {}).get("tracking_uri",
                                                       "./mlruns"),
                output_dir=output_dir or Path("outputs/plots") / run_id[:8],
                solver_name=cfg["solver"].get("name", "solver"),
                N=cfg["N"],
                Re=cfg["Re"],
                data_dir=REPO_ROOT / "data",
            )
    except Exception as exc:
        log.warning("Plotting failed (likely diverged run): %s", exc)
        return
    # plots run after the child run closed; re-attach to record the phase
    try:
        with span("cli.track"), T.attach_run(run_id):
            T.log_metrics({"time_plots_seconds": round(time.time() - t0, 4)})
    except Exception as exc:
        log.warning("Could not log plot timing: %s", exc)


def compute_objective(cfg: dict, validation_errors: dict, solver) -> float:
    objective_type = cfg.get("optuna", {}).get("objective", "fv_l2_error")
    if objective_type == "multi":
        raise ValueError("Multi-objective optimization is not supported; use "
                         "objective=fv_l2_error or objective=botella_vortex")
    if objective_type == "botella_vortex":
        obj = V.botella_vortex_objective(solver.metrics, cfg["Re"],
                                         base_dir=REPO_ROOT)
    else:
        obj = V.fv_l2_objective(validation_errors)
    log.info("Objective (%s): %.6e", objective_type, obj)
    return obj


def _plain(node):
    """Recursively convert Interval and Path values for YAML dumping."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_plain(v) for v in node]
    if isinstance(node, Interval):
        return f"interval({node.lo}, {node.hi})"
    if isinstance(node, Path):
        return str(node)
    return node


# ---------------------------------------------------------------------------
# Sweep / multirun driver
# ---------------------------------------------------------------------------


def _get_or_create_parent(cfg: dict) -> str:
    """Create/reuse a parent run per resolved sweep_name."""
    sweep_name = str(cfg.get("sweep_name", "sweep"))
    setup_tracking(cfg)
    existing = T.search_runs(get_experiment_name(cfg),
                             tags={"is_parent": "true",
                                   "mlflow.runName": sweep_name})
    if existing:
        return existing[0]["run_id"]
    run = T.create_detached_run(run_name=sweep_name,
                                tags={"is_parent": "true"})
    return run.run_id


def _sweep_mesh(jobs):
    """The ("sweep",) mesh over every rank when there are several and they
    divide the lanes; None otherwise."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return None
    world = dist.get_world_size()
    if world <= 1 or len(jobs) % world:
        return None
    from .parallel.distributed import global_mesh

    log.info("Sharding %d lanes over %d ranks", len(jobs), world)
    return global_mesh(("sweep",), device=_device(jobs[0]))


def run_multirun_batched(jobs):
    """All the jobs of a batchable group as ONE batch
    (``parallel/batched.run_batched``); each lane is logged as its own
    child run. Returns the objectives."""
    from .parallel.batched import run_batched

    solvers = [C.instantiate(cfg["solver"]) for cfg in jobs]
    lane_results = run_batched(solvers, mesh=_sweep_mesh(jobs))

    # wall_time is the SHARED batch wall: the lanes run together, so an even
    # split would fabricate per-lane times. Children are tagged
    # wall_time_scope=batch, and the aggregate rate is logged on the parent.
    batch_tags = {"wall_time_scope": "batch",
                  "batch_lanes": str(len(jobs))}
    objectives = []
    parent_ids = {}
    for cfg, solver in zip(jobs, solvers):
        parent_id = _get_or_create_parent(cfg)
        parent_ids[parent_id] = cfg
        run_id, errors = log_solver_results(cfg, solver, parent_id,
                                            extra_tags=batch_tags)
        generate_plots(cfg, run_id)
        objectives.append(compute_objective(cfg, errors, solver))
    total_steps = sum(r.iterations for r in lane_results)
    shared_wall = max(lane_results[0].wall_time, 1e-9)
    for parent_id in parent_ids:
        with T.attach_run(parent_id):
            T.log_metrics({
                "batch_wall_time_seconds": shared_wall,
                "aggregate_lane_steps_per_sec": total_steps / shared_wall,
            })
    _sweep_comparison_plots(parent_ids)
    return objectives


def _sweep_comparison_plots(parent_ids):
    if _rank() != 0:
        return
    for parent_id, cfg in parent_ids.items():
        if not cfg.get("plots", True):
            continue
        try:
            from .plotting import generate_comparison_plots_for_sweep

            generate_comparison_plots_for_sweep(
                [parent_id],
                cfg.get("mlflow", {}).get("tracking_uri", "./mlruns"),
                Path("outputs/comparisons"), data_dir=REPO_ROOT / "data")
        except Exception as exc:
            log.warning("Comparison plotting failed: %s", exc)


def _collect_intervals(cfg, prefix=""):
    out = {}
    if isinstance(cfg, dict):
        for k, v in cfg.items():
            path = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, Interval):
                out[path] = v
            elif isinstance(v, dict):
                out.update(_collect_intervals(v, path))
    return out


def _sweeper_intervals(cfg) -> dict:
    """The ``interval(lo, hi)`` values of ``hydra.sweeper.params``."""
    out = {}
    for key, val in C.sweeper_params(cfg).items():
        parsed = val if isinstance(val, Interval) else \
            C._parse_value(str(val), allow_sweep=True)
        if isinstance(parsed, Interval):
            out[key] = parsed
    return out


def run_multirun(overrides):
    from .parallel.batched import batch_signature, batchable

    jobs = C.expand_multirun(CONF_DIR, overrides)
    for job in jobs:
        _pin_platform(job)
    _init_distributed_if_configured(jobs[0])

    # the optimization: an Interval on the command line or in the sweeper
    base = jobs[0]
    intervals = _collect_intervals(base)
    if intervals or _sweeper_intervals(base):
        return run_optimization(overrides, intervals)

    if base.get("machine", {}).get("vmap_sweeps", True) \
            and not base.get("plot_only"):
        # group jobs by batch signature: a mixed sweep like
        # solver=fv,spectral/sg x N x Re batches each homogeneous (solver,
        # N, ...) group over its Re/corner lanes, and runs the singletons
        # one by one
        groups, order = {}, []
        for i, cfg in enumerate(jobs):
            sig = batch_signature(cfg)
            key = sig if sig is not None else ("serial", i)
            groups.setdefault(key, []).append(cfg)
            if key not in order:
                order.append(key)
        objectives, serial_pool = [], []

        def flush_serial():
            if serial_pool:
                objectives.extend(_run_serial_jobs(serial_pool))
                serial_pool.clear()

        for key in order:
            group = groups[key]
            if len(group) >= 2 and key[0] != "serial" and batchable(group):
                flush_serial()
                log.info("=== batched group: %d lanes ===", len(group))
                objectives.extend(run_multirun_batched(group))
            else:
                # pool consecutive non-batchable members so machine.n_jobs
                # host threads can run them concurrently
                serial_pool.extend(group)
        flush_serial()
        return objectives

    return _run_serial_jobs(jobs)


def _run_serial_jobs(jobs):
    """Run non-batchable sweep members, ``machine.n_jobs`` host threads at
    a time (the tracking layer's run stack is thread-local); ``n_jobs <=
    1`` or plot_only sweeps run strictly in order."""
    n_jobs = 1
    if jobs:
        try:
            n_jobs = int(jobs[0].get("machine", {}).get("n_jobs", 1) or 1)
        except (TypeError, ValueError):
            n_jobs = 1
    if (n_jobs > 1 and len(jobs) > 1
            and not any(cfg.get("plot_only") for cfg in jobs)):
        return _run_threaded_jobs(jobs, n_jobs)

    parent_ids = {}
    objectives = []
    for i, cfg in enumerate(jobs):
        log.info("=== multirun job %d/%d ===", i + 1, len(jobs))
        parent_id = _get_or_create_parent(cfg)
        parent_ids[parent_id] = cfg
        if cfg.get("plot_only"):
            run_id = find_existing_run(cfg)
            generate_plots(cfg, run_id)
            continue
        try:
            run_id, errors, solver = run_solver(cfg, parent_run_id=parent_id)
            generate_plots(cfg, run_id)
            objectives.append(compute_objective(cfg, errors, solver))
        except FloatingPointError as exc:
            log.warning("Job diverged: %s", exc)
            objectives.append(float("inf"))

    _sweep_comparison_plots(parent_ids)
    return objectives


def _run_threaded_jobs(jobs, n_jobs):
    from concurrent.futures import ThreadPoolExecutor

    # parent runs are created SERIALLY first: creation mutates the global
    # experiment state and must stay race-free
    parent_ids = {}
    job_parents = []
    for cfg in jobs:
        parent_id = _get_or_create_parent(cfg)
        parent_ids[parent_id] = cfg
        job_parents.append(parent_id)

    def run_one(arg):
        i, (cfg, parent_id) = arg
        log.info("=== multirun job %d/%d (threaded) ===", i + 1, len(jobs))
        try:
            run_id, errors, solver = run_solver(cfg, parent_run_id=parent_id)
            generate_plots(cfg, run_id)
            return compute_objective(cfg, errors, solver)
        except FloatingPointError as exc:
            log.warning("Job diverged: %s", exc)
            return float("inf")

    log.info("Host-thread pool: %d jobs on %d threads (machine.n_jobs)",
             len(jobs), n_jobs)
    with ThreadPoolExecutor(max_workers=n_jobs) as pool:
        objectives = list(pool.map(run_one,
                                   enumerate(zip(jobs, job_parents))))
    _sweep_comparison_plots(parent_ids)
    return objectives


def run_optimization(overrides, interval_params):
    """TPE optimization loop over interval + categorical sweep params; each
    round's trials run as one batch where they can share it."""
    from .parallel.batched import batchable
    from .utils.optimize import TPESampler

    base_overrides = [ov for ov in overrides if "interval(" not in ov]
    base = C.compose(CONF_DIR, base_overrides)
    _pin_platform(base)
    optuna_cfg = base.get("optuna", {})

    space = dict(interval_params)
    for key, val in C.sweeper_params(base).items():
        if key in space:
            continue
        parsed = C._parse_value(str(val), allow_sweep=True)
        if isinstance(parsed, (Interval, list)):
            space[key] = parsed

    sampler = TPESampler(
        space,
        n_startup_trials=int(optuna_cfg.get("n_startup_trials", 5)),
        seed=int(optuna_cfg.get("seed", 0)),
        direction=str(optuna_cfg.get("direction", "minimize")),
    )
    n_trials = int(optuna_cfg.get("n_trials", 15))
    parent_id = _get_or_create_parent(base)

    # trials run in batches of machine.batch_lanes (or optuna.batch_size)
    # candidates a round, ask and tell; candidates that cannot share a
    # batch (a categorical N makes the shapes differ) run one by one
    batch_size = int(optuna_cfg.get("batch_size", 0)) \
        or int(base.get("machine", {}).get("batch_lanes", 1))
    batch_size = max(1, min(batch_size, n_trials))

    done = 0
    while done < n_trials:
        k = min(batch_size, n_trials - done)
        asks = sampler.ask_batch(k)
        trials = []
        for params in asks:
            trial_overrides = list(base_overrides) + [
                f"{key}={v}" for key, v in params.items()]
            cfg = C.compose(CONF_DIR, trial_overrides)
            _pin_platform(cfg)
            trials.append((params, cfg))
        log.info("=== optimization round: trials %d-%d/%d (%d lanes) ===",
                 done + 1, done + k, n_trials, k)

        cfgs = [cfg for _, cfg in trials]
        values = None
        if k >= 2 and batchable(cfgs):
            try:
                values = run_multirun_batched(cfgs)
            except Exception as exc:
                # not re-run one by one: the batch may have logged some
                # lanes' child runs already, and a rerun would log them
                # twice; the sampler is told the round failed
                log.warning("Batched trial round failed (%s); recording the "
                            "round's trials as failed (inf)", exc)
                values = [float("inf")] * k
        if values is None:
            values = []
            for params, cfg in trials:
                try:
                    run_id, errors, solver = run_solver(
                        cfg, parent_run_id=parent_id)
                    values.append(compute_objective(cfg, errors, solver))
                except Exception as exc:
                    log.warning("Trial failed: %s", exc)
                    values.append(float("inf"))
        for (params, _cfg), value in zip(trials, values):
            sampler.tell(params, value)
        done += k

    best_params, best_value = sampler.best
    log.info("Best trial: %s -> %.6e", best_params, best_value)
    # an Optuna-style summary on the parent run
    with T.attach_run(parent_id):
        T.log_table(
            [{"trial": i, **p, "objective": v}
             for i, (p, v) in enumerate(sampler.trials)],
            "optuna_trials.json")
        T.log_metrics({"best_objective": best_value})
        for k, v in best_params.items():
            if isinstance(v, (int, float)):
                T.log_metrics({f"best_{k.replace('.', '_')}": float(v)})
    return best_value


# ---------------------------------------------------------------------------


def main(argv=None):
    _load_dotenv()
    _setup_logging()
    argv = list(sys.argv[1:] if argv is None else argv)
    multirun = False
    overrides = []
    for a in argv:
        if a in ("-m", "--multirun"):
            multirun = True
        else:
            overrides.append(a)

    if multirun:
        return run_multirun(overrides)

    cfg = C.compose(CONF_DIR, overrides)
    _pin_platform(cfg)
    _init_distributed_if_configured(cfg)
    log.info("Solver: %s, N=%s, Re=%s", cfg["solver"].get("name"), cfg["N"],
             cfg["Re"])
    log.info("Tracking experiment: %s", setup_tracking(cfg))

    if cfg.get("plot_only"):
        run_id = find_existing_run(cfg)
        generate_plots(cfg, run_id)
        return None

    run_id, errors, solver = run_solver(cfg)
    generate_plots(cfg, run_id)
    return compute_objective(cfg, errors, solver)
