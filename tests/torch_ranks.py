"""Rank jobs of the multi-process CPU tests of anap3_tpu_torch.

Each function runs on every rank of a gloo world that
``anap3_tpu_torch.parallel.distributed.launch_local_ranks`` spawns (one CPU
thread a rank), imports torch and the port only, writes its arrays from
rank 0 into ``out_dir`` as ``.npz`` and returns a JSON-able summary. The
test files (``test_torch_spatial.py``, ``test_torch_distributed.py``) hold
the outputs against the JAX package and the port's unsharded paths in the
pytest process.
"""

from __future__ import annotations

import hashlib
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.models.runner import METRIC_KEYS, run_fixed_point
from anap3_tpu_torch.models.spectral import SGSolver
from anap3_tpu_torch.ops.sg_lane_kernels import sg_lane_runner
from anap3_tpu_torch.parallel import spatial as S
from anap3_tpu_torch.parallel import sweep as TS
from anap3_tpu_torch.parallel.fsg_sweep import run_batched_fsg

N = 15  # nf = 16 rows: 4 blocks of 4
# the float64 solve's tolerance (495 steps at N=15 Re=100 from rest)
RUN64_TOL = 2e-3
# the float32 solve at tests/test_parallel.py's 1e-5 converges at step
# 6,836; the ranks take the unsharded run's state at this step and run the
# sharded runner from there, through the convergence test. A sharded step
# is 6 collectives, ~6 ms on an idle 8-core host (the whole case from rest,
# this module's __main__, takes 42-43 s) and ~10 ms a collective under the
# full suite's load, so the 4-rank job keeps to ~1,200 sharded steps.
F32_START = 6600


def spec(n=N, Re=100.0, **over):
    """tests/test_parallel.py's make_params (sg.yaml numerics), float64."""
    kw = dict(name="spectral", Re=Re, nx=n, ny=n, basis_type="chebyshev",
              CFL=1.5, beta_squared=5.0, corner_treatment="smoothing",
              corner_smoothing=0.15, tolerance=1e-4, max_iterations=20000,
              dtype="float64")
    kw.update(over)
    return kw


def sweep_spec(Re, cs=0.15, cfl=1.5, **over):
    """tests/test_torch_sweep.py's lanes: N=12, tol 1e-3, float64."""
    kw = spec(12, Re, CFL=cfl, corner_smoothing=cs, tolerance=1e-3,
              max_iterations=1500)
    kw.update(over)
    return kw


SWEEP_LANES = [sweep_spec(100.0), sweep_spec(400.0, 0.10, 1.2),
               sweep_spec(1000.0, 0.20), sweep_spec(200.0, 0.12, 1.4)]


def random_state(ops, seed):
    """A developing-flow stand-in: seeded interior values, the lid's BCs."""
    rng = np.random.default_rng(seed)
    nf = ops.nf
    u, v, p = (torch.as_tensor(0.1 * rng.standard_normal(shape),
                               device=ops.device)
               for shape in ((nf, nf), (nf, nf), (nf - 2, nf - 2)))
    u, v = T.enforce_bc(ops, u, v)
    return u, v, p


def _np(t):
    return t.detach().cpu().numpy()


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(_np(t).tobytes())
    return h.hexdigest()


def _save(out_dir, name, arrays):
    if dist.get_rank() == 0:
        np.savez(Path(out_dir) / f"{name}.npz", **arrays)


def _solve(mesh, ops_sh, state, tol, chunk=200, start=0):
    res = run_fixed_point(
        None, lambda s: (s[0], s[1]), S.shard_state(mesh, state),
        tolerance=tol, max_iterations=20000, chunk=chunk,
        start_iteration=start,
        chunk_runner=lambda c, t, m: S.make_sharded_chunk_runner(
            mesh, ops_sh, c, t, 10, convergence_metric=m))
    u, v, p = S.gather_state(mesh, res.state)
    arrays = {"u": _np(u), "v": _np(v), "p": _np(S.unpad_pressure(p)),
              "iterations": res.iterations, "converged": res.converged,
              "history_iters": res.history_iters}
    arrays.update({k: np.asarray(res.history[k]) for k in METRIC_KEYS})
    return arrays


def _solve32(mesh, state, start=0):
    """The float32 sharded solve at tol 1e-5 from ``state`` (whole fields)
    at step ``start``."""
    p32 = SpectralParameters(device="cpu", **spec(dtype="float32"))
    whole32, _ = S.build_sharded_ops(p32)
    _, xr, xw = S.mesh_axis(mesh, "x")
    return _solve(mesh, S.shard_ops(whole32, xr, xw),
                  (state.u, state.v, S.pad_pressure(state.p)), 1e-5,
                  start=start)


def from_rest32(out_dir):
    """4 ranks: the float32 case from rest (``__main__``)."""
    mesh = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("x",))
    ops32, _ = T.build_spectral_ops(SpectralParameters(
        device="cpu", **spec(dtype="float32")))
    _save(out_dir, "rest32", _solve32(mesh, T.initial_state(ops32)))
    return {}


def warm32(out_dir):
    """The unsharded float32 run from rest to step F32_START, saved for
    ``spatial_job`` as ``warm32.npz`` (made before the ranks start)."""
    ops32, _ = T.build_spectral_ops(SpectralParameters(
        device="cpu", **spec(dtype="float32")))
    state = run_fixed_point(lambda s: T.sg_step(ops32, s),
                            lambda s: (s.u, s.v), T.initial_state(ops32),
                            tolerance=1e-5, max_iterations=F32_START,
                            chunk=200).state
    np.savez(Path(out_dir) / "warm32.npz", **dict(zip("uvp", map(_np,
                                                              state))))


def spatial_job(out_dir):
    """4 ranks: the sharded step, chunk runner, solver, checkpoint resume,
    the singular refusal and spatial_mesh_from_config."""
    t0 = time.time()
    world = dist.get_world_size()
    p = SpectralParameters(device="cpu", **spec())
    ops, _ = T.build_spectral_ops(p)
    whole, _ = S.build_sharded_ops(p)
    info = {}

    # the step on a (1 x 4) mesh: 1 and 5 steps from a seeded state
    mesh14 = init_device_mesh("cpu", (1, world), mesh_dim_names=("sweep",
                                                                 "x"))
    _, xr, xw = S.mesh_axis(mesh14, "x")
    step = S.make_sharded_step(mesh14)
    ops14 = S.shard_ops(whole, xr, xw)
    u0, v0, p0 = random_state(ops, 0)
    state = S.shard_state(mesh14, (u0[None], v0[None],
                                   S.pad_pressure(p0)[None]),
                          batch_axis="sweep")
    out = {"u0": _np(u0), "v0": _np(v0), "p0": _np(p0)}
    for k in range(1, 6):
        state = step(ops14, *state)
        if k in (1, 5):
            u, v, pp = S.gather_state(mesh14, state, batch_axis="sweep")
            out.update({f"u{k}": _np(u[0]), f"v{k}": _np(v[0]),
                        f"p{k}": _np(S.unpad_pressure(pp[0]))})
    _save(out_dir, "step14", out)

    # the batched step on a (2 x 2) mesh: two lanes, 2 blocks of rows each
    mesh22 = init_device_mesh("cpu", (2, world // 2),
                              mesh_dim_names=("sweep", "x"))
    _, xr, xw = S.mesh_axis(mesh22, "x")
    lanes = [random_state(ops, 1), random_state(ops, 2)]
    whole_b = tuple(torch.stack(f) for f in zip(*[
        (u, v, S.pad_pressure(pi)) for u, v, pi in lanes]))
    state = S.shard_state(mesh22, whole_b, batch_axis="sweep")
    state = S.make_sharded_step(mesh22)(
        S.shard_ops(whole, xr, xw), *state)
    u, v, pp = S.gather_state(mesh22, state, batch_axis="sweep")
    _save(out_dir, "step22", {
        "u0": _np(whole_b[0]), "v0": _np(whole_b[1]),
        "p0": _np(S.unpad_pressure(whole_b[2])), "u1": _np(u), "v1": _np(v),
        "p1": _np(S.unpad_pressure(pp))})

    # the chunk runner through run_fixed_point in float32, from the
    # unsharded run's state at step F32_START
    x_mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("x",))
    with np.load(Path(out_dir) / "warm32.npz") as f:
        warm = T.state_from_numpy((f["u"], f["v"], f["p"]), "cpu",
                                  torch.float32)
    _save(out_dir, "run32", _solve32(x_mesh, warm, start=F32_START))

    # SGSolver with spatial_mesh, end to end in float64 from rest: its
    # solve is the sharded chunk runner through run_fixed_point
    solver = SGSolver(device="cpu", **spec(tolerance=RUN64_TOL,
                                           chunk_size=200))
    solver.spatial_mesh = x_mesh
    solver.solve()
    m = solver.compute_vortex_metrics() if dist.get_rank() == 0 else {}
    series = {k: np.asarray(v) for k, v in vars(solver.time_series).items()}
    _save(out_dir, "solver", {
        "u": _np(solver.state.u), "v": _np(solver.state.v),
        "p": _np(solver.state.p), "iterations": solver.metrics.iterations,
        "converged": solver.metrics.converged,
        "psi_min": m.get("psi_min", np.nan),
        "omega_center": m.get("omega_center", np.nan), **series})

    # a checkpointed sharded solve resumed against an uninterrupted one
    ck = Path(out_dir) / "ck"

    def make(**kw):
        s = SGSolver(device="cpu", **spec(tolerance=0.0, chunk_size=20,
                                          checkpoint_every_chunks=1, **kw))
        s.spatial_mesh = x_mesh
        return s

    make(max_iterations=40, checkpoint_dir=str(ck)).solve()
    resumed = make(max_iterations=60, checkpoint_dir=str(ck))
    resumed.solve()
    straight = make(max_iterations=60)
    straight.solve()
    info["resume"] = {
        "iterations": [resumed.metrics.iterations,
                       straight.metrics.iterations],
        "bit_equal": all(torch.equal(a, b) for a, b in
                         zip(resumed.state, straight.state)),
        "files": sorted(f.name for f in ck.glob("ckpt_*.npz"))}

    # the singular lid is refused under a mesh
    sing = SGSolver(device="cpu", **spec(corner_treatment="singular"))
    sing.spatial_mesh = x_mesh
    try:
        sing.solve()
        info["singular"] = None
    except ValueError as exc:
        info["singular"] = str(exc)

    # spatial_mesh_from_config: every rank or none
    info["mesh_from_config"] = {
        f"{axes}:{nf}": getattr(S.spatial_mesh_from_config(
            {"mesh_axes": [axes]}, nf=nf, device="cpu"), "size",
            lambda: None)()
        for axes, nf in (("x", 16), ("sweep", 16), ("x", 13), ("x", 18))}
    info["seconds"] = time.time() - t0
    return info


def _sweep(mesh, specs, **kw):
    plist = [SpectralParameters(device="cpu", **s) for s in specs]
    ops_list = [T.build_spectral_ops(p)[0] for p in plist]
    states = TS.stack_states([T.initial_state(o) for o in ops_list])
    return TS.run_batched_sweep(
        None, lambda s: (s.u, s.v), TS.stack_ops(ops_list), states,
        mesh=mesh, lane_runner=sg_lane_runner(ops_list, plist[0]), **kw)


def _sweep_summary(res) -> dict:
    return {"iterations": [int(i) for i in res.iterations],
            "converged": [bool(c) for c in res.converged],
            "diverged": [bool(d) for d in res.diverged],
            "state_sha256": _digest(res.states),
            "history_sha256": hashlib.sha256(np.stack(
                [res.history[k] for k in METRIC_KEYS]).tobytes()).hexdigest()}


def distributed_job(out_dir):
    """2 ranks: the mesh sweep (one chunk and chunked), B % W, the FSG
    sweep over the mesh and the scaling probe's keys."""
    from anap3_tpu_torch.parallel.scaling import measure_scaling

    t0 = time.time()
    mesh = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("sweep",))
    info = {}
    for name, chunk in (("one_chunk", 1500), ("chunked", 100)):
        res = _sweep(mesh, SWEEP_LANES, tolerance=1e-3, max_iterations=1500,
                     chunk=chunk)
        arrays = {f: _np(t) for f, t in zip(("u", "v", "p"), res.states)}
        arrays.update({"iterations": res.iterations,
                       "converged": res.converged,
                       "diverged": res.diverged,
                       "history_iters": res.history_iters})
        arrays.update({k: res.history[k] for k in METRIC_KEYS})
        _save(out_dir, f"sweep_{name}", arrays)
        info[name] = _sweep_summary(res)
    try:
        _sweep(mesh, SWEEP_LANES[:3], tolerance=1e-3, max_iterations=10)
        info["indivisible"] = None
    except ValueError as exc:
        info["indivisible"] = str(exc)

    fsg = [SpectralParameters(device="cpu", **spec(
        24, Re, multigrid="fsg", n_levels=2, tolerance=1e-3,
        max_iterations=5000, corner_smoothing=cs))
        for Re, cs in ((100.0, 0.15), (400.0, 0.10))]
    with_mesh = run_batched_fsg(fsg, mesh=mesh)
    alone = run_batched_fsg(fsg)
    info["fsg"] = {
        "levels": [[(lv["n"], lv["iterations"]) for lv in r.levels]
                   for r in with_mesh],
        "levels_alone": [[(lv["n"], lv["iterations"]) for lv in r.levels]
                         for r in alone],
        "bit_equal": all(torch.equal(a, b) for ra, rb in zip(with_mesh, alone)
                         for a, b in zip(ra.state, rb.state))}
    info["scaling"] = measure_scaling(n=15, b_per_dev=1, chunk=10, calls=2,
                                      device="cpu")
    info["seconds"] = time.time() - t0
    return info


def tp_indivisible_job():
    """3 ranks: only rank 0 asks for the x-sharded rate at N=15 (16 rows).
    It must raise before any collective: one would wait for the other
    ranks, which call nothing, until the launcher's timeout."""
    from anap3_tpu_torch.parallel.scaling import measure_tp_scaling

    if dist.get_rank() != 0:
        return {"error": None}
    try:
        measure_tp_scaling(n=15, device="cpu")
        return {"error": None}
    except ValueError as exc:
        return {"error": str(exc)}


def sleep_job(seconds):
    """A rank that outlives its launcher's timeout."""
    time.sleep(float(seconds))
    return {}


def fail_job():
    """Rank 1 fails while rank 0 waits for it at a barrier."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()
    return {}


if __name__ == "__main__":
    # PYTHONPATH=. python tests/torch_ranks.py: tests/test_parallel.py's
    # float32 case whole, from rest on 4 gloo ranks, against the port's
    # unsharded run; prints one JSON line
    import json
    import tempfile

    from anap3_tpu_torch.parallel.distributed import launch_local_ranks

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        launch_local_ranks(4, from_rest32, {"out_dir": tmp}, device="cpu",
                           timeout=900)
        seconds = time.time() - t0
        with np.load(Path(tmp) / "rest32.npz") as f:
            d = {k: f[k] for k in f.files}
    ops32, _ = T.build_spectral_ops(SpectralParameters(
        device="cpu", **spec(dtype="float32")))
    ref = run_fixed_point(lambda s: T.sg_step(ops32, s),
                          lambda s: (s.u, s.v), T.initial_state(ops32),
                          tolerance=1e-5, max_iterations=20000, chunk=200)
    u_ref = _np(ref.state.u)
    err = np.abs(d["u"] - u_ref)
    print(json.dumps({
        "sharded_iterations": int(d["iterations"]),
        "unsharded_iterations": int(ref.iterations),
        "converged": [bool(d["converged"]), bool(ref.converged)],
        "u_max_abs_err": float(err.max()),
        "u_max_rel_err": float(err.max() / np.abs(u_ref).max()),
        # <= 1 is within the test's rtol 1e-4 / atol 1e-5
        "u_bound_ratio": float(np.max(err / (1e-5 + 1e-4 * np.abs(u_ref)))),
        "sharded_seconds": round(seconds, 1)}))
