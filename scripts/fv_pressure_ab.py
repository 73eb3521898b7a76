#!/usr/bin/env python3
"""Time the FV kernels, the FV iteration and the FV N=128 solves of several
checkouts of this repository on one CUDA card, in turns, and hash a chunk's
output so that bit-equality between them is shown.

    python3 scripts/fv_pressure_ab.py build/parent . . build/parent

Each argument is the root of a checkout. Each runs in a process of its own
(that checkout's package, its kernels built from its own sources), in the
order given, so that versions are compared on one card within one call.
The first line is the card's name and power limit; then one JSON line per
checkout:

- ``launches`` and ``kernel_ms``: by each checkout's own
  ``fv_kernels.KERNELS`` names, the launches of one SIMPLE iteration (from
  the launch counters of a 10-iteration chunk) and the time of that
  iteration's launches of each kernel (the bench entry of the library,
  CUDA events over 200 repetitions) at 128x128, float32 and float64, on
  the workspace of one step from a seeded state; ``kernel_alone_ms`` the
  same launches without the phase folded into them, where the checkout's
  ``bench_kernel`` takes ``folded``;
- ``iter_ms``: ms per SIMPLE iteration of a 100-iteration chunk from rest
  at 128x128, float32 with B = 1, 3, 8 lanes and float64 with B = 1;
- ``fv_solve``: FV N=128 Re=100 and Re=1000 tol 1e-6 float32 through
  ``FVSolver.solve`` (as phases 5 and 6 of chip_smoke.py): iterations and
  wall;
- ``sha256``: SHA-256 (first 16 hex digits) of u, v, p, mx, my and the
  rows after a 100-iteration chunk from seeded states (numpy
  ``default_rng``) at ny x nx = 12x16, 17x23, 128x128 and 257x130,
  float32 and float64, one lane (``fv_chunk_run``) and three lanes (Re
  100, 400, 1000 with their relaxations and lids; ``fv_lanes_chunk_run``).

It uses only what every checkout since the FV lane kernels has:
``fv_kernels.KERNELS`` / ``LAUNCHES`` / ``statics`` / ``bench_workspace``
/ ``bench_kernel`` / ``make_fv_chunk_runner``,
``fv_lane_kernels.make_fv_lane_runner`` and ``FVSolver``.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

K = 16
CHUNK = 100
# (Re, alpha_uv, alpha_p, lid_velocity) of the lanes, as chip_smoke.py
LANES = [(100.0, 0.4, 0.2, 1.0), (400.0, 0.6, 0.3, 1.0),
         (1000.0, 0.5, 0.25, 1.5)]
HASH_SHAPES = [(12, 16), (17, 23), (128, 128), (257, 130)]


def cuda_ms(torch, fn, reps):
    """Milliseconds per call of ``fn`` by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from anap3_tpu_torch.models import fv as fvm
    from anap3_tpu_torch.models.params import FVParameters
    from anap3_tpu_torch.ops import fv_kernels as fvk
    from anap3_tpu_torch.ops import fv_lane_kernels as fvl
    from anap3_tpu_torch.parallel.sweep import stack_states

    if not Path(fvk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fvk.__file__}, not from {root}")

    def params(dt, lane=LANES[0], n=(128, 128), **kw):
        Re, auv, ap, lid = lane  # conf/solver/fv.yaml numerics
        base = dict(Re=Re, ny=n[0], nx=n[1], convection_scheme="TVD",
                    limiter="MUSCL", alpha_uv=auv, alpha_p=ap,
                    lid_velocity=lid, linear_solver_tol=1e-9,
                    rhie_chow="compact", corner_treatment="none",
                    fv_inner_iters=K, dtype=dt, device="cuda",
                    chunk_size=1000, convergence_metric="auto")
        base.update(kw)
        return FVParameters(**base)

    def seeded(ops, seed):
        rng = np.random.default_rng(seed)
        ny, nx = ops.ny, ops.nx
        return fvm.fv_state_from_numpy(
            [0.05 * rng.standard_normal(s) for s in ((ny, nx),) * 3
             + ((ny, nx - 1), (ny - 1, nx))], "cuda", ops.dtype)

    def digest(x):
        return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()
                              ).hexdigest()[:16]

    out = {"root": str(root), "launches": {}, "kernel_ms": {},
           "iter_ms": {}, "sha256": {}}
    for dt in ("float32", "float64"):
        p = params(dt)
        ops = fvm.build_fv_ops(p)[0]
        S = fvk.statics(p, ops)
        fvk.reset_counts()
        fvk.make_fv_chunk_runner(p, ops, 10, 1e-30, 10, K)(
            fvm.initial_state(ops), 0, float("inf"))
        torch.cuda.synchronize()
        out["launches"][dt] = {k: n / 10 for k, n in fvk.LAUNCHES.items()}
        ws = fvk.bench_workspace(S, ops, seeded(ops, 0), K)
        out["kernel_ms"][dt] = {
            name: cuda_ms(torch, lambda: fvk.bench_kernel(
                S, ops, ws, name, K, 200), 1) / 200
            for name in fvk.KERNELS}
        if "folded" in inspect.signature(fvk.bench_kernel).parameters:
            out.setdefault("kernel_alone_ms", {})[dt] = {
                name: cuda_ms(torch, lambda: fvk.bench_kernel(
                    S, ops, ws, name, K, 200, folded=False), 1) / 200
                for name in fvk.KERNELS}
        for B in ((1, 3, 8) if dt == "float32" else (1,)):
            pl = [params(dt, LANES[b % 3]) for b in range(B)]
            ol = [fvm.build_fv_ops(q)[0] for q in pl]
            if B == 1:
                run = fvk.make_fv_chunk_runner(pl[0], ol[0], CHUNK, 1e-30,
                                               10, K)
                st = fvm.initial_state(ol[0])
                fn = lambda: run(st, 0, float("inf"))  # noqa: E731
            else:
                run = fvl.make_fv_lane_runner(pl, ol, CHUNK, 1e-30, 10, K)
                st = stack_states([fvm.initial_state(o) for o in ol])
                fn = lambda: run(st, 0)  # noqa: E731
            out["iter_ms"][f"{dt} B={B}"] = cuda_ms(torch, fn, 2) / CHUNK
        for n in HASH_SHAPES:
            pl = [params(dt, lane, n) for lane in LANES]
            ol = [fvm.build_fv_ops(q)[0] for q in pl]
            states = [seeded(o, b + 1) for b, o in enumerate(ol)]
            one = fvk.make_fv_chunk_runner(pl[0], ol[0], CHUNK, 1e-30, 10,
                                           K)(states[0], 0, float("inf"))
            lanes = fvl.make_fv_lane_runner(pl, ol, CHUNK, 1e-30, 10, K)(
                stack_states(states), 0)
            torch.cuda.synchronize()
            for B, (state, rows) in ((1, (one[0], one[4])),
                                     (3, (lanes[0], lanes[2]))):
                out["sha256"][f"{n[0]}x{n[1]} {dt} B={B}"] = {
                    name: digest(t) for name, t in
                    zip(fvm.FVState._fields + ("rows",),
                        tuple(state) + (rows,))}
    out["fv_solve"] = {}
    for re in (100.0, 1000.0):
        solver = fvm.FVSolver(params=params(
            "float32", (re, 0.4, 0.2, 1.0), tolerance=1e-6,
            max_iterations=30_000))
        t0 = time.time()
        solver.solve()
        torch.cuda.synchronize()
        out["fv_solve"][f"Re={re:g}"] = {
            "iterations": solver.metrics.iterations,
            "converged": bool(solver.metrics.converged),
            "wall_s": time.time() - t0,
            "solver_wall_s": solver.metrics.wall_time_seconds}
    return out


def main(argv) -> int:
    if len(argv) > 1 and argv[0] == "--worker":
        print(json.dumps(worker(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--worker", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
