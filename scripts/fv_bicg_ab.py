#!/usr/bin/env python3
"""Time the FV BiCGSTAB solve, the FV iteration and the FV Re=100 solve of
several checkouts of this repository on one CUDA card, in turns, and hash
the solve's output so that bit-equality between them is shown.

    python3 scripts/fv_bicg_ab.py build/parent . . build/parent

Each argument is the root of a checkout. Each runs in a process of its own
(that checkout's package, its kernels built from its own sources), in the
order given, so that versions are compared on one card within one call.
The first line is the card's name and power limit; then one JSON line per
checkout:

- ``bicg_ms``: one iteration's ``fv_bicgstab`` launches (the bench entry
  of the library, CUDA events over 200 repetitions) at 128x128, float32
  and float64, on the workspace of one step from a seeded state;
- ``iter_ms``: ms per SIMPLE iteration of a 100-iteration chunk from rest
  at 128x128, float32 with B = 1, 3, 8 lanes and float64 with B = 1;
- ``fv_re100``: FV N=128 Re=100 tol 1e-6 float32 through
  ``FVSolver.solve`` (as phase 5 of chip_smoke.py): iterations and wall;
- ``sha256``: SHA-256 of u*, v* (the BiCGSTAB solution of one SIMPLE
  iteration) from seeded states (numpy ``default_rng(0)``), float32 and
  float64, one lane (the step entry) and three lanes (Re 100, 400, 1000;
  one lane-chunk iteration);
- ``x6_step_ms``: the x6 N=96 float32 ``sg_step_run`` call as
  chip_smoke.py times it (CUDA events over 20 calls), beside the host time
  to enqueue one call and its device time under torch.profiler.

It uses only what every checkout since the FV lane kernels has:
``fv_kernels.statics`` / ``workspace`` / ``bench_workspace`` /
``bench_kernel``, the library's ``fv_lanes_chunk_run``,
``fv_lane_kernels.make_fv_lane_runner``, ``FVSolver`` and
``sg_kernels.make_sg_step``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

K = 16
# (Re, alpha_uv, alpha_p, lid_velocity) of the lanes, as chip_smoke.py
LANES = [(100.0, 0.4, 0.2, 1.0), (400.0, 0.6, 0.3, 1.0),
         (1000.0, 0.5, 0.25, 1.5)]


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


def device_ms(torch, fn, calls):
    """Device time of everything ``fn`` launches, per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e.time_range.elapsed_us() for e in prof.events()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sum(dev) / calls / 1e3 if dev else None


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from anap3_tpu_torch.models import fv as fvm
    from anap3_tpu_torch.models import spectral_sg as core
    from anap3_tpu_torch.models.params import FVParameters, SpectralParameters
    from anap3_tpu_torch.ops import fv_kernels as fvk
    from anap3_tpu_torch.ops import fv_lane_kernels as fvl
    from anap3_tpu_torch.ops import sg_kernels as sgk
    from anap3_tpu_torch.parallel.sweep import stack_states

    if not Path(fvk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fvk.__file__}, not from {root}")

    def params(dt, lane=LANES[0], **kw):  # conf/solver/fv.yaml numerics
        Re, auv, ap, lid = lane
        base = dict(Re=Re, nx=128, ny=128, convection_scheme="TVD",
                    limiter="MUSCL", alpha_uv=auv, alpha_p=ap,
                    lid_velocity=lid, linear_solver_tol=1e-9,
                    rhie_chow="compact", corner_treatment="none",
                    fv_inner_iters=K, dtype=dt, device="cuda",
                    chunk_size=1000, convergence_metric="auto")
        base.update(kw)
        return FVParameters(**base)

    def seeded(ops_list):
        rng = np.random.default_rng(0)
        ny, nx = ops_list[0].ny, ops_list[0].nx
        return [fvm.fv_state_from_numpy(
            [0.05 * rng.standard_normal(s) for s in ((ny, nx),) * 3
             + ((ny, nx - 1), (ny - 1, nx))], "cuda", o.dtype)
            for o in ops_list]

    def digest(x):
        return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()
                              ).hexdigest()

    def lanes_x(ps, ops_list, states):
        """u*, v* of every lane after one fv_lanes_chunk_run iteration."""
        S_list = [fvk.statics(p, o) for p, o in zip(ps, ops_list)]
        ops, B = ops_list[0], len(ops_list)
        flags = torch.tensor([[0, -1, 0]] * B, dtype=torch.int32,
                             device=ops.device)
        ws = fvk.workspace(
            S_list[0], ops, stack_states(states), K, 1,
            fvk.scalar_table(S_list), flags, lanes=B,
            aP_bc=torch.stack([S["aP_bc"] for S in S_list]).contiguous(),
            b_bc_u=torch.stack([S["b_bc_u"] for S in S_list]).contiguous())
        lib = fvk._lib()
        counts = (ctypes.c_int * len(fvk.KERNELS))()
        rc = lib.fv_lanes_chunk_run(
            fvk._dtype_code(ops.dtype), ops.ny, ops.nx, B, fvk._ptr_table(ws),
            K, S_list[0]["n_refine"], int(S_list[0]["upwind"]), 1, 0, 10, 0,
            1e-30, counts, fvk._stream())
        fvk._raise_on(lib, rc, "fv_lanes_chunk_run")
        torch.cuda.synchronize()
        return ws["x"]

    out = {"root": str(root), "bicg_ms": {}, "iter_ms": {}, "sha256": {}}
    for dt in ("float32", "float64"):
        ps = [params(dt, lane) for lane in LANES]
        ops_list = [fvm.build_fv_ops(p)[0] for p in ps]
        states = seeded(ops_list)
        S = fvk.statics(ps[0], ops_list[0])
        ws = fvk.bench_workspace(S, ops_list[0], states[0], K)
        torch.cuda.synchronize()
        out["sha256"][f"{dt} B=1"] = digest(ws["x"])
        out["sha256"][f"{dt} B=3"] = digest(lanes_x(ps, ops_list, states))
        out["bicg_ms"][dt] = cuda_ms(torch, lambda: fvk.bench_kernel(
            S, ops_list[0], ws, "fv_bicgstab", K, 200), 1) / 200
        chunk = 100
        for B in ((1, 3, 8) if dt == "float32" else (1,)):
            lanes = [LANES[b % 3] for b in range(B)]
            pl = [params(dt, lane) for lane in lanes]
            ol = [fvm.build_fv_ops(p)[0] for p in pl]
            if B == 1:
                run = fvk.make_fv_chunk_runner(pl[0], ol[0], chunk, 1e-30,
                                               10, K)
                st = fvm.initial_state(ol[0])
                fn = lambda: run(st, 0, float("inf"))  # noqa: E731
            else:
                run = fvl.make_fv_lane_runner(pl, ol, chunk, 1e-30, 10, K)
                st = stack_states([fvm.initial_state(o) for o in ol])
                fn = lambda: run(st, 0)  # noqa: E731
            out["iter_ms"][f"{dt} B={B}"] = cuda_ms(torch, fn, 2) / chunk
    solver = fvm.FVSolver(params=params("float32", tolerance=1e-6,
                                        max_iterations=30_000))
    t0 = time.time()
    solver.solve()
    torch.cuda.synchronize()
    out["fv_re100"] = {"iterations": solver.metrics.iterations,
                       "converged": bool(solver.metrics.converged),
                       "wall_s": time.time() - t0,
                       "solver_wall_s": solver.metrics.wall_time_seconds}
    ops, _ = core.build_spectral_ops(SpectralParameters(
        Re=1000.0, nx=96, ny=96, basis_type="chebyshev", CFL=1.5,
        beta_squared=5.0, corner_treatment="smoothing",
        corner_smoothing=0.15, dtype="float32", device="cuda"))
    step, st0 = sgk.make_sg_step(ops), core.initial_state(ops)
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        step(st0)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    out["x6_step_ms"] = {"events": cuda_ms(torch, lambda: step(st0), 20),
                         "host_enqueue": 1e3 * float(np.median(host)),
                         "device": device_ms(torch, lambda: step(st0), 20)}
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
