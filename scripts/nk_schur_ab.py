#!/usr/bin/env python3
"""Time the Newton Schur kernel, a GMRES vector and the cold Newton N=128
solve of several checkouts of this repository on one CUDA card, in turns.

    python3 scripts/nk_schur_ab.py build/parent . . build/parent

Each argument is the root of a checkout. Each runs in a process of its own
(that checkout's package, its kernels built from its own sources), in the
order given, so that versions are compared on one card within one call.
The first line is the card's name and power limit; then one JSON line per
checkout:

- ``schur``: by system ("N dt"), the Schur system of one preconditioner
  application to a seeded vector (as ``chip_smoke.nk_system``: the sharp
  lid at Re=1000, N = 96, 128 and 256, dt 0.05, 1 and 3e3) solved by
  ``nk_kernels.schur_kernel`` at the default budget 40: the iterations k,
  ms a solve (CUDA events over 20 solves after one) and us an iteration,
  and ms of a solve cut at one iteration (``ms_1``: the launch, the
  start and one iteration);
- ``vector``: a GMRES vector of the cold N=128 solve's first PTC step
  (``steady._Matvec`` at x0 from rest, dt0 0.05, captured once): the wall
  of one ``mv(y)`` (the copy in, the graph's replay and the read back)
  over 40 calls, and the device time of one graph replay by CUDA events
  over 40 replays;
- ``cold``: ``steady.NewtonSolver.solve()`` of chip_smoke.py's cold phase
  (N=128 Re=1000 sharp lid, Legendre grid, newton.yaml's knobs, tolerance
  1e-6) from rest: PTC steps, GMRES vectors, wall and ||F||_rms.

It uses only what every checkout since the graphed Newton matvec has:
``nk_kernels.schur_kernel``, ``steady._SteadyProblem`` /
``_StokesPreconditioner`` / ``_Matvec`` / ``NewtonSolver``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SYSTEMS = [(n, dt) for n in (96, 128, 256) for dt in (0.05, 1.0, 3e3)]


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from anap3_tpu_torch.models import spectral_sg as core
    from anap3_tpu_torch.models import steady
    from anap3_tpu_torch.models.params import SpectralParameters
    from anap3_tpu_torch.ops import nk_kernels as nk

    if not Path(nk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {nk.__file__}, not from {root}")

    def events_ms(fn, reps):
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

    def newton(n, **kw):
        base = dict(Re=1000.0, nx=n, ny=n, corner_treatment="singular",
                    basis_type="legendre", dtype="float64", device="cuda",
                    newton_max_steps=50, gmres_vectors=60, newton_dt0=0.05,
                    newton_dt_max=3e3, newton_schur_iters=40,
                    newton_prelude=0, tolerance=1e-6)
        base.update(kw)
        return SpectralParameters(**base)

    out = {"root": str(root), "schur": {}}
    for n, dt in SYSTEMS:
        ops, grid = core.build_spectral_ops(newton(n))
        prob = steady._SteadyProblem(ops)
        pre = steady._StokesPreconditioner(prob, grid)
        inv_dt = torch.full((), 1.0 / dt, dtype=torch.float64, device="cuda")
        inv_hlam = pre.inv_hlam(inv_dt)
        r = prob.to_device(np.random.default_rng(5).standard_normal(
            prob.n_tot))
        r_u, r_v, r_p = prob.unflatten(r)
        S = pre.schur
        rhs = (r_p - pre.beta_sq * nk.div(S, nk.hsolve(S, r_u, inv_hlam),
                                          nk.hsolve(S, r_v, inv_hlam))
               ).contiguous()

        def solve():
            return nk.schur_kernel(S, rhs, inv_dt, inv_hlam, 1e-8, 40)

        k = int(solve()[1])
        ms = events_ms(solve, 20)
        ms_1 = events_ms(lambda: nk.schur_kernel(S, rhs, inv_dt, inv_hlam,
                                                 1e-8, 1), 20)
        out["schur"][f"{n} {dt:g}"] = dict(
            k=k, ms=ms, us_an_iteration=ms / max(k, 1) * 1e3, ms_1=ms_1)

    p = newton(128)
    ops, grid = core.build_spectral_ops(p)
    prob = steady._SteadyProblem(ops)
    pre = steady._StokesPreconditioner(prob, grid, schur_iters=40)
    x0 = steady._host(prob.state_to_x(core.initial_state(ops)))
    mv = steady._Matvec(prob, pre)
    mv.set_step(x0, 1.0 / 0.05)
    y = np.random.default_rng(1).standard_normal(prob.n_tot)
    mv(y)  # capture
    torch.cuda.synchronize()
    reps = 40
    t0 = time.perf_counter()
    for _ in range(reps):
        mv(y)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    device = events_ms(mv.graph.replay, reps)
    out["vector"] = dict(wall_ms=wall, device_ms=device)

    solver = steady.NewtonSolver(params=p)
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    call = time.perf_counter() - t0
    F = prob.F(prob.state_to_x(solver.state))
    out["cold"] = dict(
        steps=solver.metrics.iterations, converged=solver.metrics.converged,
        vectors=sum(solver.newton_stats["gmres_vectors"]),
        wall_s=solver.metrics.wall_time_seconds, call_s=call,
        rms=float(torch.linalg.norm(F)) / prob.n_tot ** 0.5)
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        print(json.dumps(worker(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    roots = sys.argv[1:] or ["."]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--worker",
                               str(Path(root).resolve())],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
