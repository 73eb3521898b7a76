#!/usr/bin/env python3
"""Time the SG stage launch, the SG chunk and the SG N=128 solve of several
checkouts of this repository on one CUDA card, in turns.

    python3 scripts/sg_stage_ab.py build/parent . . build/parent

Each argument is the root of a checkout. Each runs in a process of its own
(that checkout's package, its kernels built from its own sources), in the
order given, so that versions are compared on one card within one call.
The first line is the card's name and power limit; then one JSON line per
checkout, also appended to chiprun_out/sg_stage_ab.jsonl:

- ``stage_ms``: one last-stage launch of the ``sg_stage`` group (the bench
  entry of the library, CUDA events over 200 launches), float32, at N = 48,
  96, 128 for one lane and N = 20, 128 for 8 lanes; in a checkout whose
  stage is two launches, that pair;
- ``chunk_ms``: ms per step of a 200-step lane chunk at the same shapes
  (quadratures at the JAX lane kernels' cadence), from a developing flow;
- ``stage_device_ms``: the device time of that launch group under
  torch.profiler (every kernel of the group, per launch of the group);
- ``sg_steps_per_s``: SG N=128 Re=1000 float32 through ``SGSolver.solve``,
  50,000 steps in chunks of 5,000, net of the first chunk (as phase 3 of
  chip_smoke.py).

It uses only what every checkout since the lane kernels has:
``sg_kernels._workspace`` / ``bench_kernel``, ``sg_lane_kernels``'
``_lane_statics`` / ``make_lane_chunk_runner`` and ``SGSolver``.

    python3 scripts/sg_stage_ab.py --x1 build/parent . . build/parent

times ``matmul_algorithm=x1`` instead (every checkout since the x1 kernels,
whose bench entry takes ``x1=True``), float32, one lane, smoothed lid:

- ``x1_stage_ms`` / ``stage_ms``: one x1 / exact last-stage launch at
  N = 96, 128, 256, 320 from a seeded state (200 launches by CUDA events);
- ``x1_chunk_ms`` / ``chunk_ms``: ms per step of a 64-step x1 / exact chunk
  from rest (quadratures every 16th step);
- ``x1_steps_per_s`` / ``sg_steps_per_s``: SG N=128 Re=1000 through
  ``SGSolver.solve`` under x1 / exact, 50,000 steps in chunks of 5,000,
  net of the first chunk (chip_smoke.py phases 3b / 3), with the SHA-256
  of each final state (u, v, p) in ``x1_state_sha256`` / ``state_sha256``.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

# (Re, corner_smoothing, CFL, beta_squared) of the 8 lanes, as chip_smoke.py
LANES = [(100.0, 0.15, 1.5, 5.0), (400.0, 0.10, 1.2, 4.0),
         (1000.0, 0.05, 1.0, 6.0), (3200.0, 0.20, 1.5, 5.0),
         (100.0, 0.08, 1.3, 5.5), (400.0, 0.12, 1.5, 4.5),
         (1000.0, 0.15, 1.1, 5.0), (200.0, 0.03, 1.4, 6.0)]
SHAPES = ((48, 1), (96, 1), (128, 1), (20, 8), (128, 8))
X1_ORDERS = (96, 128, 256, 320)


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


def device_ms(torch, fn, groups):
    """Device time of everything ``fn`` launches, per launch group."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e.time_range.elapsed_us() for e in prof.events()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sum(dev) / groups / 1e3 if dev else None


def worker(root: Path, x1: bool = False) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from anap3_tpu_torch.models import spectral_sg as core
    from anap3_tpu_torch.models.params import SpectralParameters
    from anap3_tpu_torch.models.spectral import SGSolver
    from anap3_tpu_torch.ops import sg_kernels as sgk
    from anap3_tpu_torch.ops import sg_lane_kernels as sgl
    from anap3_tpu_torch.parallel.sweep import stack_states

    if not Path(sgk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {sgk.__file__}, not from {root}")

    def params(n, **kw):  # conf/solver/spectral/sg.yaml numerics
        base = dict(Re=1000.0, nx=n, ny=n, basis_type="chebyshev", CFL=1.5,
                    beta_squared=5.0, corner_treatment="smoothing",
                    corner_smoothing=0.15, dtype="float32", device="cuda",
                    chunk_size=5000, convergence_metric="auto")
        base.update(kw)
        return SpectralParameters(**base)

    def solve(**kw):  # SG N=128 Re=1000: steps/s net of the first chunk
        solver = SGSolver(params=params(128, **kw))
        solver.solve(max_iter=50_000)
        torch.cuda.synchronize()
        it, first = solver.metrics.iterations, solver.first_chunk_time
        sha = hashlib.sha256()
        for t in solver.state:
            sha.update(t.detach().contiguous().cpu().numpy().tobytes())
        return ((it - 5000) / max(solver.metrics.wall_time_seconds - first,
                                  1e-9), it, sha.hexdigest())

    if x1:
        return x1_times(root, torch, core, sgk, params, solve)
    out = {"root": str(root), "stage_ms": {}, "stage_device_ms": {},
           "chunk_ms": {}}
    for n, B in SHAPES:
        ops = [core.build_spectral_ops(params(
            n, Re=Re, corner_smoothing=cs, CFL=cfl, beta_squared=beta))[0]
            for Re, cs, cfl, beta in LANES[:B]]
        o0, key = ops[0], f"N={n} B={B}"
        run = sgl.make_lane_chunk_runner(ops, 200, 1e-30)
        st = run(stack_states([core.initial_state(o) for o in ops]), 0)[0]
        out["chunk_ms"][key] = cuda_ms(torch, lambda: run(st, 200), 3) / 200
        kw = dict(dtype=o0.dtype, device=o0.device)
        ws = sgk._workspace(
            o0, lanes=B, **sgl._lane_statics(ops),
            u=st.u.clone(), v=st.v.clone(), p=st.p.clone(),
            bu=torch.empty_like(st.u), bv=torch.empty_like(st.v),
            bp=torch.empty_like(st.p), rows=torch.empty((16, B, 7), **kw),
            flags=torch.zeros((B, 3), dtype=torch.int32, device=o0.device),
            ref_norm=torch.full((B,), float("inf"), **kw))
        for name, src in (("au", st.u), ("av", st.v), ("ap", st.p)):
            ws[name].copy_(src)
        # dt of this state (a checkout before the one-launch tail had it
        # in its "sg_diag" group)
        sgk.bench_kernel(o0, ws, "dt" if "dt" in getattr(
            sgk, "BENCH_GROUPS", ()) else "sg_diag", 1, B)
        out["stage_ms"][key] = cuda_ms(
            torch, lambda: sgk.bench_kernel(o0, ws, "sg_stage", 200, B),
            1) / 200
        out["stage_device_ms"][key] = device_ms(
            torch, lambda: sgk.bench_kernel(o0, ws, "sg_stage", 50, B), 50)
    out["sg_steps_per_s"], out["sg_iterations"], _ = solve()
    return out


def x1_times(root, torch, core, sgk, params, solve) -> dict:
    """The x1 mode's readings (see the module docstring)."""
    import numpy as np

    out = {"root": str(root), "mode": "x1", "x1_stage_ms": {},
           "stage_ms": {}, "x1_chunk_ms": {}, "chunk_ms": {}}
    rng = np.random.default_rng(16)
    inf = float("inf")
    for n in X1_ORDERS:
        ops = core.build_spectral_ops(params(n))[0]
        nf, key = ops.nf, f"N={n}"

        def seeded():
            st = core.state_from_numpy(tuple(
                0.05 * rng.standard_normal(s)
                for s in ((nf, nf), (nf, nf), (nf - 2, nf - 2))),
                ops.device, ops.dtype)
            u, v = core.enforce_bc(ops, st.u, st.v)
            return core.SpectralState(u.contiguous(), v.contiguous(), st.p)

        st, base = seeded(), seeded()
        ws = sgk.chunk_workspace(ops, base, 16, inf)
        # the x1 entries of the pointer table: this tree's, or the border
        # table alone of a checkout before the bf16 operand tables
        ws.update(sgk.x1_workspace(ops) if hasattr(sgk, "x1_workspace")
                  else {"x1b": sgk.x1_border_table(ops)})
        for name, src in (("au", st.u), ("av", st.v), ("ap", st.p)):
            ws[name].copy_(src)
        sgk.bench_kernel(ops, ws, "dt", 1)
        for x1, col in ((True, "x1_stage_ms"), (False, "stage_ms")):
            out[col][key] = cuda_ms(torch, lambda: sgk.bench_kernel(
                ops, ws, "sg_stage", 200, x1=x1), 1) / 200
        st0 = core.initial_state(ops)
        for x1, col in ((True, "x1_chunk_ms"), (False, "chunk_ms")):
            run = sgk.make_sg_chunk_runner(ops, 64, 1e-30, 10, "rel_iter",
                                           16, x1=x1)
            out[col][key] = cuda_ms(torch, lambda: run(st0, 0, inf), 3) / 64
    (out["x1_steps_per_s"], out["x1_iterations"],
     out["x1_state_sha256"]) = solve(matmul_algorithm="x1")
    out["sg_steps_per_s"], out["sg_iterations"], out["state_sha256"] = solve()
    return out


def main(argv) -> int:
    x1 = "--x1" in argv
    argv = [a for a in argv if a != "--x1"]
    if len(argv) > 1 and argv[0] == "--worker":
        print(json.dumps(worker(Path(argv[1]).resolve(), x1)), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log = Path(__file__).resolve().parents[1] / "chiprun_out"
    log.mkdir(exist_ok=True)
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--worker", root]
                              + ["--x1"] * x1, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        with open(log / "sg_stage_ab.jsonl", "a") as f:
            f.write(json.dumps(dict(json.loads(line), card=card)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
