#!/usr/bin/env python3
"""Hash the SG chunk's output and time the SG step's tail, the SG chunk, the
SG N=128 solve and the FSG flagship of several checkouts of this repository
on one CUDA card, in turns.

    python3 scripts/sg_tail_ab.py build/parent . . build/parent

Each argument is the root of a checkout. Each runs in a process of its own
(that checkout's package, its kernels built from its own sources), in the
order given, so that versions are compared on one card within one call.
The first line is the card's name and power limit; then one JSON line per
checkout, also appended to chiprun_out/sg_tail_ab.jsonl:

- ``sha256``: SHA-256 of u, v, p and of rows columns 1-6 after a 200-step
  chunk from rest (tolerance 1e-30, so no lane stops), Re=1000 and the lane
  scalars of chip_smoke.py, at N = 20, 48, 96, 128, 400, float32 and
  float64, one lane (``sg_chunk_run``) and 8 lanes
  (``sg_lanes_chunk_run``), quadratures at the lane kernels' cadence;
- ``group_ms``: each launch group of the library's bench entry (CUDA events
  over 200 repetitions) at N=128 one lane and N=20 8 lanes, float32:
  the checkout's own groups (``sg_kernels.BENCH_GROUPS``, or the three of
  a checkout before it: stage, dt + quadratures, sampled control);
- ``chunk_ms``: ms per step of a 200-step chunk from a developing flow at
  N=128 one lane and N=20, N=128 8 lanes, float32;
- ``sg_steps_per_s``: SG N=128 Re=1000 float32 through ``SGSolver.solve``,
  50,000 steps in chunks of 5,000, net of the first chunk (as phase 3 of
  chip_smoke.py), and the SHA-256 of its final u, v, p in ``sha256``;
- ``fsg``: the FSG N=96 Re=1000 tol 1e-6 float32 flagship (as phase 4 of
  chip_smoke.py): iterations and wall;
- the smoother (``sg_smooth_run``): in ``sha256``, u, v, p and the six
  metrics of 2 and 30 forced steps from rest at N = 24, 48, 96, 192,
  float32 and float64, smoothed and singular lids (the forcing random
  inside the velocity boundary ring, zero on it, from a seeded numpy
  generator); in ``smooth_ms``, ms per step of 30 forced steps at N=96 and
  N=192 float32 (CUDA events over 10 calls);
- ``vmg``: 2,000 V-cycles of VMG [192, 96] Re=1000 float32 from rest (as
  phase 7 of chip_smoke.py), three times: cycles/s net of the first chunk
  of each (the host sets the rate, which varies from run to run), and in
  ``sha256`` the SHA-256 of the final u, v, p (the same every time);
- ``dt_ms``: dt_kernel alone through the bench entry (CUDA events over 200
  launches) at N = 48, 96, 128, 192, 320 one lane and N=128 8 lanes,
  float32; ``dt_us_device``: its mean kernel time by torch.profiler at the
  same orders, and of the x1 instance (``dt_kernel<float, true>``, which
  also rounds the state into its bf16 copy) in 16-step x1 chunks at
  N=320.

Rows column 0 (rel) is written per checkout to
chiprun_out/sg_tail_ab/<n>.npz, and the last line gives, for every
checkout after the first, the largest relative difference of an element of
that column from the first checkout's, and whether each hash equals the
first's.

It uses only what every checkout since the x1 mode has:
``sg_kernels.make_sg_chunk_runner`` / ``chunk_workspace`` /
``bench_kernel`` / ``make_sg_smoother``, ``sg_lane_kernels.
make_lane_chunk_runner`` / ``lane_metrics_every``, ``SGSolver``,
``FSGSolver``, ``spectral_vmg.VMGSolver`` and ``utils.profiling.
trace_device``.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parents[1] / "chiprun_out"
# (Re, corner_smoothing, CFL, beta_squared) of the 8 lanes, as chip_smoke.py
LANES = [(100.0, 0.15, 1.5, 5.0), (400.0, 0.10, 1.2, 4.0),
         (1000.0, 0.05, 1.0, 6.0), (3200.0, 0.20, 1.5, 5.0),
         (100.0, 0.08, 1.3, 5.5), (400.0, 0.12, 1.5, 4.5),
         (1000.0, 0.15, 1.1, 5.0), (200.0, 0.03, 1.4, 6.0)]
ORDERS = (20, 48, 96, 128, 400)
CHUNK = 200


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


def worker(root: Path, index: int) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from anap3_tpu_torch.models import spectral_sg as core
    from anap3_tpu_torch.models import spectral_vmg as vmg
    from anap3_tpu_torch.models.params import SpectralParameters
    from anap3_tpu_torch.models.spectral import FSGSolver, SGSolver
    from anap3_tpu_torch.ops import sg_kernels as sgk
    from anap3_tpu_torch.ops import sg_lane_kernels as sgl
    from anap3_tpu_torch.parallel.sweep import stack_states
    from anap3_tpu_torch.utils.profiling import trace_device

    if not Path(sgk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {sgk.__file__}, not from {root}")

    def params(n, dtype="float32", lane=(1000.0, 0.15, 1.5, 5.0), **kw):
        Re, cs, cfl, beta = lane  # conf/solver/spectral/sg.yaml numerics
        base = dict(Re=Re, nx=n, ny=n, basis_type="chebyshev", CFL=cfl,
                    beta_squared=beta, corner_treatment="smoothing",
                    corner_smoothing=cs, dtype=dtype, device="cuda",
                    chunk_size=5000, convergence_metric="auto")
        base.update(kw)
        return SpectralParameters(**base)

    def digest(x):
        return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()
                              ).hexdigest()

    def lanes(n, dtype, B):
        return [core.build_spectral_ops(params(
            n, dtype, (1000.0,) + LANES[b][1:]))[0] for b in range(B)]

    out = {"root": str(root), "sha256": {}, "group_ms": {}, "chunk_ms": {}}
    rel_cols = {}
    for n in ORDERS:
        m = sgl.lane_metrics_every(n)
        for dtype in ("float32", "float64"):
            for B in (1, 8):
                ops = lanes(n, dtype, B)
                key = f"N={n} {dtype} B={B}"
                if B == 1:
                    res = sgk.make_sg_chunk_runner(
                        ops[0], CHUNK, 1e-30, 10, "rel_iter", m)(
                        core.initial_state(ops[0]), 0, float("inf"))
                    state, rows = res[0], res[4]
                else:
                    res = sgl.make_lane_chunk_runner(ops, CHUNK, 1e-30)(
                        stack_states([core.initial_state(o) for o in ops]), 0)
                    state, rows = res[0], res[2]
                torch.cuda.synchronize()
                out["sha256"][key] = {
                    "u": digest(state[0]), "v": digest(state[1]),
                    "p": digest(state[2]),
                    "rows 1-6": digest(rows[..., 1:])}
                rel_cols[key] = rows[..., 0].double().cpu().numpy()
    (OUT / "sg_tail_ab").mkdir(parents=True, exist_ok=True)
    np.savez(OUT / "sg_tail_ab" / f"{index}.npz",
             **{k.replace(" ", "_"): v for k, v in rel_cols.items()})

    groups = getattr(sgk, "BENCH_GROUPS", ("sg_stage", "sg_diag",
                                           "sg_control"))
    for n, B in ((128, 1), (20, 8), (128, 8)):
        ops = lanes(n, "float32", B)
        o0, key = ops[0], f"N={n} B={B}"
        run = sgl.make_lane_chunk_runner(ops, CHUNK, 1e-30)
        st = run(stack_states([core.initial_state(o) for o in ops]), 0)[0]
        if B == 1:
            one = sgk.make_sg_chunk_runner(o0, CHUNK, 1e-30, 10, "rel_iter",
                                           sgl.lane_metrics_every(n))
            st1 = core.SpectralState(*(t[0] for t in st))
            out["chunk_ms"][key] = cuda_ms(
                torch, lambda: one(st1, CHUNK, float("inf")), 3) / CHUNK
        else:
            out["chunk_ms"][key] = cuda_ms(
                torch, lambda: run(st, CHUNK), 3) / CHUNK
        if (n, B) == (128, 8):
            continue
        kw = dict(dtype=o0.dtype, device=o0.device)
        ws = sgk._workspace(
            o0, lanes=B, **sgl._lane_statics(ops),
            u=st.u.clone(), v=st.v.clone(), p=st.p.clone(),
            bu=st.u.clone(), bv=st.v.clone(), bp=st.p.clone(),
            rows=torch.empty((16, B, 7), **kw),
            flags=torch.zeros((B, 3), dtype=torch.int32, device=o0.device),
            ref_norm=torch.full((B,), float("inf"), **kw))
        for name, src in (("au", st.u), ("av", st.v), ("ap", st.p)):
            ws[name].copy_(src)
        sgk.bench_kernel(o0, ws, "sg_stage", 1, B)  # the tails' partials
        out["group_ms"][key] = {
            g: cuda_ms(torch, lambda: sgk.bench_kernel(o0, ws, g, 200, B),
                       1) / 200 for g in groups}

    smoother(torch, core, sgk, params, digest, out)
    dt_times(torch, core, sgk, sgl, params, trace_device, out)
    out["vmg"] = {"cycles_per_s": []}
    for _ in range(3):
        solver = vmg.VMGSolver(params=params(
            192, Re=1000.0, multigrid="vmg", n_levels=3,
            coarse_tolerance_factor=1.0, tolerance=0.0,
            max_iterations=8000))
        solver.solve()
        torch.cuda.synchronize()
        m = solver.metrics
        out["vmg"].update(ladder=solver.ladder, cycles=m.iterations)
        out["vmg"]["cycles_per_s"].append((m.iterations - 50) / max(
            m.wall_time_seconds - solver.first_chunk_time, 1e-9))
        u, v, p = solver.state
        key = "VMG [192, 96] float32, 2,000 cycles"
        got = {"u": digest(u), "v": digest(v), "p": digest(p)}
        if out["sha256"].setdefault(key, got) != got:
            raise RuntimeError("two VMG runs ended in different states")
    solver = SGSolver(params=params(128))
    solver.solve(max_iter=50_000)
    torch.cuda.synchronize()
    it, first = solver.metrics.iterations, solver.first_chunk_time
    out["sg_steps_per_s"] = (it - 5000) / max(
        solver.metrics.wall_time_seconds - first, 1e-9)
    u, v, p = solver.state
    out["sha256"]["SG N=128 float32 solve, 50,000 steps"] = {
        "u": digest(u), "v": digest(v), "p": digest(p)}
    fsg = FSGSolver(params=params(96, tolerance=1e-6, max_iterations=400_000,
                                  multigrid="fsg", n_levels=2,
                                  coarse_tolerance_factor=1.0))
    t0 = time.time()
    fsg.solve()
    torch.cuda.synchronize()
    out["fsg"] = {"iterations": fsg.metrics.iterations,
                  "converged": bool(fsg.metrics.converged),
                  "wall_s": fsg.metrics.wall_time_seconds,
                  "call_s": time.time() - t0}
    return out


def smoother(torch, core, sgk, params, digest, out):
    """The smoother's hashes and its ms per step (see the docstring)."""
    rng = np.random.default_rng(2)

    def forcing(ops):  # random inside the velocity boundary ring
        nf, ring = ops.nf, ops.interior.to(ops.dtype)
        return tuple(torch.as_tensor(0.01 * rng.standard_normal(shape),
                                     dtype=ops.dtype, device=ops.device) * m
                     for shape, m in (((nf, nf), ring), ((nf, nf), ring),
                                      ((nf - 2, nf - 2), 1.0)))

    for n in (24, 48, 96, 192):
        for dtype in ("float32", "float64"):
            for corner in ("smoothing", "singular"):
                ops = core.build_spectral_ops(params(
                    n, dtype, corner_treatment=corner))[0]
                smooth = sgk.make_sg_smoother(ops)
                st, tau = core.initial_state(ops), forcing(ops)
                for steps in (2, 30):
                    s, metrics = smooth(st, tau, steps)
                    torch.cuda.synchronize()
                    out["sha256"][f"smoother N={n} {dtype} {corner} "
                                  f"{steps} steps"] = {
                        "u": digest(s.u), "v": digest(s.v),
                        "p": digest(s.p), "metrics": digest(torch.stack(
                            [metrics[k] for k in sorted(metrics)]))}
    out["smooth_ms"] = {}
    for n in (96, 192):
        ops = core.build_spectral_ops(params(n))[0]
        smooth = sgk.make_sg_smoother(ops)
        st, tau = core.initial_state(ops), forcing(ops)
        out["smooth_ms"][f"N={n}"] = cuda_ms(
            torch, lambda: smooth(st, tau, 30), 10) / 30


def dt_times(torch, core, sgk, sgl, params, trace_device, out):
    """dt_kernel alone by CUDA events and by the profiler, and the x1
    instance's kernel time in x1 chunks (see the docstring)."""
    rng = np.random.default_rng(5)

    def kernel_us(fn, name):
        dev = trace_device(fn, name)[0]
        times = [e.time_range.elapsed_us() for e in dev if name in e.name]
        return sum(times) / len(times)

    out["dt_ms"], out["dt_us_device"] = {}, {}
    for n, B in ((48, 1), (96, 1), (128, 1), (192, 1), (320, 1), (128, 8)):
        ops = [core.build_spectral_ops(params(
            n, lane=(1000.0,) + LANES[b][1:]))[0] for b in range(B)]
        o0, nf = ops[0], ops[0].nf
        kw = dict(dtype=o0.dtype, device=o0.device)
        u, v = (torch.as_tensor(0.3 * rng.standard_normal((B, nf, nf)), **kw)
                for _ in range(2))
        p = torch.zeros((B, nf - 2, nf - 2), **kw)
        ws = sgk._workspace(
            o0, lanes=B, **sgl._lane_statics(ops), u=u, v=v, p=p,
            bu=u.clone(), bv=v.clone(), bp=p.clone(),
            rows=torch.empty((1, B, 7), **kw),
            flags=torch.zeros((B, 3), dtype=torch.int32, device=o0.device),
            ref_norm=torch.full((B,), float("inf"), **kw))
        key = f"N={n} B={B}"
        out["dt_ms"][key] = cuda_ms(
            torch, lambda: sgk.bench_kernel(o0, ws, "dt", 200, B), 1) / 200
        out["dt_us_device"][key] = kernel_us(
            lambda: sgk.bench_kernel(o0, ws, "dt", 50, B), "dt_kernel")
    ops = core.build_spectral_ops(params(320))[0]
    run = sgk.make_sg_chunk_runner(ops, 16, 1e-30, 10, "rel_iter", 16,
                                   x1=True)
    st = run(core.initial_state(ops), 0, float("inf"))[0]
    out["dt_us_device"]["x1 N=320 B=1"] = kernel_us(
        lambda: [run(st, 16 * i, float("inf")) for i in range(1, 6)],
        "dt_kernel")


def compare(results) -> dict:
    """Each checkout after the first against the first: hashes equal, and
    the largest relative difference of rows column 0."""
    ref = np.load(OUT / "sg_tail_ab" / "0.npz")
    report = {}
    for i, res in enumerate(results[1:], 1):
        cols = np.load(OUT / "sg_tail_ab" / f"{i}.npz")
        rel = {}
        for k in ref.files:  # element by element, where the first is finite
            a, b = cols[k], ref[k]
            fin = np.isfinite(b)
            rel[k] = float(np.max(np.abs(a[fin] - b[fin])
                                  / np.maximum(np.abs(b[fin]), 1e-300)))
        equal = {k: {f: h == results[0]["sha256"][k][f]
                     for f, h in v.items()}
                 for k, v in res["sha256"].items()}
        report[f"{i} {res['root']}"] = {
            "all_hashes_equal": all(all(v.values()) for v in equal.values()),
            "hashes_equal": equal, "rel_col0_max": rel}
    return report


def main(argv) -> int:
    if len(argv) > 2 and argv[0] == "--worker":
        print(json.dumps(worker(Path(argv[1]).resolve(), int(argv[2]))),
              flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    OUT.mkdir(exist_ok=True)
    results = []
    for i, root in enumerate(argv):
        proc = subprocess.run([sys.executable, __file__, "--worker", root,
                               str(i)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        results.append(json.loads(line))
        with open(OUT / "sg_tail_ab.jsonl", "a") as f:
            f.write(json.dumps({"card": card, **results[-1]}) + "\n")
        print(line, flush=True)
    print(json.dumps(compare(results)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
