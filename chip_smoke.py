#!/usr/bin/env python3
"""Drive the anap3_tpu_torch main path once on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing its own lines and failing the run (exit code 1, no result line)
when it fails:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the cold build of the SG kernels from ``csrc/``;
2. kernels: every kernel wrapper (step, tau step, chunk of 64 steps with
   metrics_every=16 and warmup 10) against its plain PyTorch version on the
   same CUDA tensors, at N = 48, 96, 128, float32 and float64, smoothed and
   singular lids; tolerances: relative max error <= 1e-11 in float64 and
   <= 1e-4 in float32, done/conv_iter equal; kernel and plain ms/step;
3. SG N=128 Re=1000 float32 (the BASELINE timesteps/s cell): SGSolver
   .solve(max_iter=50_000) with chunk 5000; steps/s net of the first chunk;
4. FSG N=96 Re=1000 tol=1e-6 float32 (the flagship): FSGSolver.solve() with
   max_iterations=400_000; iterations within 20% of the JAX record
   (176,389), Ghia u-centerline max error <= 0.027, L2 errors against the
   stored FV truth.

Phases 3 and 4 are the main path: the launch counters are zeroed before
phase 3 and read after phase 4, and every kernel must have launched and no
plain version run. The line before the last is the kernels' JSON summary;
the last line is the result object.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from anap3_tpu_torch.models import spectral_sg as core  # noqa: E402
from anap3_tpu_torch.models.params import SpectralParameters  # noqa: E402
from anap3_tpu_torch.models.runner import control_step, freeze  # noqa: E402
from anap3_tpu_torch.models.spectral import FSGSolver, SGSolver  # noqa: E402
from anap3_tpu_torch.ops import sg_kernels as sgk  # noqa: E402
from anap3_tpu_torch.ops._build import build_info, load_library  # noqa: E402

JAX_FSG_ITERATIONS = 176_389  # JAX record for the flagship FSG config
GHIA_MAX_ERR = 0.027
REPLACES = {  # TPU kernel each CUDA kernel stands in for (pallas_call site)
    "sg_stage": "anap3_tpu/ops/pallas_tiled.py:545",
    "sg_diag": "anap3_tpu/ops/pallas_tiled.py:721",
    "sg_control": "anap3_tpu/ops/pallas_aligned.py:647",
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel_err(a, b) -> float:
    a = a.detach().double()
    b = b.detach().double()
    fin = torch.isfinite(b)
    check(bool(torch.equal(fin, torch.isfinite(a))), "NaN positions differ")
    if not bool(fin.any()):
        return 0.0
    scale = float(b[fin].abs().max())
    return float((a[fin] - b[fin]).abs().max()) / max(scale, 1e-300)


def cuda_ms(fn, reps: int) -> float:
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


def params(n, dtype, corner="smoothing", **kw):
    # the shipped conf/solver/spectral/sg.yaml numerics
    base = dict(Re=1000.0, nx=n, ny=n, basis_type="chebyshev", CFL=1.5,
                beta_squared=5.0, corner_treatment=corner,
                corner_smoothing=0.15, dtype=dtype, device="cuda",
                chunk_size=5000, convergence_metric="auto")
    base.update(kw)
    return SpectralParameters(**base)


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib = load_library()
    info = build_info()
    check(lib is not None, "kernel library did not load")
    report = info.get("ptxas", "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", report)]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"card {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"kernel build {info.get('build_seconds', 0.0):.1f}s "
          f"(cached={info.get('cached')})", flush=True)
    print(f"[device] ptxas: {len(regs)} kernels, max {max(regs, default=0)} "
          f"registers, {sum(spills)} bytes of spill stores (report: "
          f"{Path(info['path']).parent / 'build.log'})", flush=True)
    return card


def random_state(ops, rng):
    nf = ops.nf
    u = 0.05 * rng.standard_normal((nf, nf))
    v = 0.05 * rng.standard_normal((nf, nf))
    p = 0.05 * rng.standard_normal((nf - 2, nf - 2))
    st = core.state_from_numpy((u, v, p), ops.device, ops.dtype)
    uu, vv = core.enforce_bc(ops, st.u, st.v)
    return core.SpectralState(uu.contiguous(), vv.contiguous(), st.p)


def phase_kernels(summary):
    rng = np.random.default_rng(0)
    chunk, m_every, warmup = 64, 16, 10
    for n in (48, 96, 128):
        for dt_name in ("float32", "float64"):
            tol = 1e-4 if dt_name == "float32" else 1e-11
            for corner in ("smoothing", "singular"):
                ops, _ = core.build_spectral_ops(params(n, dt_name, corner))
                st = random_state(ops, rng)
                step = sgk.make_sg_step(ops)
                s_k, m_k = step(st)
                torch.cuda.synchronize()  # a fault shows where it happened
                s_p, m_p = sgk.step_plain(ops, st)
                e_state = max(rel_err(a, b) for a, b in zip(s_k, s_p))
                e_met = max(rel_err(m_k[k], m_p[k]) for k in m_p)
                nf = ops.nf
                tau = tuple(
                    torch.as_tensor(0.01 * rng.standard_normal(shape),
                                    dtype=ops.dtype, device=ops.device)
                    for shape in ((nf, nf), (nf, nf), (nf - 2, nf - 2)))
                s_kt, m_kt = sgk.make_sg_step(ops, with_tau=True)(st, tau)
                s_pt, m_pt = sgk.step_plain(ops, st, tau)
                e_tau = max([rel_err(a, b) for a, b in zip(s_kt, s_pt)]
                            + [rel_err(m_kt[k], m_pt[k]) for k in m_pt])
                # the chunk from rest: the cold-start transient
                st0 = core.initial_state(ops)
                ref = torch.tensor(float("inf"), dtype=ops.dtype,
                                   device=ops.device)
                run_k = sgk.make_sg_chunk_runner(ops, chunk, 1e-30, warmup,
                                                 "rel_iter", m_every)
                out_k = run_k(st0, 0, ref)
                out_p = sgk.chunk_plain(ops, st0, 0, ref, chunk, 1e-30,
                                        warmup, False, m_every)
                e_chunk = max(rel_err(a, b) for a, b in zip(out_k[0], out_p[0]))
                e_rows = max(rel_err(out_k[4][:, c], out_p[4][:, c])
                             for c in range(7))  # per column
                flags_k = [int(out_k[i]) for i in (1, 2, 3)]
                flags_p = [int(out_p[i]) for i in (1, 2, 3)]
                worst = max(e_state, e_met, e_tau, e_chunk, e_rows)
                print(f"[kernels] N={n} {dt_name} {corner}: step state "
                      f"{e_state:.2e} metrics {e_met:.2e} tau {e_tau:.2e} "
                      f"chunk state {e_chunk:.2e} rows {e_rows:.2e} "
                      f"flags {flags_k} (tol {tol:.0e})", flush=True)
                check(worst <= tol, f"N={n} {dt_name} {corner}: relative "
                      f"error {worst:.3e} > {tol:.0e}")
                check(flags_k == flags_p, f"flags differ: {flags_k} vs "
                      f"{flags_p}")
                if corner == "smoothing":
                    t_k = cuda_ms(lambda: run_k(st0, 0, ref), 3) / chunk
                    t_p = cuda_ms(lambda: sgk.chunk_plain(
                        ops, st0, 0, ref, chunk, 1e-30, warmup, False,
                        m_every), 1) / chunk
                    print(f"[kernels] N={n} {dt_name}: chunk ms/step kernel "
                          f"{t_k:.4f} plain {t_p:.4f}", flush=True)
                if n == 128 and dt_name == "float32" and corner == "smoothing":
                    # absolute errors on the main path's inputs: one step
                    # from the flow 64 steps after rest, and that chunk
                    s_k, m_k = step(out_p[0])
                    s_p, m_p = sgk.step_plain(ops, out_p[0])
                    summary["sg_stage"]["max_abs_err"] = max(
                        float((a.double() - b.double()).abs().max())
                        for a, b in zip(s_k, s_p))
                    summary["sg_diag"]["max_abs_err"] = max(
                        abs(float(m_k[k]) - float(m_p[k]))
                        for k in ("energy", "enstrophy", "palinstrophy"))
                    summary["sg_control"]["max_abs_err"] = float(
                        (out_k[4].double() - out_p[4].double()).abs().max())
                    print(f"[kernels] N=128 float32 developed flow: abs err "
                          + ", ".join(f"{k} {summary[k]['max_abs_err']:.3e}"
                                      for k in sgk.KERNELS), flush=True)
                    time_kernels(ops, st0, summary)


def time_kernels(ops, st0, summary):
    """Per-kernel time (bench entry of the library, CUDA events) beside
    its plain PyTorch counterpart, at N=128 float32."""
    run = sgk.make_sg_chunk_runner(ops, 16, 1e-30, 10, "rel_iter", 16)
    st = run(st0, 0, float("inf"))[0]  # a developing flow, not rest
    ws = sgk.chunk_workspace(ops, st, 16, float("inf"))
    for a, b in (("au", st.u), ("av", st.v), ("ap", st.p), ("bu", st.u),
                 ("bv", st.v), ("bp", st.p)):
        ws[a].copy_(b)
    reps = 200
    for name in sgk.KERNELS:
        summary[name]["ms"] = cuda_ms(
            lambda: sgk.bench_kernel(ops, ws, name, reps), 1) / reps
    u, v, p = st
    dt = core.adaptive_dt(ops, u, v)

    def plain_stage():
        R_u, R_v, R_p = core.residuals(ops, u, v, p)
        core.enforce_bc(ops, u + dt * R_u, v + dt * R_v)
        return p + dt * R_p

    def plain_diag():
        core.adaptive_dt(ops, u, v)
        return core.conserved_quantities(ops, u, v)

    done = torch.zeros((), dtype=torch.bool, device=ops.device)
    conv = torch.full((), -1, dtype=torch.int32, device=ops.device)
    ref = torch.tensor(float("inf"), dtype=ops.dtype, device=ops.device)

    def plain_control():
        row = torch.stack([torch.linalg.norm(u - v), torch.linalg.norm(u),
                           torch.linalg.norm(v), torch.linalg.norm(p),
                           dt, dt, dt])
        row, d, c, cv, r = control_step(row, 100, done, conv, done, ref,
                                        1e-30, 10, False)
        return freeze(d, st, st)

    for name, fn in (("sg_stage", plain_stage), ("sg_diag", plain_diag),
                     ("sg_control", plain_control)):
        summary[name]["plain_ms"] = cuda_ms(fn, 50)
    for name in sgk.KERNELS:
        print(f"[kernels] {name} at N=128 float32: kernel "
              f"{summary[name]['ms']:.4f} ms, plain {summary[name]['plain_ms']:.4f} ms",
              flush=True)


def phase_sg():
    solver = SGSolver(params=params(128, "float32"))
    t0 = time.time()
    solver.solve(max_iter=50_000)
    torch.cuda.synchronize()
    wall = time.time() - t0
    it = solver.metrics.iterations
    first = solver.first_chunk_time
    chunk = int(solver.params.chunk_size)
    net = (it - chunk) / max(solver.metrics.wall_time_seconds - first, 1e-9)
    print(f"[sg] N=128 Re=1000 float32: {it} iterations in "
          f"{solver.metrics.wall_time_seconds:.3f}s (call {wall:.3f}s), "
          f"first_chunk_seconds {first:.3f}, steps/s net of the first chunk "
          f"{net:.1f}, converged={solver.metrics.converged}", flush=True)
    u, v, p = solver.state
    check(all(bool(torch.isfinite(t).all()) for t in (u, v, p)),
          "SG state is not finite")
    check(it == 50_000 or solver.metrics.converged,
          f"SG stopped at {it} without converging")
    check(all(sgk.LAUNCHES[k] > 0 for k in sgk.KERNELS)
          and not any(sgk.PLAIN_CALLS.values()),
          f"SG did not run on the kernels alone: launches {sgk.LAUNCHES}, "
          f"plain calls {sgk.PLAIN_CALLS}")
    return net


def ghia_u_error(solver) -> float:
    """Max |u - Ghia| along the vertical centerline x = 0.5: the degree-N
    Chebyshev interpolant of the x=0.5 node column, at Ghia's y."""
    data = np.genfromtxt(ROOT / "data/validation/ghia/ghia_Re1000_u_centerline.csv",
                         delimiter=",", names=True)
    xn = solver.grid["x_nodes"]
    yn = solver.grid["y_nodes"]
    xc = int(np.argmin(np.abs(xn - 0.5)))
    u_col = solver.fields.u.reshape(len(xn), len(yn))[xc, :]
    interp = np.polynomial.chebyshev.Chebyshev.fit(
        yn, u_col, deg=len(yn) - 1, domain=[float(yn[0]), float(yn[-1])])
    return float(np.max(np.abs(interp(data["y"]) - data["u"])))


def phase_fsg():
    solver = FSGSolver(params=params(96, "float32", tolerance=1e-6,
                                     max_iterations=400_000, multigrid="fsg",
                                     n_levels=2, coarse_tolerance_factor=1.0))
    solver.solve()
    m = solver.metrics
    levels = ", ".join(f"N={lv['n']}: {lv['iterations']} it "
                       f"({lv['wall_time']:.2f}s, first chunk "
                       f"{lv['first_chunk_time']:.2f}s)"
                       for lv in solver.levels)
    errs = solver.compute_validation_errors(base_dir=ROOT, save_plots=False)
    ghia = ghia_u_error(solver)
    ratio = m.iterations / JAX_FSG_ITERATIONS
    print(f"[fsg] N=96 Re=1000 tol=1e-6 float32: ladder "
          f"{[lv['n'] for lv in solver.levels]}; {levels}; total "
          f"{m.iterations} iterations ({ratio:.3f} x JAX record), wall "
          f"{m.wall_time_seconds:.3f}s, converged={m.converged}; L2 "
          + " ".join(f"{k}={v:.5f}" for k, v in errs.items())
          + f"; Ghia u-centerline max err {ghia:.4f}", flush=True)
    check(m.converged, "FSG did not converge")
    check(0.8 <= ratio <= 1.2, f"FSG iterations {m.iterations} outside 20% "
          f"of the JAX record {JAX_FSG_ITERATIONS}")
    check(ghia <= GHIA_MAX_ERR, f"Ghia error {ghia:.4f} > {GHIA_MAX_ERR}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    summary = {k: {"name": k, "route": "cuda",
                   "source": f"anap3_tpu_torch/csrc/{k}.cu",
                   "replaces": REPLACES[k]} for k in sgk.KERNELS}
    phase_device()
    phase_kernels(summary)
    sgk.reset_counts()  # the main path starts here
    phase_sg()
    phase_fsg()
    torch.cuda.synchronize()
    launches = dict(sgk.LAUNCHES)
    plain = dict(sgk.PLAIN_CALLS)
    print(f"[main path] kernel launches {launches}; plain calls {plain}",
          flush=True)
    for k in sgk.KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")
        summary[k]["launches"] = launches[k]
    check(not any(plain.values()), f"plain versions ran: {plain}")
    kernels = [{key: summary[k][key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms")} for k in sgk.KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
