#!/usr/bin/env python3
"""Drive the anap3_tpu_torch main path once on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing its own lines and failing the run (exit code 1, no result line)
when it fails:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the cold build of the SG and FV kernels from ``csrc/``
   (one ``nvcc`` per family, started together);
2. SG kernels: every kernel wrapper (step, tau step, chunk of 64 steps with
   metrics_every=16 and warmup 10) against its plain PyTorch version on the
   same CUDA tensors, at N = 48, 96, 128, float32 and float64, smoothed and
   singular lids; tolerances: relative max error <= 1e-11 in float64 and
   <= 1e-4 in float32, done/conv_iter equal; kernel and plain ms/step;
2b. FV kernels: a 32-iteration chunk from rest and one step from the flow
   it reaches, kernel against plain, at 20x20, ny=12 x nx=16 and 128x128,
   float32 and float64 (float64 with n_refine 0 and 1), TVD and upwind;
   tolerances: relative max error <= 1e-10 in float64, <= 1e-4 in float32
   (step and chunk), flags equal; the same kernel chunk run twice must
   agree bit for bit; kernel and plain ms per SIMPLE iteration at N=128,
   per-kernel times, and a torch.profiler idle share of one N=128 float32
   chunk; wherever the pressure solve is refined, one step with perturbed
   eigenvalue inverses, so that the refinement moves the state by far more
   than the bound; then, at N=128 in float32 and float64, a chunk whose
   tolerance is met mid-chunk: flags, NaN rows and the frozen state as the
   plain chunk's;
3. SG N=128 Re=1000 float32 (the BASELINE timesteps/s cell): SGSolver
   .solve(max_iter=50_000) with chunk 5000; steps/s net of the first chunk;
4. FSG N=96 Re=1000 tol=1e-6 float32 (the flagship): FSGSolver.solve() with
   max_iterations=400_000; iterations within 20% of the JAX record
   (176,389), Ghia u-centerline max error <= 0.027, L2 errors against the
   stored FV truth;
2c. the SG smoothing loop (sg_smooth_run, the VMG/FMG smoother) with 2 and
   30 steps against its plain version at N = 48, 96, 192, float32 and
   float64, smoothed and singular lids, forced by a tau that is random
   inside the velocity boundary ring and zero on it (the same bounds as
   phase 2); the x6 chunk (quadratures every step) at N=96 against its
   plain version; ms per step of the loop, of as many sg_step_run calls
   and of the plain loop, at N=96 and N=192 float32;
5. FV N=128 Re=100 tol=1e-6 float32 with the numerics of
   conf/solver/fv.yaml and chunk 1000, through FVSolver.solve(): converged,
   iterations within 20% of the JAX record (11,497), L2 against
   data/validation/fv/Re100 <= 0.003 for u and v, Ghia u-centerline max
   error <= 0.008;
6. FV N=128 Re=1000, the same against 11,570 iterations, L2 <= 0.004 and
   Ghia <= 0.008;
7. VMG [192, 96] Re=1000 float32, the full-width path: 2,000 V-cycles from
   rest at tolerance 0 through VMGSolver.solve(); cycles/s net of the first
   chunk, fine-step equivalents/s and a torch.profiler idle share of one
   50-cycle chunk; the state must be finite;
8. VMG N=48 Re=100 tol=1e-6 float32 (ladder [48, 24]): converged, V-cycles
   within 10% of the JAX package's count and final kinetic energy within
   1e-4 relative of its value (JAX_VMG48, from
   scripts/jax_vmg_reference.py);
9. FMG N=96 Re=100 tol=1e-6 float32 (conf/solver/spectral/fmg.yaml: ladder
   [24, 48, 96], coarse factor 10) with matmul_algorithm=x6, so that its
   N=24 level runs the x6 chunk route: the same checks against JAX_FMG96,
   and the Ghia Re=100 u-centerline max error within 0.005 of the JAX
   value.

Phases 3 to 9 are the main paths: before each, the launch counters of both
kernel families are zeroed, and after it every kernel of its family must
have launched and no plain version run. The line before the last is the
kernels' JSON summary (launches summed over the main paths; bound_ms the
least time the card could take for the timed work, from the shapes and the
card's published peaks); the last line is the result object.

``python3 chip_smoke.py --flagship-vmg`` instead runs the converged VMG
[192, 96] Re=1000 tol=1e-6 float32 solve (the JAX record: 47,685 cycles,
L2 0.0995 / 0.0758) and prints its cycles, wall, cycles/s, L2 against the
stored FV truth and Ghia u-centerline error.
"""

from __future__ import annotations

import argparse
import dataclasses
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

from anap3_tpu_torch.models import fv as fvm  # noqa: E402
from anap3_tpu_torch.models import spectral_sg as core  # noqa: E402
from anap3_tpu_torch.models.params import (FVParameters,  # noqa: E402
                                           SpectralParameters)
from anap3_tpu_torch.models.runner import control_step, freeze  # noqa: E402
from anap3_tpu_torch.models import runner as TR  # noqa: E402
from anap3_tpu_torch.models import spectral_vmg as vmg  # noqa: E402
from anap3_tpu_torch.models.spectral import (FSGSolver, SGSolver,  # noqa: E402
                                             make_fused_paths)
from anap3_tpu_torch.ops import fv_kernels as fvk  # noqa: E402
from anap3_tpu_torch.ops import sg_kernels as sgk  # noqa: E402
from anap3_tpu_torch.ops._build import build_all, build_info  # noqa: E402

JAX_FSG_ITERATIONS = 176_389  # JAX record for the flagship FSG config
GHIA_MAX_ERR = 0.027
# anap3_tpu on the CPU in float32 (scripts/jax_vmg_reference.py): V-cycles
# (FMG: iterations summed over its levels), final kinetic energy, Ghia
# Re=100 u-centerline max error
JAX_VMG48 = (1678, 0.03288045898079872, 0.0023671919441865426)
JAX_FMG96 = (5891, 0.032877251505851746, 0.0023731883057019794)
# the JAX record of the converged VMG [192, 96] Re=1000 tol 1e-6 f32 solve
# (STATUS.md, solver study r3): cycles, L2 u and v
JAX_VMG192 = (47_685, 0.0995, 0.0758)
# every pallas_call site the SG kernels stand in for: the aligned and
# tiled chunks, the tiled step with tau, the x6 step and chunk, and the
# aligned tau step (the VMG smoother)
_SG_SITES = ("anap3_tpu/ops/pallas_tiled.py:545, pallas_tiled.py:721, "
             "pallas_aligned.py:647, pallas_aligned.py:934, "
             "pallas_step.py:168, pallas_chunk.py:176")
REPLACES = {  # TPU kernels each CUDA kernel stands in for (pallas_call site)
    "sg_stage": _SG_SITES,
    "sg_diag": _SG_SITES,
    "sg_control": _SG_SITES,
    # the body _make_iterate of make_pallas_fv_step / _chunk_runner
    "fv_stencil": "anap3_tpu/ops/pallas_fv.py:415",
    "fv_bicgstab": "anap3_tpu/ops/pallas_fv.py:415",
    "fv_dense": "anap3_tpu/ops/pallas_fv.py:415",
    # the chunk's state machine (and the step's metrics vector)
    "fv_control": "anap3_tpu/ops/pallas_fv.py:515",
}
FV_K = 16  # conf/solver/fv.yaml fv_inner_iters
# (JAX record of iterations, STATUS.md:190-199; L2 bound against the
# stored N=128 FV truth)
FV_TARGETS = {100.0: (11_497, 0.003), 1000.0: (11_570, 0.004)}
FV_GHIA_MAX_ERR = 0.008
FV_F64_TOL = 1e-10
# float32, step and chunk: the kernels sum in another order than torch, and
# over 32 iterations from rest those roundings grow to ~1e-6 relative
# (H100); the BiCGSTAB guard, which could flip on rounding near
# convergence, stays active in that transient. 1e-4 leaves a 100x margin.
FV_F32_TOL = 1e-4
# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
# FLOP/s by dtype, the highest rate the card offers for it (float32 outside
# the tensor cores; float64 on its FP64 tensor cores, twice its vector
# rate), and HBM bytes/s
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
PEAK_BYTES = 3.35e12


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


def bound(flops, nbytes, dtype):
    """(ms, what bounds it): the least time the card could take for work
    that does ``flops`` operations in ``dtype`` and must move ``nbytes``
    (each input read once, each output written once)."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sg_work(nf, dtype):
    """(operations, bytes) of the SG kernels' timed launch groups at order
    nf - 1, counted from the shapes: a product of (m x k) by (k x n) is
    2mkn operations; elementwise work is left out (it only lowers the
    bound).

    - sg_stage, one RK stage: the 8 full-grid products of the residuals
      (Dx, Dxx from the left and DyT, DyyT from the right on u and v) and
      the two pressure-gradient chains Gx p IyT, Ix p GyT; it reads the
      stage and base states, 8 operators and the BCs, writes a state;
    - sg_diag, dt and the quadratures: omega = Dx v - u DyT, then Dx omega
      and omega DyT; reads u, v, Dx, DyT, W2d;
    - sg_control, one sampled step: the reductions and the state commit;
      reads and writes a state.
    """
    ni, e = nf - 2, torch.finfo(dtype).bits // 8
    full, inner = nf * nf, ni * ni
    return {
        "sg_stage": (16 * nf ** 3 + 4 * nf * ni * ni + 4 * nf * nf * ni,
                     e * (12 * full + 3 * inner + 4 * nf * ni)),
        "sg_diag": (8 * nf ** 3, e * 5 * full),
        "sg_control": (0, e * 2 * (2 * full + inner)),
    }


def sg_bounds(nf, dtype):
    return {k: bound(f, b, dtype) for k, (f, b) in sg_work(nf, dtype).items()}


def steps_bound(nf, dtype, n_steps, n_quad):
    """Bound of ``n_steps`` RK4 steps (four stages each) with ``n_quad``
    quadrature passes, the input state, forcing and operators read once
    and the output state written once: a chunk, a step, or the smoothing
    loop."""
    ni, e = nf - 2, torch.finfo(dtype).bits // 8
    work = sg_work(nf, dtype)
    flops = 4 * n_steps * work["sg_stage"][0] + n_quad * work["sg_diag"][0]
    return bound(flops, e * (13 * nf * nf + 3 * ni * ni + 4 * nf * ni), dtype)


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
    t0 = time.time()
    build_all()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"card {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"kernel builds {time.time() - t0:.1f}s wall", flush=True)
    for family in ("sg", "fv"):
        info = build_info(family)
        check(info.get("path"), f"the {family} kernel library did not load")
        report = info.get("ptxas", "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = [int(b) for b in
                  re.findall(r"(\d+) bytes spill stores", report)]
        print(f"[device] {family} kernels: nvcc {info['build_seconds']:.1f}s "
              f"(cached={info.get('cached')}); ptxas: {len(regs)} kernels, "
              f"max {max(regs, default=0)} registers, {sum(spills)} bytes of "
              f"spill stores (report: {Path(info['path']).parent / 'build.log'})",
              flush=True)
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
                    # quadratures at i = 0 and every m_every-th step
                    b_ms, b_by = steps_bound(ops.nf, ops.dtype, chunk,
                                             chunk // m_every)
                    print(f"[kernels] N={n} {dt_name}: chunk ms/step kernel "
                          f"{t_k:.4f} plain {t_p:.4f} bound "
                          f"{b_ms / chunk:.5f} ({b_by})", flush=True)
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
    for name, (b_ms, b_by) in sg_bounds(ops.nf, ops.dtype).items():
        summary[name].update(bound_ms=b_ms, bound_by=b_by, library_ms=None)
    for name in sgk.KERNELS:
        print(f"[kernels] {name} at N=128 float32: kernel "
              f"{summary[name]['ms']:.4f} ms, plain "
              f"{summary[name]['plain_ms']:.4f} ms, bound "
              f"{summary[name]['bound_ms']:.5f} ms "
              f"({summary[name]['bound_by']})", flush=True)


def ring_zero_tau(ops, rng, scale=0.01):
    """A FAS forcing as a V-cycle makes it: random inside the velocity
    boundary ring, zero on it (the pressure forcing everywhere)."""
    nf = ops.nf
    ring = ops.interior.to(ops.dtype)
    return tuple(
        torch.as_tensor(scale * rng.standard_normal(shape), dtype=ops.dtype,
                        device=ops.device) * m
        for shape, m in (((nf, nf), ring), ((nf, nf), ring),
                         ((nf - 2, nf - 2), 1.0)))


def phase_smoother():
    """Phase 2c: the smoothing loop and the x6 chunk against their plain
    versions, and the loop's time per step."""
    rng = np.random.default_rng(2)
    # N=24 is the coarse level of the VMG N=48 and FMG ladders
    for n in (24, 48, 96, 192):
        for dt_name in ("float32", "float64"):
            tol = 1e-4 if dt_name == "float32" else 1e-11
            for corner in ("smoothing", "singular"):
                ops, _ = core.build_spectral_ops(params(n, dt_name, corner))
                smooth = sgk.make_sg_smoother(ops)
                st = core.initial_state(ops)
                tau = ring_zero_tau(ops, rng)
                errs = []
                for n_steps in (2, 30):
                    s_k, m_k = smooth(st, tau, n_steps)
                    torch.cuda.synchronize()  # a fault shows where it happened
                    s_p, m_p = sgk.smooth_plain(ops, st, tau, n_steps)
                    errs.append(max([rel_err(a, b) for a, b in zip(s_k, s_p)]
                                    + [rel_err(m_k[k], m_p[k]) for k in m_p]))
                print(f"[smoother] N={n} {dt_name} {corner}: 2 steps "
                      f"{errs[0]:.2e}, 30 steps {errs[1]:.2e} (tol {tol:.0e})",
                      flush=True)
                check(max(errs) <= tol, f"smoother N={n} {dt_name} {corner}: "
                      f"relative error {max(errs):.3e} > {tol:.0e}")
    # the x6 route: the chunk kernel with quadratures every step, at N=24
    # (FMG's coarsest stage, where the main path runs it) and at N=96
    for n in (24, 96):
        ops, _ = core.build_spectral_ops(params(n, "float32"))
        _, factory = make_fused_paths(ops, "x6")
        st0 = core.initial_state(ops)
        out_k = factory(64, 1e-30, "rel_iter")(st0, 0, float("inf"))
        out_p = sgk.chunk_plain(ops, st0, 0, float("inf"), 64, 1e-30, 10,
                                False, 1)
        err = max([rel_err(a, b) for a, b in zip(out_k[0], out_p[0])]
                  + [rel_err(out_k[4][:, c], out_p[4][:, c])
                     for c in range(7)])
        flags_k = [int(out_k[i]) for i in (1, 2, 3)]
        flags_p = [int(out_p[i]) for i in (1, 2, 3)]
        print(f"[smoother] x6 chunk N={n} float32, 64 steps, metrics every "
              f"step: relative error {err:.2e}, flags {flags_k} (plain "
              f"{flags_p})", flush=True)
        check(err <= 1e-4 and flags_k == flags_p,
              f"x6 chunk N={n} differs from plain")
    t_x6 = cuda_ms(lambda: factory(64, 1e-30, "rel_iter")(
        st0, 0, float("inf")), 3) / 64
    t_x6p = cuda_ms(lambda: sgk.chunk_plain(
        ops, st0, 0, float("inf"), 64, 1e-30, 10, False, 1), 1) / 64
    step = sgk.make_sg_step(ops)
    t_st = cuda_ms(lambda: step(st0), 20)
    t_stp = cuda_ms(lambda: sgk.step_plain(ops, st0), 5)
    b_chunk = steps_bound(ops.nf, ops.dtype, 64, 64)[0] / 64
    b_step, b_by = steps_bound(ops.nf, ops.dtype, 1, 1)
    print(f"[smoother] x6 route N=96 float32: chunk {t_x6:.4f} ms/step "
          f"(plain {t_x6p:.4f}, bound {b_chunk:.5f}), step {t_st:.4f} ms "
          f"(plain {t_stp:.4f}, bound {b_step:.5f}; {b_by})", flush=True)
    for n in (96, 192):
        ops, _ = core.build_spectral_ops(params(n, "float32"))
        smooth = sgk.make_sg_smoother(ops)
        step = sgk.make_sg_step(ops, with_tau=True)
        st = core.initial_state(ops)
        tau = ring_zero_tau(ops, rng)

        def steps():
            s = st
            for _ in range(30):
                s, _ = step(s, tau)
            return s

        t_loop = cuda_ms(lambda: smooth(st, tau, 30), 10) / 30
        t_steps = cuda_ms(steps, 3) / 30
        t_plain = cuda_ms(lambda: sgk.smooth_plain(ops, st, tau, 30), 1) / 30
        b_ms, b_by = steps_bound(ops.nf, ops.dtype, 30, 1)
        print(f"[smoother] N={n} float32, 30 forced steps: loop "
              f"{t_loop:.4f} ms/step, sg_step_run calls {t_steps:.4f}, plain "
              f"{t_plain:.4f}; bound {b_ms / 30:.5f} ms/step ({b_by})",
              flush=True)


def fv_params(ny, nx, dtype, scheme="TVD", **kw):
    # the shipped conf/solver/fv.yaml numerics
    base = dict(Re=100.0, nx=nx, ny=ny, convection_scheme=scheme,
                limiter="MUSCL", alpha_uv=0.4, alpha_p=0.2,
                linear_solver_tol=1e-9, rhie_chow="compact",
                corner_treatment="none", fv_inner_iters=FV_K, dtype=dtype,
                device="cuda", chunk_size=1000, convergence_metric="auto")
    base.update(kw)
    return FVParameters(**base)


def fv_cases():
    """(ny, nx, dtype, n_refine, scheme) of phase 2b. float64 runs with its
    default n_refine = 0 and again with one refinement step, float32's
    default, so that the refinement residual and the accumulating product
    are held at the float64 bound too: in float32 their correction is of the
    order of the solve's rounding, far below the float32 bound."""
    for ny, nx in ((20, 20), (12, 16), (128, 128)):
        for dt_name in ("float32", "float64"):
            for n_refine in (None,) if dt_name == "float32" else (None, 1):
                for scheme in ("TVD", "Upwind"):
                    yield ny, nx, dt_name, n_refine, scheme


def fv_ops(p, n_refine=None):
    ops, _ = fvm.build_fv_ops(p)
    if n_refine is not None:
        ops = dataclasses.replace(ops, n_refine=n_refine)
    return ops


def phase_fv_kernels(summary):
    chunk = 32
    inf = float("inf")
    for ny, nx, dt_name, n_refine, scheme in fv_cases():
        tol = FV_F32_TOL if dt_name == "float32" else FV_F64_TOL
        p = fv_params(ny, nx, dt_name, scheme)
        ops = fv_ops(p, n_refine)
        case = f"{ny}x{nx} {dt_name} {scheme} n_refine={ops.n_refine}"
        S = fvk.statics(p, ops)
        st0 = fvm.initial_state(ops)
        run_k = fvk.make_fv_chunk_runner(p, ops, chunk, 1e-30, 10, FV_K)
        out_k = run_k(st0, 0, inf)
        torch.cuda.synchronize()  # a fault shows where it happened
        out_p = fvk.chunk_plain(S, st0, 0, inf, chunk, 1e-30, 10, FV_K)
        e_chunk = max(rel_err(a, b) for a, b in zip(out_k[0], out_p[0]))
        e_rows = max(rel_err(out_k[4][:, c], out_p[4][:, c])
                     for c in range(7))  # per column
        flags_k = [int(out_k[i]) for i in (1, 2, 3)]
        flags_p = [int(out_p[i]) for i in (1, 2, 3)]
        again = run_k(st0, 0, inf)
        bitwise = (all(torch.equal(a, b) for a, b in zip(out_k[0], again[0]))
                   and torch.equal(out_k[4], again[4]))
        # one step from the flow the chunk reached
        flow = out_p[0]
        s_k, m_k = fvk.make_fv_step(p, ops, FV_K)(flow)
        s_p, m_p = fvk.step_plain(S, flow, FV_K)
        e_step = max(rel_err(a, b) for a, b in zip(s_k, s_p))
        e_met = max(rel_err(m_k[k], m_p[k]) for k in m_p)
        worst = max(e_chunk, e_rows, e_step, e_met)
        print(f"[fv kernels] {case}: step state {e_step:.2e} metrics "
              f"{e_met:.2e} chunk state {e_chunk:.2e} rows {e_rows:.2e} "
              f"flags {flags_k} bitwise repeat {bitwise} (tol {tol:.0e})",
              flush=True)
        check(worst <= tol, f"FV {case}: relative error {worst:.3e} > "
              f"{tol:.0e}")
        check(flags_k == flags_p, f"FV flags differ: {flags_k} vs {flags_p}")
        check(bitwise, f"FV {case}: two runs of one kernel chunk differ")
        if ops.n_refine and scheme == "TVD":
            refinement_check(S, ops, flow, tol, case)
        if nx == 128 and scheme == "TVD" and n_refine is None:
            t_k = cuda_ms(lambda: run_k(st0, 0, inf), 3) / chunk
            t_p = cuda_ms(lambda: fvk.chunk_plain(
                S, st0, 0, inf, chunk, 1e-30, 10, FV_K), 1) / chunk
            work = fv_work(ops).values()
            b_ms, b_by = bound(sum(w[0] for w in work),
                               sum(w[1] for w in work), ops.dtype)
            print(f"[fv kernels] N=128 {dt_name}: ms per SIMPLE iteration, "
                  f"kernel chunk {t_k:.4f} plain {t_p:.4f} bound {b_ms:.5f} "
                  f"({b_by})", flush=True)
            if dt_name == "float32":
                fv_kernel_checks(p, ops, flow, summary)
                profile_fv_chunk(p, ops, flow)


def perturbed_solve(S, seed=0, size=0.5):
    """The statics ``S`` with the eigenvalue inverses of the pressure solve
    scaled by 1 + size * u, u uniform in [-1, 1]. The first solve then
    misses by up to ``size`` and the refinement step moves the state by
    4e-3 to 2e-2 relative (20x20 to 128x128). With the exact inverses it
    moves it by the solve's rounding (~1e-16 in float64, ~3e-8 in float32),
    which no bound can tell from a wrong refinement residual or a wrong
    accumulating product."""
    rng = np.random.default_rng(seed)
    inv = S["inv_lam"]
    scale = torch.as_tensor(1 + size * rng.uniform(-1, 1, tuple(inv.shape)),
                            dtype=inv.dtype, device=inv.device)
    return dict(S, inv_lam=(inv * scale).contiguous())


def refinement_check(S, ops, flow, tol, case):
    """One kernel step against the plain step with a perturbed pressure
    solve (``perturbed_solve``) and ``ops.n_refine`` refinement steps."""
    S2 = perturbed_solve(S)
    s_k, m_k = fvk._step_kernel(S2, ops, flow, FV_K)
    s_p, m_p = fvk.step_plain(S2, flow, FV_K)
    s_0, _ = fvk.step_plain(dict(S2, n_refine=0), flow, FV_K)
    err = max([rel_err(a, b) for a, b in zip(s_k, s_p)]
              + [rel_err(m_k[k], m_p[k]) for k in m_p])
    moved = max(rel_err(a, b) for a, b in zip(s_0, s_p))
    print(f"[fv kernels] {case} perturbed solve: step {err:.2e} (the "
          f"refinement moves the state by {moved:.2e}; tol {tol:.0e})",
          flush=True)
    check(moved > 10 * tol, f"FV {case}: the perturbed solve leaves the "
          f"refinement too small to check ({moved:.2e})")
    check(err <= tol, f"FV {case} perturbed solve: relative error "
          f"{err:.3e} > {tol:.0e}")


def phase_fv_flags():
    """The chunk's state machine at N=128, float32 and float64: a tolerance
    met mid-chunk, between two successive rel_iter values of a plain probe
    chunk from rest (a gap of 1% or more, so that rounding cannot move the
    crossing), must give the same done, conv_iter and converged flags, the
    same NaN rows from the crossing on, and the same frozen state as the
    plain chunk."""
    chunk, warmup = 30, 10
    inf = float("inf")
    for dt_name in ("float32", "float64"):
        tol_err = FV_F32_TOL if dt_name == "float32" else FV_F64_TOL
        p = fv_params(128, 128, dt_name)
        ops = fv_ops(p)
        S = fvk.statics(p, ops)
        st0 = fvm.initial_state(ops)
        rel = fvk.chunk_plain(S, st0, 0, inf, chunk, 1e-30, warmup,
                              FV_K)[4][:, 0].double().cpu().numpy()
        tol = None
        for i in range(warmup + 2, chunk - 5):
            above = float(np.min(rel[warmup:i]))
            if above > 1.01 * rel[i]:
                tol = float(np.sqrt(above * rel[i]))
                break
        check(tol is not None, f"FV flags {dt_name}: no mid-chunk crossing "
              f"in the probe rows {rel}")
        out_k = fvk.make_fv_chunk_runner(p, ops, chunk, tol, warmup, FV_K)(
            st0, 0, inf)
        out_p = fvk.chunk_plain(S, st0, 0, inf, chunk, tol, warmup, FV_K)
        flags_k = [int(out_k[i]) for i in (1, 2, 3)]
        flags_p = [int(out_p[i]) for i in (1, 2, 3)]
        nan_k = torch.isnan(out_k[4]).cpu()
        nan_p = torch.isnan(out_p[4]).cpu()
        conv = flags_p[1]
        e_state = max(rel_err(a, b) for a, b in zip(out_k[0], out_p[0]))
        e_rows = max(rel_err(out_k[4][:, c], out_p[4][:, c])
                     for c in range(7))
        print(f"[fv flags] 128x128 {dt_name} tol {tol:.6e}: flags kernel "
              f"{flags_k} plain {flags_p}; NaN rows from {conv}; state "
              f"{e_state:.2e} rows {e_rows:.2e} (tol {tol_err:.0e})",
              flush=True)
        check(flags_p[0] == 1 and flags_p[2] == 1 and conv == i + 1,
              f"FV flags {dt_name}: the plain chunk did not converge at "
              f"iteration {i + 1}: {flags_p}")
        check(flags_k == flags_p, f"FV flags {dt_name} differ: {flags_k} vs "
              f"{flags_p}")
        check(torch.equal(nan_k, nan_p) and bool(nan_p[conv:].all())
              and not bool(nan_p[:conv].any()),
              f"FV flags {dt_name}: NaN rows differ")
        check(max(e_state, e_rows) <= tol_err, f"FV flags {dt_name}: "
              f"relative error {max(e_state, e_rows):.3e} > {tol_err:.0e}")


def fv_kernel_checks(p, ops, state, summary):
    """Each FV kernel on the main path's inputs (one step from a developing
    N=128 float32 flow): its output's absolute error against the plain
    phase it stands for, then the time of one iteration's launches of it
    (bench entry of the library, CUDA events) beside that plain phase."""
    S = fvk.statics(p, ops)
    ws = fvk.bench_workspace(S, ops, state, FV_K)
    u, v, pr, mx, my = fvk.pad_state(state)
    c = fvk.plain_assemble(S, u, v, pr, mx, my)
    us, vs = fvk.plain_bicgstab(c, u, v, FV_K)
    Du, mxs, mys, rhsp = fvk.plain_rhie_chow(S, c, us, vs, pr)
    pp = fvk.plain_pressure(S, rhsp)
    new, met = fvk.plain_correct(S, Du, us, vs, pr, mxs, mys, pp)

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    new_k = [ws[k] for k in fvm.FVState._fields]
    summary["fv_stencil"]["max_abs_err"] = max(
        [err(ws["aPr"], c["aP_rel"]), err(ws["rhsp"], rhsp)]
        + [err(a, b) for a, b in zip(new_k, fvk.unpad_state(*new))])
    summary["fv_bicgstab"]["max_abs_err"] = max(err(ws["x"][0], us),
                                                err(ws["x"][1], vs))
    summary["fv_dense"]["max_abs_err"] = err(ws["pp"] - ws["pp"][0, 0], pp)
    summary["fv_control"]["max_abs_err"] = err(ws["metrics"], met)
    print("[fv kernels] N=128 float32 developing flow: abs err "
          + ", ".join(f"{k} {summary[k]['max_abs_err']:.3e}"
                      for k in fvk.KERNELS), flush=True)

    reps = 50  # the bench launches update ws in place: errors first
    for name in fvk.KERNELS:
        summary[name]["ms"] = cuda_ms(
            lambda: fvk.bench_kernel(S, ops, ws, name, FV_K, reps), 1) / reps
    done = torch.zeros((), dtype=torch.bool, device=ops.device)
    nan = torch.full((), float("nan"), dtype=ops.dtype, device=ops.device)
    nrm = lambda a: torch.sqrt(torch.sum(a * a))

    def plain_stencil():
        cc = fvk.plain_assemble(S, u, v, pr, mx, my)
        d = fvk.plain_rhie_chow(S, cc, us, vs, pr)
        return fvk.plain_correct(S, d[0], us, vs, pr, d[1], d[2], pp)

    def plain_control():
        rel = torch.maximum(nrm(new[0] - u) / (nrm(u) + 1e-12),
                            nrm(new[1] - v) / (nrm(v) + 1e-12))
        row = torch.where(done, nan, rel)
        now = done | ((rel < 1e-30) & torch.isfinite(rel))
        return row, now, [torch.where(done, a, b)
                          for a, b in zip((u, v, pr, mx, my), new)]

    for name, fn in (("fv_stencil", plain_stencil),
                     ("fv_bicgstab", lambda: fvk.plain_bicgstab(c, u, v,
                                                                FV_K)),
                     ("fv_dense", lambda: fvk.plain_pressure(S, rhsp)),
                     ("fv_control", plain_control)):
        summary[name]["plain_ms"] = cuda_ms(fn, 20)
    for name, (flops, nbytes) in fv_work(ops).items():
        b_ms, b_by = bound(flops, nbytes, ops.dtype)
        summary[name].update(bound_ms=b_ms, bound_by=b_by, library_ms=None)
    summary["fv_dense"]["library_ms"] = dense_library_ms(ops)
    for name in fvk.KERNELS:
        lib = summary[name]["library_ms"]
        print(f"[fv kernels] {name} at N=128 float32, one iteration's "
              f"launches: kernel {summary[name]['ms']:.4f} ms, plain "
              f"{summary[name]['plain_ms']:.4f} ms, bound "
              f"{summary[name]['bound_ms']:.5f} ms "
              f"({summary[name]['bound_by']})"
              + ("" if lib is None else f", torch.matmul {lib:.4f} ms"),
              flush=True)


def fv_work(ops):
    """(operations, bytes) of one SIMPLE iteration's launches of each FV
    kernel at ny x nx cells (c of them), from the shapes; arithmetic not
    counted below only lowers the bound.

    - fv_stencil: assembly, Rhie-Chow, refinement residual, correction and
      metrics read the state (u, v, p and the two face fluxes), the
      momentum solution and p' (8 c) and write the five coefficient
      arrays with the two right-hand sides, the pressure right-hand side
      and the new state (13 c); ~100 operations a cell;
    - fv_bicgstab: K iterations on the two momentum systems, each two
      5-point applications with the Jacobi scaling (11 operations a cell),
      four dots and six axpys (2 each): 40 operations a cell a system an
      iteration; it reads the 5 coefficients, 2 right-hand sides and 2
      starting vectors and writes the 2 solutions;
    - fv_dense: 4 (1 + n_refine) products of the separable pressure solve,
      2 ny^2 nx or 2 ny nx^2 each; it reads the two eigenvector bases, the
      eigenvalue inverses and the right-hand side and writes p';
    - fv_control: the rows' norms of the new and old velocities (4 c read).
    """
    ny, nx = ops.ny, ops.nx
    c, e = ny * nx, torch.finfo(ops.dtype).bits // 8
    solves = 1 + ops.n_refine
    return {
        "fv_stencil": (100 * c, e * 21 * c),
        "fv_bicgstab": (FV_K * 2 * 40 * c, e * 11 * c),
        "fv_dense": (solves * (4 * ny * ny * nx + 4 * ny * nx * nx),
                     e * (ny * ny + nx * nx + 3 * c)),
        "fv_control": (4 * c, e * 4 * c),
    }


def dense_library_ms(ops):
    """torch.matmul doing fv_dense's products: per solve, the two basis
    changes and their inverses (V1^T R, . V2, V1 ., . V2^T) on ny x nx
    operands in the working dtype, TF32 off."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    g = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(dtype=ops.dtype, device="cuda", generator=g)
    V1 = torch.randn(ops.ny, ops.ny, **kw)
    V2 = torch.randn(ops.nx, ops.nx, **kw)
    R = torch.randn(ops.ny, ops.nx, **kw)

    def products():
        t = R
        for _ in range(1 + ops.n_refine):
            t = V1 @ ((V1.T @ t) @ V2) @ V2.T
        return t

    return cuda_ms(products, 50)


def trace_device(fn, what):
    """The device activities of ``fn()`` under torch.profiler, and the host
    seconds it took; None, with a line saying so, when the profiler cannot
    start tracing the card. A trace without device activity fails the run."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as exc:
        print(f"[{what}] not measured: the profiler did not start: {exc}",
              flush=True)
        return None
    try:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        host = time.time() - t0
    finally:
        prof.stop()
    dev = [e for e in prof.events()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    check(dev, f"{what}: no device activity in the trace")
    return dev, host


def profile_fv_chunk(p, ops, state):
    """Device busy time by kernel and the idle share of one 100-iteration
    N=128 float32 chunk, by torch.profiler, after a warm-up chunk."""
    run = fvk.make_fv_chunk_runner(p, ops, 100, 1e-30, 10, FV_K)
    run(state, 0, float("inf"))
    torch.cuda.synchronize()
    # every device activity: the FV kernels, and the state clone and flag
    # upload of the chunk's workspace
    traced = trace_device(lambda: run(state, 0, float("inf")), "fv profile")
    if traced is not None:
        dev, _ = traced
        start = min(e.time_range.start for e in dev)
        end = max(e.time_range.end for e in dev)
        busy = sum(e.time_range.elapsed_us() for e in dev)
        by_name = {}
        for e in dev:
            named = re.search(r"(\w+_kernel)\b", e.name)
            key = named.group(1) if named else e.name[:24]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
        parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / busy:.0%})"
                          for k, v in sorted(by_name.items(),
                                             key=lambda kv: -kv[1]))
        print(f"[fv profile] N=128 float32 100-iteration chunk: window "
              f"{(end - start) / 1e3:.3f} ms, device time {busy / 1e3:.3f} ms, "
              f"idle share {1 - busy / (end - start):.3f}, {len(dev)} "
              f"device activities; {parts}", flush=True)


def ghia_u_error_fv(solver) -> float:
    """Max |u - Ghia| along x = 0.5 by bilinear evaluation of the cell
    fields, NaN-masked (tests/test_fv.py's check)."""
    re = int(solver.params.Re)
    data = np.genfromtxt(
        ROOT / f"data/validation/ghia/ghia_Re{re}_u_centerline.csv",
        delimiter=",", names=True)
    u_c, _ = solver._evaluate_at_points(np.full(len(data), 0.5), data["y"])
    valid = ~np.isnan(u_c)
    return float(np.max(np.abs(u_c[valid] - data["u"][valid])))


def phase_fv_solve(re):
    target, l2_max = FV_TARGETS[re]
    solver = fvm.FVSolver(params=fv_params(128, 128, "float32", Re=re,
                                           tolerance=1e-6,
                                           max_iterations=30_000))
    t0 = time.time()
    solver.solve()
    torch.cuda.synchronize()
    wall = time.time() - t0
    m = solver.metrics
    errs = solver.compute_validation_errors(base_dir=ROOT, save_plots=False)
    ghia = ghia_u_error_fv(solver)
    ratio = m.iterations / target
    print(f"[fv] N=128 Re={re:g} tol=1e-6 float32: {m.iterations} iterations "
          f"({ratio:.3f} x JAX record {target}), wall "
          f"{m.wall_time_seconds:.3f}s (call {wall:.3f}s, first chunk "
          f"{solver.first_chunk_time:.3f}s), converged={m.converged}; L2 "
          + " ".join(f"{k}={v:.6f}" for k, v in errs.items())
          + f"; Ghia u-centerline max err {ghia:.4f}", flush=True)
    check(m.converged, f"FV Re={re:g} did not converge")
    check(0.8 <= ratio <= 1.2, f"FV Re={re:g} iterations {m.iterations} "
          f"outside 20% of the JAX record {target}")
    for key in ("u_L2_error", "v_L2_error"):
        check(errs.get(key, np.inf) <= l2_max, f"FV Re={re:g} {key} "
              f"{errs.get(key)} > {l2_max}")
    check(ghia <= FV_GHIA_MAX_ERR, f"FV Re={re:g} Ghia error {ghia:.4f} > "
          f"{FV_GHIA_MAX_ERR}")


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
    return net


def ghia_u_error(solver, re=1000) -> float:
    """Max |u - Ghia| along the vertical centerline x = 0.5: the degree-N
    Chebyshev interpolant of the x=0.5 node column, at Ghia's y."""
    data = np.genfromtxt(
        ROOT / f"data/validation/ghia/ghia_Re{re}_u_centerline.csv",
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


def vmg_params(n, re, **kw):
    # conf/solver/spectral/vmg.yaml on the sg.yaml numerics
    base = dict(Re=re, multigrid="vmg", n_levels=3,
                coarse_tolerance_factor=1.0, max_iterations=400_000)
    base.update(kw)
    return params(n, "float32", **base)


def phase_vmg_wide():
    """Phase 7: 2,000 V-cycles of VMG [192, 96] Re=1000 from rest."""
    solver = vmg.VMGSolver(params=vmg_params(192, 1000.0, tolerance=0.0,
                                             max_iterations=8000))
    t0 = time.time()
    solver.solve()
    torch.cuda.synchronize()
    wall = time.time() - t0
    m = solver.metrics
    first = solver.first_chunk_time
    chunk = 50
    rate = (m.iterations - chunk) / max(m.wall_time_seconds - first, 1e-9)
    print(f"[vmg] [192, 96] Re=1000 float32: ladder {solver.ladder}, "
          f"{m.iterations} V-cycles in {m.wall_time_seconds:.3f}s (call "
          f"{wall:.3f}s), first_chunk_seconds {first:.3f}, cycles/s net of "
          f"the first chunk {rate:.1f}, fine-step equivalents/s "
          f"{4 * rate:.1f}, energy {m.final_energy:.6f}", flush=True)
    check(solver.ladder == [192, 96], f"ladder {solver.ladder}")
    check(m.iterations == 2000, f"{m.iterations} V-cycles, not 2000")
    check(all(bool(torch.isfinite(t).all()) for t in solver.state),
          "VMG state is not finite")
    return solver


def profile_vmg_chunk(solver):
    """Device busy time by kernel and the idle share of one 50-cycle chunk
    of the phase-7 hierarchy from its final state, by torch.profiler, after
    a warm-up chunk."""
    levels = vmg.build_vmg_levels(solver.params)
    smoothers = {i: sgk.make_sg_smoother(lv.ops) for i, lv in enumerate(levels)}
    cycle = vmg.make_v_cycle(levels, smoothers=smoothers)
    run = TR.make_chunk_runner(cycle, lambda s: (s.u, s.v), 50, 0.0)
    inf = torch.tensor(float("inf"), device=solver.device)
    run(solver.state, 0, inf)
    torch.cuda.synchronize()
    traced = trace_device(lambda: run(solver.state, 0, inf), "vmg profile")
    if traced is not None:
        dev, host = traced
        start = min(e.time_range.start for e in dev)
        end = max(e.time_range.end for e in dev)
        busy = sum(e.time_range.elapsed_us() for e in dev)
        by_name = {}
        for e in dev:
            # the function's name: the identifier before its template
            # arguments and parameter list
            named = re.search(r"(\w+)(?:<[^()]*>)?\(", e.name)
            key = named.group(1) if named else e.name[:32]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / busy:.0%})"
                          for k, v in top)
        print(f"[vmg profile] [192, 96] 50-cycle chunk: host {host:.3f}s, "
              f"window {(end - start) / 1e3:.3f} ms, device time "
              f"{busy / 1e3:.3f} ms, idle share {1 - busy / (end - start):.3f}, "
              f"{len(dev)} device activities; top: {parts}", flush=True)


def check_against_jax(what, solver, ref, ladder):
    m = solver.metrics
    cycles, energy, ghia_ref = ref
    ghia = ghia_u_error(solver, re=100)
    ratio = m.iterations / cycles
    e_rel = abs(m.final_energy - energy) / energy
    print(f"[{what}] ladder {ladder}: {m.iterations} iterations ({ratio:.3f} "
          f"x JAX {cycles}), wall {m.wall_time_seconds:.3f}s (first chunk "
          f"{solver.first_chunk_time:.3f}s), converged={m.converged}, energy "
          f"{m.final_energy:.9f} (JAX {energy:.9f}, rel {e_rel:.2e}), Ghia "
          f"Re=100 u max err {ghia:.5f} (JAX {ghia_ref:.5f})", flush=True)
    check(m.converged, f"{what} did not converge")
    check(0.9 <= ratio <= 1.1, f"{what}: {m.iterations} iterations outside "
          f"10% of the JAX count {cycles}")
    check(e_rel <= 1e-4, f"{what}: energy {m.final_energy} vs JAX {energy}")
    check(ghia <= ghia_ref + 0.005, f"{what}: Ghia error {ghia:.5f}")


def phase_vmg48():
    """Phase 8: VMG N=48 Re=100 tol 1e-6, converged."""
    solver = vmg.VMGSolver(params=vmg_params(48, 100.0, tolerance=1e-6))
    solver.solve()
    check(solver.ladder == [48, 24], f"ladder {solver.ladder}")
    check_against_jax("vmg N=48 Re=100", solver, JAX_VMG48, solver.ladder)


def phase_fmg96():
    """Phase 9: FMG N=96 Re=100 tol 1e-6 (conf/solver/spectral/fmg.yaml),
    with matmul_algorithm=x6: its coarsest (N=24) level runs the x6 route
    of the SG chunk kernel, quadratures every step."""
    solver = vmg.FMGSolver(params=params(
        96, "float32", Re=100.0, tolerance=1e-6, max_iterations=400_000,
        multigrid="fmg", n_levels=3, coarse_tolerance_factor=10.0,
        matmul_algorithm="x6"))
    solver.solve()
    ladder = [lv["n"] for lv in solver.levels]
    check(ladder == [24, 48, 96], f"ladder {ladder}")
    print("[fmg] levels: " + ", ".join(
        f"N={lv['n']}: {lv['iterations']} it ({lv['wall_time']:.2f}s)"
        for lv in solver.levels), flush=True)
    check_against_jax("fmg N=96 Re=100", solver, JAX_FMG96, ladder)


def flagship_vmg() -> int:
    """The converged VMG [192, 96] Re=1000 tol 1e-6 float32 solve."""
    card = phase_device()
    solver = vmg.VMGSolver(params=vmg_params(192, 1000.0, tolerance=1e-6,
                                             chunk_size=2000))
    sgk.reset_counts()
    solver.solve()
    torch.cuda.synchronize()
    m = solver.metrics
    errs = solver.compute_validation_errors(base_dir=ROOT, save_plots=False)
    ghia = ghia_u_error(solver)
    cycles, l2u, l2v = JAX_VMG192
    print(f"[flagship vmg] {card}; ladder {solver.ladder}, Re=1000 tol 1e-6 "
          f"float32: {m.iterations} V-cycles ({m.iterations / cycles:.3f} x "
          f"the JAX record {cycles}), converged={m.converged}, wall "
          f"{m.wall_time_seconds:.3f}s (first chunk "
          f"{solver.first_chunk_time:.3f}s), {m.iterations / m.wall_time_seconds:.1f} "
          f"cycles/s; L2 " + " ".join(f"{k}={v:.5f}" for k, v in errs.items())
          + f" (JAX u {l2u} v {l2v}); Ghia u-centerline max err {ghia:.4f}; "
          f"launches {sgk.LAUNCHES}, plain calls {sgk.PLAIN_CALLS}",
          flush=True)
    check(m.converged, "the VMG flagship did not converge")
    return 0


# the main paths: (name, phase, kernel family)
MAIN_PATHS = (
    ("sg N=128", phase_sg, sgk),
    ("fsg N=96", phase_fsg, sgk),
    ("fv Re=100", lambda: phase_fv_solve(100.0), fvk),
    ("fv Re=1000", lambda: phase_fv_solve(1000.0), fvk),
    ("vmg [192, 96]", phase_vmg_wide, sgk),
    ("vmg N=48", phase_vmg48, sgk),
    ("fmg N=96", phase_fmg96, sgk),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--flagship-vmg", action="store_true",
                    help="run only the converged VMG [192, 96] Re=1000 solve")
    if ap.parse_args().flagship_vmg:
        return flagship_vmg()
    t_start = time.time()
    names = sgk.KERNELS + fvk.KERNELS
    summary = {k: {"name": k, "route": "cuda",
                   "source": f"anap3_tpu_torch/csrc/{k}.cu",
                   "replaces": REPLACES[k], "launches": 0} for k in names}
    phase_device()
    phase_kernels(summary)
    phase_fv_kernels(summary)
    phase_fv_flags()
    phase_smoother()
    for path, phase, family in MAIN_PATHS:
        sgk.reset_counts()  # the path starts here
        fvk.reset_counts()
        t0 = time.time()
        out = phase()
        torch.cuda.synchronize()
        launches = {**sgk.LAUNCHES, **fvk.LAUNCHES}
        plain = {**sgk.PLAIN_CALLS, **fvk.PLAIN_CALLS}
        print(f"[main path] {path} ({time.time() - t0:.1f}s): kernel launches "
              f"{launches}; plain calls {plain}", flush=True)
        for k in family.KERNELS:
            check(launches[k] > 0, f"kernel {k} was not launched on {path}")
        check(not any(plain.values()), f"plain versions ran on {path}: {plain}")
        for k in names:
            summary[k]["launches"] += launches[k]
        if phase is phase_vmg_wide:
            profile_vmg_chunk(out)
    kernels = [{key: summary[k][key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for k in names]
    print(f"[chip_smoke] {time.time() - t_start:.1f}s", flush=True)
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
