#!/usr/bin/env python3
"""Sweep the SG stage kernel's launch geometries on one CUDA card.

    python3 scripts/sg_stage_tune.py

At each main-path shape (float32: N = 20 B=8, 48, 96, 128, 128 B=8, 192;
float64: N = 96, 128) it times one last-stage launch of the stage kernel
(the library's bench entry, CUDA events over 100 launches, from a
developing flow) under every geometry ``ops/sg_kernels.stage_geometry``
accepts with its overrides: column tile, k groups (1, 2, 4, 8), and the
operand staging (every band whole, or rings of 32- and 16-wide slabs). Each variant's output state is held against the default
geometry's (relative 1e-5 in float32, 1e-12 in float64), so a variant
that computes wrongly fails the run. Prints the card's name and power
limit, then one JSON line per shape with every variant's time, fastest
first, and for the default geometry the host's enqueue time per launch
(host clock around 100 launches, no synchronize) and the device time per
launch from torch.profiler; the lines are also appended to
chiprun_out/sg_stage_tune.jsonl.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from anap3_tpu_torch.models import spectral_sg as core  # noqa: E402
from anap3_tpu_torch.models.params import SpectralParameters  # noqa: E402
from anap3_tpu_torch.ops import sg_kernels as sgk  # noqa: E402
from anap3_tpu_torch.ops import sg_lane_kernels as sgl  # noqa: E402
from anap3_tpu_torch.parallel.sweep import stack_states  # noqa: E402

sys.path.insert(0, str(ROOT / "scripts"))
from sg_stage_ab import LANES, cuda_ms  # noqa: E402

SHAPES = [(20, 8, torch.float32), (48, 1, torch.float32),
          (96, 1, torch.float32), (128, 1, torch.float32),
          (128, 8, torch.float32), (192, 1, torch.float32),
          (96, 1, torch.float64), (128, 1, torch.float64)]


def variants(nf, dtype):
    """Every geometry the overrides give that the kernel takes."""
    out = []
    for tn, ksplit, (ks, depth) in itertools.product(
            (16, 32, 48), (1, 2, 4, 8),
            ((nf, 1), (32, 3), (32, 2), (16, 2))):
        try:
            g = sgk.stage_geometry(nf, dtype, 1, tn, ksplit, ks, depth)
        except ValueError:
            continue
        if g.threads <= 1024 and g not in out:
            out.append(g)
    return out


def sweep(n, B, dtype):
    name = "float64" if dtype == torch.float64 else "float32"
    ops = [core.build_spectral_ops(SpectralParameters(
        Re=Re, nx=n, ny=n, basis_type="chebyshev", CFL=cfl,
        beta_squared=beta, corner_treatment="smoothing",
        corner_smoothing=cs, dtype=name, device="cuda"))[0]
        for Re, cs, cfl, beta in LANES[:B]]
    o0 = ops[0]
    st = sgl.make_lane_chunk_runner(ops, 50, 1e-30)(
        stack_states([core.initial_state(o) for o in ops]), 0)[0]
    kw = dict(dtype=o0.dtype, device=o0.device)
    ws = sgk._workspace(
        o0, lanes=B, **sgl._lane_statics(ops),
        u=st.u.clone(), v=st.v.clone(), p=st.p.clone(),
        bu=torch.empty_like(st.u), bv=torch.empty_like(st.v),
        bp=torch.empty_like(st.p), rows=torch.empty((16, B, 7), **kw),
        flags=torch.zeros((B, 3), dtype=torch.int32, device=o0.device),
        ref_norm=torch.full((B,), float("inf"), **kw))
    for dst, src in (("au", st.u), ("av", st.v), ("ap", st.p)):
        ws[dst].copy_(src)
    sgk.bench_kernel(o0, ws, "dt", 1, B)  # dt of this state
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    ref, rows = None, []
    for g in [sgk.stage_geometry(o0.nf, dtype, B)] + variants(o0.nf,
                                                               dtype):
        ws["part"] = torch.empty((B, g.nparts, 5), **kw)
        sgk.bench_kernel(o0, ws, "sg_stage", 1, B, geometry=g)
        out = torch.cat([ws[k].flatten() for k in ("bu", "bv", "bp")])
        if ref is None:
            ref = out.clone()
            continue
        err = float((out - ref).abs().max() / ref.abs().max())
        if not err <= tol:
            raise SystemExit(f"N={n} B={B} {name} {g}: error {err:.3e}")
        ms = cuda_ms(torch, lambda: sgk.bench_kernel(
            o0, ws, "sg_stage", 100, B, geometry=g), 1) / 100
        rows.append(dict(ms=ms, tn=g.tn, ksplit=g.ksplit, ks=g.ks,
                         depth=g.depth, smem=g.smem, threads=g.threads))
    rows.sort(key=lambda r: r["ms"])
    default = sgk.stage_geometry(o0.nf, dtype, B)
    ws["part"] = torch.empty((B, default.nparts, 5), **kw)
    return dict(shape=f"N={n} B={B} {name}", default=dict(
        tn=default.tn, ksplit=default.ksplit, ks=default.ks,
        depth=default.depth), **launch_costs(o0, ws, B), variants=rows)


def launch_costs(o0, ws, B, reps=100):
    """Host enqueue and device time per launch of the default geometry."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sgk.bench_kernel(o0, ws, "sg_stage", reps, B)
    enqueue = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sgk.bench_kernel(o0, ws, "sg_stage", reps, B)
        torch.cuda.synchronize()
    dev = [e.time_range.elapsed_us() for e in prof.events()
           if "stage_kernel" in e.name
           and str(getattr(e, "device_type", "")).endswith("CUDA")]
    return dict(enqueue_ms=enqueue, device_ms=(
        sum(dev) / len(dev) / 1e3 if dev else None), device_events=len(dev))


def main() -> int:
    if not torch.cuda.is_available():
        print("sg_stage_tune: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log = ROOT / "chiprun_out"
    log.mkdir(exist_ok=True)
    for n, B, dtype in SHAPES:
        line = json.dumps(dict(sweep(n, B, dtype), card=card))
        print(line, flush=True)
        with open(log / "sg_stage_tune.jsonl", "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
