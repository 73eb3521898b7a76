"""One run of one cell: load, warm up, measure for ``--seconds``, judge,
print one JSON line.

    python3 -m ldc_bench --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start) imports the
program, builds the cell's kernels where the checkout has none yet, and
runs the cell's job once with every level capped at a few steps,
validating its first lane (what the validation loads on its first call,
such as the stored truths and scipy's interpolation, is the same for
every lane). The window then runs the cell's jobs back to back (a closed loop:
one researcher's solves, or one optimizer's rounds), each built from the
configuration, solved from rest and validated, and starts a job only
while the last job's wall still fits before ``--seconds``. With
``--trace 1`` one more job runs after the window, every level capped at
the mix's ``trace_steps``, traced whole (``trace.py``); it is not judged.
Once the window has closed and the device's memory peak is read, the
plain reference judges every lane's answer (``judge.py``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

from . import judge, spec, traffic as gen

FORBIDDEN = ("jax", "jaxlib", "flax", "anap3_tpu")
WARM_STEPS = 64


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    ticks = os.sysconf("SC_CLK_TCK")
    start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                .split()[19])
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return max(0.0, uptime - start / ticks)


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    JAX's, flax's or the JAX package's, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def _device_info(device: str, peak: int) -> dict:
    if device.startswith("cuda"):
        import torch

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = spec.ROOT) -> dict:
    """Run one cell once and return the result line's object."""
    import torch

    from . import drive

    bench = spec.benchmark(root)
    cell = spec.cell(bench, workload)
    config = spec.config(bench, cell["config"], root)
    mix = spec.traffic(cell["traffic"], root)
    limits = spec.limits(workload, root)
    wanted = spec.metrics(bench, workload, trace)
    readers = {m["name"]: spec.reader(m["name"], root) for m in wanted}
    kind = mix["kind"]
    cuda = device.startswith("cuda")
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)

    t_imports = process_age()
    prog = drive.program()
    t_program = process_age()
    # the cell's own shapes once: its job with every level capped at
    # WARM_STEPS steps (one short chunk at each order), one lane validated
    drive.run_job(prog, config, kind,
                  [dict(lane, max_iterations=WARM_STEPS)
                   for lane in gen.lane_params(config, mix)],
                  device, root, validate=1)
    sync()
    drive.reset_launches(prog)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age()

    jobs, k = [], 0
    t0 = time.perf_counter()
    while not jobs or (time.perf_counter() - t0) + jobs[-1].wall_s <= seconds:
        jobs.append(drive.run_job(prog, config, kind,
                                  gen.job(config, mix, seed, k), device, root))
        k += 1
    window_s = time.perf_counter() - t0
    launches = drive.launches(prog)

    phases = {"setup_s": setup_s, "torch_imported_s": t_imports,
              "program_imported_s": t_program, "window_s": window_s,
              "jobs": len(jobs)}
    traced = None
    if trace:
        from . import trace as tr

        cap = int(mix["trace_steps"])
        t1 = time.perf_counter()
        job, dev = tr.traced(
            lambda span: drive.run_job(
                prog, config, kind,
                [dict(lane, max_iterations=cap)
                 for lane in gen.job(config, mix, seed, k)],
                device, root, span))
        traced = dict(dev, job=job)
        phases["traced_job_and_read_s"] = time.perf_counter() - t1
        phases["trace_read_s"] = dev["read_s"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t2 = time.perf_counter()
    judged = [judge.lane_numbers(root, config, lane)
              for j in jobs for lane in j.lanes]
    correct, failed, checks = judge.verdict(judged, limits)
    phases["judge_s"] = time.perf_counter() - t2
    print("phases: " + json.dumps(phases), file=sys.stderr)
    ctx = {"kind": kind, "config": config, "jobs": jobs,
           "window_s": window_s, "setup_s": setup_s, "launches": launches,
           "trace": traced}
    metrics = {}
    for m in wanted:
        value = readers[m["name"]](ctx, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = _device_info(device, peak)
    out = {"correct": correct, "attempted": len(judged), "failed": failed,
           "metrics": metrics, "device": device_info}
    if traced:
        device_info.update(busy_s=traced["busy_s"],
                           window_s=traced["window_s"])
        out["breakdown"] = {"device_ops": traced["device_ops"],
                            "idle_gaps": traced["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ldc_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = spec.cell(spec.benchmark(), args.workload)
    except (OSError, spec.SpecError) as exc:
        print(f"ldc_bench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"ldc_bench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules(sys.modules)
    if found:
        print(f"ldc_bench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
