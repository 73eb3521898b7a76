"""The readings that the limits of ``limits/<cell>.json`` are set from:
for each seed, job 0 of the cell through the program (the sound reading),
and the controls put in the program's place:

- ``bf16``: the answer as a bfloat16 computation would hold it at best:
  the program's final state rounded to bfloat16, and its validation
  numbers worked out by the reference from that state and rounded to
  bfloat16;
- ``x1`` (``--x1``, SG and FSG cells): the program's own lower-precision
  path, ``matmul_algorithm=x1`` (one bfloat16 tensor-core pass a product
  in the SG chunks), each level capped at ``--x1-cap`` steps; the other
  solvers refuse it.

    python3 -m ldc_bench.control --workload <cell> --seeds 1 2 3 [--x1]

Not run by the benchmark's runs; it prints one JSON line a reading and
writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import drive, judge, spec, traffic as gen
from .reference import validation as ref_val


def bf16_answer(root: Path, config: dict, lane):
    """(state, reported validation) of the bfloat16 control."""
    state = tuple(drive.bf16(a) for a in lane.state)
    p = lane.params
    ref = spec.reference(config["reference"], root)
    worked = ref_val.l2_errors(root, p, ref.lane_evaluator(p, lane.n, state))
    return state, {k: float(drive.bf16(np.float32(v))) for k, v in
                   worked.items()}


def readings(workload: str, seeds, x1: bool, x1_cap: int, device: str,
             root: Path = spec.ROOT, emit=print) -> list:
    bench = spec.benchmark(root)
    cell = spec.cell(bench, workload)
    config = spec.config(bench, cell["config"], root)
    mix = spec.traffic(cell["traffic"], root)
    prog = drive.program()
    out = []
    for seed in seeds:
        lanes = gen.job(config, mix, seed, 0)
        variants = [("program", lanes)]
        if x1:
            variants.append(("x1", [dict(l, matmul_algorithm="x1",
                                         max_iterations=x1_cap)
                                    for l in lanes]))
        for name, job_lanes in variants:
            t0 = time.perf_counter()
            job = drive.run_job(prog, config, mix["kind"], job_lanes, device,
                                root)
            wall = time.perf_counter() - t0
            for b, lane in enumerate(job.lanes):
                rows = [(name, judge.lane_numbers(root, config, lane))]
                if name == "program":
                    st, rep = bf16_answer(root, config, lane)
                    rows.append(("bf16", judge.lane_numbers(
                        root, config, lane, state=st, reported=rep)))
                for what, nums in rows:
                    row = {"workload": workload, "seed": seed, "lane": b,
                           "what": what, "iterations": lane.iterations,
                           "levels": lane.levels,
                           "converged": lane.converged, "wall_s": wall,
                           "params": {k: lane.params[k] for k in
                                      ("Re", "lid_velocity",
                                       "corner_smoothing")
                                      if k in lane.params},
                           "numbers": nums}
                    out.append(row)
                    emit(json.dumps(row))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ldc_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--x1", action="store_true")
    ap.add_argument("--x1-cap", type=int, default=400_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    rows = readings(args.workload, args.seeds, args.x1, args.x1_cap, "cuda",
                    emit=lambda s: print(s, flush=True))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
