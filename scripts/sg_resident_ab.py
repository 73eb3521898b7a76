#!/usr/bin/env python3
"""Time the SG chunk step of the resident kernel against the multi-launch
chunk on one CUDA card, at the orders of the benchmark's SG cells.

    python3 scripts/sg_resident_ab.py [--steps 2000]

Run from the root of a checkout. The first line is the card's name and
power limit; then one JSON line per shape, also appended to
chiprun_out/sg_resident_ab.jsonl:

- ``multi_ms``: ms per step of a chunk through ``sg_lanes_chunk_run`` (the
  multi-launch chunk: dt once, four stage launches and one control or tail
  launch a step), CUDA events over the whole chunk;
- ``resident_ms``: the same chunk through ``sg_resident_chunk_run`` (one
  launch; ``cluster`` blocks a lane, ``sub`` sub-blocks a block, ``smem``
  bytes a block), and ``same``: whether its state, rows, flags and
  residual normalization equal the multi-launch chunk's bit for bit.

Shapes: N = 20 with 8 lanes and N = 24 with one (quadratures every step,
the tiled lane kernel's cadence), N = 40 with 8 lanes, N = 48 and 64 with
one (every 16th step), float32, from a developing flow (200 steps from
rest), chunks of ``--steps`` steps with nothing converging. N = 64 is past
the resident geometry: only its multi-launch time is printed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (Re, lid velocity, corner smoothing, CFL) of the lanes
LANES = [(1000.0, 1.0, 0.15, 1.5), (400.0, 1.0, 0.15, 1.5),
         (1000.0, 0.75, 0.10, 1.2), (100.0, 1.25, 0.05, 1.5),
         (1000.0, 1.0, 0.12, 1.5), (3200.0, 1.0, 0.12, 1.0),
         (250.0, 0.5, 0.08, 1.5), (1000.0, 1.5, 0.01, 0.8)]
SHAPES = ((20, 8, 1), (24, 1, 1), (40, 8, 16), (48, 1, 16), (64, 1, 16))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    args = ap.parse_args(argv)

    import torch

    from anap3_tpu_torch.models import spectral_sg as T
    from anap3_tpu_torch.models.params import SpectralParameters
    from anap3_tpu_torch.models.runner import fresh_carry
    from anap3_tpu_torch.ops import _build
    from anap3_tpu_torch.ops import sg_kernels as sgk
    from anap3_tpu_torch.ops import sg_lane_kernels as sgl
    from anap3_tpu_torch.parallel.sweep import stack_states

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    lib = _build.load_library("sg")

    def run(ops, st, chunk, every, geo):
        """A chunk's workspace after it, and its ms per step."""
        B, o0 = len(ops), ops[0]
        carry = fresh_carry(B, o0.dtype, o0.device)
        ws = sgk._workspace(
            o0, lanes=B, **sgl._lane_statics(ops), u=st.u.clone(),
            v=st.v.clone(), p=st.p.clone(), bu=torch.empty_like(st.u),
            bv=torch.empty_like(st.v), bp=torch.empty_like(st.p),
            rows=torch.empty((chunk, B, 7), dtype=o0.dtype,
                             device=o0.device),
            flags=carry.flags.clone(), ref_norm=carry.ref_norm.clone())
        counts = sgk._new_counts()
        common = (chunk, 200, 10, every, 0, 1e-30)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        if geo is None:
            rc = lib.sg_lanes_chunk_run(
                0, o0.nf, sgk._geo(o0, B), B, sgk._ptr_table(ws), *common, 0,
                sgk._tail_blocks(o0, B, lib), counts, sgk._stream())
            sgk._raise_on(lib, rc, "sg_lanes_chunk_run")
        else:
            sgk._run_resident(o0, B, ws, *common, {"sg_resident": 0},
                              "sg_resident")
        stop.record()
        stop.synchronize()
        return ws, start.elapsed_time(stop) / chunk

    def same(a, b):
        def bits(t):
            return t.view(torch.int32) if t.dtype == torch.float32 else t
        return all(torch.equal(bits(a[k]), bits(b[k]))
                   for k in ("u", "v", "p", "rows", "flags", "ref_norm"))

    out = ROOT / "chiprun_out" / "sg_resident_ab.jsonl"
    out.parent.mkdir(exist_ok=True)
    for n, B, every in SHAPES:
        ops = [T.build_spectral_ops(SpectralParameters(
            Re=Re, lid_velocity=lid, nx=n, ny=n, device="cuda",
            corner_smoothing=cs, CFL=cfl, dtype="float32"))[0]
            for Re, lid, cs, cfl in LANES[:B]]
        st = stack_states([T.initial_state(o) for o in ops])
        dev, _ = run(ops, st, 200, every, None)
        st = T.SpectralState(dev["u"], dev["v"], dev["p"])
        run(ops, st, 64, every, None)  # warm
        want, multi = run(ops, st, args.steps, every, None)
        line = {"n": n, "lanes": B, "metrics_every": every,
                "steps": args.steps, "multi_ms": round(multi, 5)}
        g = sgk.resident_geometry(n + 1, torch.float32, B)
        if g is not None:
            run(ops, st, 64, every, g)
            got, ms = run(ops, st, args.steps, every, g)
            shape = (ctypes.c_int * 3)()  # cluster, sub-blocks, smem
            sgk._raise_on(lib, lib.sg_resident_geometry(
                0, n + 1, sgk._geo(ops[0], B), shape), "sg_resident_geometry")
            line.update(resident_ms=round(ms, 5), same=same(got, want),
                        cluster=shape[0], sub=shape[1], smem=shape[2])
        print(json.dumps(line), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
