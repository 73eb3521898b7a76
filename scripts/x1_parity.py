#!/usr/bin/env python3
"""Where the x1 stage kernel (matmul_algorithm=x1) parts from its plain
version on one CUDA card, and why.

    python3 scripts/x1_parity.py [--n 32 96 128 256 320] [--drift-steps 2000]

x1 rounds every stage state to bfloat16 before its products. Two float32
implementations of the same x1 arithmetic that sum in different orders
therefore part by more than their sums do: where an element's two float32
values lie on either side of a bf16 rounding boundary, the next stage
rounds them 2^-8 apart, and the operators carry that into a line of the
residual. This script separates that from a fault of the kernel. For each
order N and lid (float32, Re=1000, the seeded random states of
chip_smoke.py phase 2g) it prints one JSON line with:

- ``stage``: every stage of 16 steps along the KERNEL's own trajectory
  (the bench entry's stage launch, chained with dt_kernel's dt and each
  stage's alpha * dt), each against the plain x1 stage from the same
  inputs (so every bf16 rounding of the state is the same on both sides):
  the largest relative distance over u, v, p, per stage index, for the
  kernel and for three other sum orders of the same arithmetic:
  ``f64`` (products summed in float64), ``mma_rn`` (the kernel's order:
  16-wide k blocks, each block summed exactly and added to the float32
  accumulator rounded to nearest, the border term fused) and ``tc`` (the
  same, rounded toward zero: ``sg_kernels.tc_matmul``, the plain x1 with
  ``x1_operators(ops, tc=True)``); and ``kernel_vs_tc``, the kernel
  against the tc stage from the same inputs;
- ``chain_equals_chunk``: whether that chain's state after 16 steps is
  bit-equal to the kernel's 16-step chunk from the same state;
- ``steps``: the 16 steps one by one along the plain trajectory (as
  phase 2g), for the kernel and the three other orders, each against the
  plain step: the largest distance, and the number of state elements
  whose bf16 rounding differs from the plain stage chain's at stages 1-3
  of the step (``flips``); the distance of the steps with no flip; and
  the kernel against the tc step (``kernel_vs_tc``);
- ``chunk``: the 16-step chunk from rest and from the seeded state, the
  kernel and the other orders against the plain chunk (state only), and
  the kernel against the tc chunk;
- ``tail``: one launch of the x1 tail kernel (its quadratures) against
  ``x1_conserved_quantities`` and against the exact quadratures.

Then ``drift``: N=128 Re=1000 float32 from rest for ``--drift-steps``
steps, the x1 kernel chunk, the exact kernel chunk, the plain x1 chunk and
the plain x1 with the tc order, with the relative distances between
them at a few steps: whether the x1 state's distance from the exact one
belongs to the x1 arithmetic or to the kernel.

The last line repeats the card's name and power limit. The output also
goes to chiprun_out/x1_parity.jsonl.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from anap3_tpu_torch.models import spectral_sg as core  # noqa: E402
from anap3_tpu_torch.models.params import SpectralParameters  # noqa: E402
from anap3_tpu_torch.ops import sg_kernels as sgk  # noqa: E402

OUT = REPO / "chiprun_out" / "x1_parity.jsonl"
ORDERS = ("f64", "mma_rn", "tc")


def params(n, corner="smoothing", device="cuda"):
    return SpectralParameters(
        Re=1000.0, nx=n, ny=n, basis_type="chebyshev", CFL=1.5,
        beta_squared=5.0, corner_treatment=corner, corner_smoothing=0.15,
        dtype="float32", device=device, chunk_size=5000,
        convergence_metric="auto")


def random_state(ops, rng):
    nf = ops.nf
    u = 0.05 * rng.standard_normal((nf, nf))
    v = 0.05 * rng.standard_normal((nf, nf))
    p = 0.05 * rng.standard_normal((nf - 2, nf - 2))
    st = core.state_from_numpy((u, v, p), ops.device, ops.dtype)
    uu, vv = core.enforce_bc(ops, st.u, st.v)
    return core.SpectralState(uu.contiguous(), vv.contiguous(), st.p)


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def state_rel(a, b):
    return max(rel(x, y) for x, y in zip(a, b))


# ---- x1 products in other sum orders

def mm_order(order):
    """a @ b of float32 operands holding bf16 values, in ``order`` (f64 or
    mma_rn; sg_kernels.tc_matmul is mma_rn rounded toward zero)."""
    if order == "f64":
        return lambda a, b: (a.double() @ b.double()).float()

    def mm(a, b):
        k = a.shape[-1]
        kb = (k + 15) // 16
        pad = kb * 16 - k
        a64 = torch.nn.functional.pad(a.double(), (0, pad))
        b64 = torch.nn.functional.pad(b.double(), (0, 0, 0, pad))
        blocks = torch.einsum("mbk,bkn->bmn", a64.reshape(-1, kb, 16),
                              b64.reshape(kb, 16, -1))
        acc = torch.zeros(blocks.shape[1:], dtype=torch.float32,
                          device=a.device)
        for blk in blocks:  # exact block sums, one rounding a block
            acc = (acc.double() + blk).float()
        return acc

    return mm


def _left(mm, fused, hi_op, op, w, exact_col):
    n = w.shape[0] - 1
    core_part = mm(hi_op, sgk.bf16_round(w[:n]))
    if fused:  # the border term as one fused multiply-add
        out = (core_part.double() + op[:, n:].double() @ w[n:].double()).float()
    else:
        out = core_part + op[:, n:] @ w[n:]
    if exact_col:
        out[:, n] = (op.double() @ w[:, n].double()).to(out.dtype)
    else:
        out[n, n] = mm(op[n:n + 1], w[:, n:n + 1])[0, 0]
    return out


def _right(mm, fused, w, hi_opT, opT, exact_row):
    n = w.shape[1] - 1
    core_part = mm(sgk.bf16_round(w[:, :n]), hi_opT)
    if fused:
        out = (core_part.double() + w[:, n:].double() @ opT[n:].double()).float()
    else:
        out = core_part + w[:, n:] @ opT[n:]
    if exact_row:
        out[n] = (w[n].double() @ opT.double()).to(out.dtype)
    else:
        out[n, n] = mm(w[n:n + 1], opT[:, n:n + 1])[0, 0]
    return out


def residuals_order(ops, hi, order, u, v, p):
    """sgk.x1_residuals with its products summed in ``order``."""
    mm = mm_order(order)
    fused = order != "f64"
    L = lambda h, o, w: _left(mm, fused, h, o, w, True)  # noqa: E731
    R = lambda w, h, o: _right(mm, fused, w, h, o, True)  # noqa: E731
    du_dx, dv_dx = L(hi.Dx, ops.Dx, u), L(hi.Dx, ops.Dx, v)
    du_dy, dv_dy = R(u, hi.DyT, ops.DyT), R(v, hi.DyT, ops.DyT)
    lap_u = L(hi.Dxx, ops.Dxx, u) + R(u, hi.DyyT, ops.DyyT)
    lap_v = L(hi.Dxx, ops.Dxx, v) + R(v, hi.DyyT, ops.DyyT)
    p_h = sgk.bf16_round(p)
    a5, a6 = mm(hi.Gx, p_h), mm(hi.Ix, p_h)
    dp_dx = mm(sgk.bf16_round(a5), hi.IyT)
    dp_dy = mm(sgk.bf16_round(a6), hi.GyT)
    n = ops.nf - 1
    dp_dx[n, n] = a5[n] @ ops.IyT[:, n]
    dp_dy[n, n] = a6[n] @ ops.GyT[:, n]
    if ops.singular:
        U, V = u + ops.sing_u, v + ops.sing_v
        conv_u = U * (du_dx + ops.sing_dudx) + V * (du_dy + ops.sing_dudy)
        conv_v = U * (dv_dx + ops.sing_dvdx) + V * (dv_dy + ops.sing_dvdy)
    else:
        conv_u = u * du_dx + v * du_dy
        conv_v = u * dv_dx + v * dv_dy
    R_u = -conv_u - dp_dx + ops.nu * lap_u
    R_v = -conv_v - dp_dy + ops.nu * lap_v
    R_p = -ops.beta_sq * (du_dx + dv_dy)[1:-1, 1:-1]
    return R_u, R_v, R_p


def stage(ops, hi, order, st_in, base, adt):
    """One x1 stage of the plain version (order "plain"), its tc order, or
    another sum order."""
    if order in ("plain", "tc"):
        h = hi._replace(tc=order == "tc")
        return sgk.stage_x1_plain(ops, h, *st_in, *base, adt)[0]
    R_u, R_v, R_p = residuals_order(ops, hi, order, *st_in)
    u, v = core.enforce_bc(ops, base.u + adt * R_u, base.v + adt * R_v)
    return core.SpectralState(u, v, base.p + adt * R_p)


def adts(dt):
    return [torch.tensor(a, dtype=torch.float32, device=dt.device) * dt
            for a in core.RK4_ALPHAS]


def plain_chain(ops, hi, order, base):
    """The four stage states of one step of ``order`` from ``base``."""
    dt = core.adaptive_dt(ops, base.u, base.v)
    out, cur = [], base
    for adt in adts(dt):
        cur = stage(ops, hi, order, cur, base, adt)
        out.append(cur)
    return out, dt


def flips(a, b):
    """Elements whose bf16 roundings differ between two states."""
    return sum(int((sgk.bf16_round(x) != sgk.bf16_round(y)).sum())
               for x, y in zip(a, b))


def kernel_chain(ops, base):
    """The kernel's four stage states of one step from ``base``."""
    return sgk.x1_step_stages(ops, base)[1]


def case(n, corner, rng):
    ops, _ = core.build_spectral_ops(params(n, corner))
    hi = sgk.x1_operators(ops)
    st = random_state(ops, rng)
    random_state(ops, rng)  # phase 2g's base: the same draws
    res = {"n": n, "corner": corner}

    # every stage of 16 steps along the kernel's trajectory
    worst = {k: [0.0] * 4 for k in ("kernel", "kernel_vs_tc") + ORDERS}
    cur = st
    for _ in range(16):
        ins, outs, step_adts = sgk.x1_step_stages(ops, cur)
        for s, (x, out_k, adt) in enumerate(zip(ins, outs, step_adts)):
            ref = stage(ops, hi, "plain", x, cur, adt)
            worst["kernel"][s] = max(worst["kernel"][s], state_rel(out_k, ref))
            for order in ORDERS:
                o = stage(ops, hi, order, x, cur, adt)
                worst[order][s] = max(worst[order][s], state_rel(o, ref))
                if order == "tc":
                    worst["kernel_vs_tc"][s] = max(worst["kernel_vs_tc"][s],
                                                   state_rel(out_k, o))
        cur = outs[-1]
    res["stage"] = worst
    run16 = sgk.make_sg_chunk_runner(ops, 16, 1e-30, 10, "rel_iter", 16,
                                     x1=True)
    ck = run16(st, 0, float("inf"))[0]
    res["chain_equals_chunk"] = all(bool(torch.equal(a, b))
                                    for a, b in zip(ck, cur))

    # the 16 steps one by one along the plain trajectory
    steps = {k: {"worst": 0.0, "flips": 0, "worst_no_flip": 0.0,
                 "steps_with_flips": 0} for k in ("kernel",) + ORDERS}
    steps["kernel_vs_tc"] = 0.0
    cur = st
    for _ in range(16):
        pc, _ = plain_chain(ops, hi, "plain", cur)
        chains = {"kernel": kernel_chain(ops, cur)}
        for order in ORDERS:
            chains[order] = plain_chain(ops, hi, order, cur)[0]
        for k, ch in chains.items():
            e = state_rel(ch[-1], pc[-1])
            f = sum(flips(ch[s], pc[s]) for s in range(3))
            d = steps[k]
            d["worst"] = max(d["worst"], e)
            d["flips"] += f
            d["steps_with_flips"] += int(f > 0)
            if f == 0:
                d["worst_no_flip"] = max(d["worst_no_flip"], e)
        steps["kernel_vs_tc"] = max(steps["kernel_vs_tc"], state_rel(
            chains["kernel"][-1], chains["tc"][-1]))
        cur = pc[-1]
    res["steps"] = steps

    # the 16-step chunk
    chunk = {}
    for name, s0 in (("rest", core.initial_state(ops)), ("seeded", st)):
        outs = {}
        for order in ("plain",) + ORDERS:
            o = s0
            for _ in range(16):
                o = plain_chain(ops, hi, order, o)[0][-1]
            outs[order] = o
        ck = run16(s0, 0, float("inf"))[0]
        row = {"kernel": state_rel(ck, outs["plain"]),
               "kernel_vs_tc": state_rel(ck, outs["tc"])}
        row.update({o: state_rel(outs[o], outs["plain"]) for o in ORDERS})
        chunk[name] = row
    res["chunk"] = chunk

    # one launch of the x1 tail's quadratures
    ws = sgk.chunk_workspace(ops, st, 16, float("inf"))
    ws["x1b"] = sgk.x1_border_table(ops)
    sgk.bench_kernel(ops, ws, "tail", 1, x1=True)
    got = ws["scal"][0, 3:6].double()
    want = torch.stack(sgk.x1_conserved_quantities(ops, hi, st.u, st.v))
    exact = torch.stack(core.conserved_quantities(ops, st.u, st.v))
    res["tail"] = {
        "kernel_vs_plain": [rel(got[i], want[i]) for i in range(3)],
        "plain_vs_exact": [rel(want[i], exact[i]) for i in range(3)]}
    for x1 in (True, False):  # ms a tail launch, CUDA events, 200 launches
        sgk.bench_kernel(ops, ws, "tail", 1, x1=x1)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        sgk.bench_kernel(ops, ws, "tail", 200, x1=x1)
        ev[1].record()
        ev[1].synchronize()
        res["tail"]["ms_x1" if x1 else "ms_exact"] = \
            ev[0].elapsed_time(ev[1]) / 200
    return res


def drift(steps, chunk=250):
    ops, _ = core.build_spectral_ops(params(128, "smoothing"))
    hi = sgk.x1_operators(ops)
    st0 = core.initial_state(ops)
    inf = float("inf")
    runs = {x1: sgk.make_sg_chunk_runner(ops, chunk, 1e-30, 10, "rel_iter",
                                         16, x1=x1) for x1 in (True, False)}
    s = {"x1_kernel": st0, "exact_kernel": st0, "x1_plain": st0,
         "x1_tc": st0}
    rows = []
    t0 = time.time()
    for it in range(0, steps, chunk):
        s["x1_kernel"] = runs[True](s["x1_kernel"], it, inf)[0]
        s["exact_kernel"] = runs[False](s["exact_kernel"], it, inf)[0]
        s["x1_plain"] = sgk.chunk_plain(ops, s["x1_plain"], it, inf, chunk,
                                        1e-30, 10, False, 16, hi=hi)[0]
        o = s["x1_tc"]
        for _ in range(chunk):
            o = plain_chain(ops, hi, "tc", o)[0][-1]
        s["x1_tc"] = o
        k = it + chunk
        if k % 1000 == 0 or k == steps:
            pairs = [("x1_kernel", "exact_kernel"),
                     ("x1_plain", "exact_kernel"),
                     ("x1_tc", "exact_kernel"),
                     ("x1_kernel", "x1_plain"), ("x1_tc", "x1_plain"),
                     ("x1_kernel", "x1_tc")]
            rows.append({"step": k, **{f"{a} vs {b}": state_rel(s[a], s[b])
                                       for a, b in pairs}})
            print(json.dumps({"drift": rows[-1],
                              "seconds": round(time.time() - t0, 1)}),
                  flush=True)
    return rows


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+",
                    default=[32, 96, 128, 256, 320])
    ap.add_argument("--drift-steps", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("x1_parity.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.parent.mkdir(exist_ok=True)
    name = card()
    print(name, flush=True)
    rng = np.random.default_rng(15)
    with OUT.open("a") as fh:
        for n in args.n:
            for corner in ("smoothing", "singular"):
                res = case(n, corner, rng)
                res["card"] = name
                line = json.dumps(res)
                print(line, flush=True)
                fh.write(line + "\n")
        if args.drift_steps:
            rows = drift(args.drift_steps)
            fh.write(json.dumps({"drift": rows, "card": name}) + "\n")
    print(name, flush=True)


if __name__ == "__main__":
    main()
