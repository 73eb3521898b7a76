"""How close the Schur BiCGSTAB comes to its extended-precision trajectory
in three float64 implementations, on one CUDA card.

Usage (from the repository root, on a machine with a card; ~3 min):

    python3 scripts/nk_accuracy.py

The systems are chip_smoke.py phase 2f's (``chip_smoke.nk_system``: the
Schur system of one preconditioner application at N = 12, 20, 96, 128, dt
0.05, 1 and 3e3, the sharp lid at Re=1000 and the smoothed one at Re=250).
Each is solved for 1, 8 and 16 iterations (no solve stops before 21) by

- the Schur kernel (``nk_kernels.schur_kernel``),
- the plain loop on the card (``schur_plain``: cuBLAS products),
- the plain loop on the CPU (the host BLAS's products, default threads),

and by the same loop in numpy ``longdouble`` (x86 extended precision, 64
mantissa bits) from the same float64 operands, the reference (computed in
WORKERS processes). Prints each implementation's relative
distance from the reference and, at budgets 8 and 16, the kernel's distance
from the card loop against phase 2f's bound (``max(NK_B8_TOL, NK_SPREAD x``
the CPU loop's distance), "MISS" where it is over), then for each budget
the geometric mean over the solves of each distance over the card loop's,
and how many solves are over phase 2f's bound. The budget-1 distance is the
rounding of two S-applies; later ones show how the iterations amplify it.

    python3 scripts/nk_accuracy.py --perturb

solves every system for its right-hand side and 8 seeded 1e-15
perturbations of it (``chip_smoke.perturbed``; ~6 min): how far a solve
lands from the reference, and how much of phase 2f's bound it uses, is a
chaotic function of the rounding, so one right-hand side is one draw.

    python3 scripts/nk_accuracy.py --variants

adds the kernel's other sum orders of the tile products
(``scripts/nk_schur_steps.sum_orders``: ``interleaved``, ``plain-sum`` and
``first``, the first design), each built from a patched copy of
``csrc/nk_schur.cu`` into ``build/nk_steps/<variant>/``.

    python3 scripts/nk_accuracy.py --system 256 smoothing 0.05

runs one system instead (any N; ~1 min of extended precision a solve at
N=256), with the plain loop on the CPU also in one thread (the yardstick of
``tests/test_torch_nk.py``, whose module runs torch in one thread) beside
the default threads (phase 2f's).

    python3 scripts/nk_accuracy.py --checkout build/parent --system ...

reads another checkout's kernel (its ``chip_smoke.py`` and
``anap3_tpu_torch``, built from its own sources) on the same systems.

    python3 scripts/nk_accuracy.py --gate 24 --variants

measures the distribution that phase 2f's budget-16 gate is set from,
without the extended-precision loop (~5 min): every phase 2f system
(N = 12-256) at budget 16 for its right-hand side and 23 perturbations
of it, each draw's distance from the card loop over its bound
(``chip_smoke.nk_b16_ratios``: the draw's own CPU loop in one thread, the
yardstick of phase 2f), for the kernel, its other sum orders
(``--variants``), two other sum orders of the plain loop (on the card
with each two-sided product associated the other way; on the CPU in the
host's threads) and the mutants of ``chip_smoke.nk_mutants``; then for
each the share of draws over the bound, the largest distance over it,
the most draws over it on one system, and ``chip_smoke.nk_gate``'s
verdict on phase 2f's draws (the first NK_PERTURB + 1 of each system).

    python3 scripts/nk_accuracy.py --compare OUT [OUT2]

needs no card: from this script's saved output (OUT, and OUT2 for another
checkout's run on the same solves), each implementation's distance from
the reference over the kernel's of OUT, solve by solve: the geometric mean
of the ratio and the t statistic of its logarithm (|t| > 2: told apart).
"""

import argparse
import multiprocessing
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BUDGETS = (1, 8, 16)
LD = np.longdouble
# processes for the reference loops: one fewer than the cores of an 8-core
# host, beside the main process
WORKERS = 7
OPERATORS = ("Gxr", "IyTr", "Ixr", "GyTr", "Vxi", "Vyi", "Vx", "Vy", "Dxi",
             "DyTi")
# chip_smoke and the port's nk_kernels, from the checkout being read
cs = nk = torch = None


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def reference(op, lam, idt, bsq, b):
    """x after each of BUDGETS iterations of the BiCGSTAB of
    ``nk_kernels.schur_bicgstab`` in longdouble, from float64 operands (op:
    OPERATORS by name, lam inv_hlam, b the right-hand side)."""
    op = {name: a.astype(LD) for name, a in op.items()}
    lam, idt, bsq, b = lam.astype(LD), LD(idt), LD(bsq), b.astype(LD)

    def hsolve(f):
        return op["Vx"] @ ((((op["Vxi"] @ f) @ op["Vyi"].T) * lam)
                           @ op["Vy"].T)

    def A(pp):
        hx = hsolve((op["Gxr"] @ pp) @ op["IyTr"])
        hy = hsolve((op["Ixr"] @ pp) @ op["GyTr"])
        return idt * pp - bsq * (op["Dxi"] @ hx + hy @ op["DyTi"])

    vdot = lambda a, c: np.sum(a * c)
    atol2 = LD(1e-16) * vdot(b, b)
    x, r, p, q = np.zeros_like(b), b, b, b
    rho = alpha = omega = LD(1)
    out = {}
    for it in range(1, max(BUDGETS) + 1):
        if not vdot(r, r) > atol2:
            raise RuntimeError("the reference stopped before its budget")
        rho_ = vdot(b, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        q = A(p)
        alpha = rho_ / vdot(b, q)
        s = r - alpha * q
        t = A(s)
        omega = vdot(t, s) / vdot(t, t)
        x = x + (alpha * p + omega * s)
        r = s - omega * t
        rho = rho_
        if it in BUDGETS:
            out[it] = x.copy()
    return out


def dist(x, ref) -> float:
    x = x.detach().cpu().numpy().astype(LD)
    return float(np.linalg.norm((x - ref).astype(np.float64))
                 / np.linalg.norm(ref.astype(np.float64)))


def gmean(v) -> float:
    return float(np.exp(np.mean(np.log(v))))


SOLVE = re.compile(r"\[accuracy\] (N=\d+ \w+ dt=\S+ seed \d+): (.*)")
DISTANCE = re.compile(r"budget (\d+): (\S+) ([^,\s]+), card loop ")


def compare(outs) -> None:
    """Print every implementation of ``outs`` against OUT's kernel."""
    dists = {}  # (implementation, budget) -> {solve: distance}
    for i, out in enumerate(outs):
        for line in Path(out).read_text().splitlines():
            m = SOLVE.match(line)
            for part in m.group(2).split("; ") if m else ():
                b, name, e = DISTANCE.match(part).groups()
                name += f" ({Path(out).name})" if i else ""
                dists.setdefault((name, int(b)), {})[m.group(1)] = float(e)
    for (name, b), d in dists.items():
        base = dists[("kernel", b)]
        if name == "kernel":
            continue
        lr = np.log([d[k] / base[k] for k in base])
        t = lr.mean() / (lr.std(ddof=1) / np.sqrt(len(lr)))
        print(f"[accuracy] budget {b}: {name} over the kernel, solve by "
              f"solve, over {len(lr)} solves: geometric mean "
              f"{np.exp(lr.mean()):.3f}, t {t:+.2f}", flush=True)


def load(checkout: Path) -> None:
    global cs, nk, torch
    sys.path.insert(0, str(checkout))
    import torch as _torch

    import chip_smoke as _cs
    from anap3_tpu_torch.ops import nk_kernels as _nk
    cs, nk, torch = _cs, _nk, _torch


def variant_libraries() -> dict:
    """The sum-order variants of the kernel, built in parallel."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import nk_schur_steps as steps

    from anap3_tpu_torch.ops import _build
    src = (_build.CSRC / "nk_schur.cu").read_text()
    orders = steps.sum_orders(src)
    with ThreadPoolExecutor(len(orders)) as ex:
        return dict(zip(orders, ex.map(lambda kv: steps.load(*kv)[0],
                                       orders.items())))


def reassociated_apply(S, pp, inv_dt, inv_hlam):
    """``nk_kernels.schur_apply`` with each two-sided product associated
    the other way (A (P B) for (A P) B): the same operators, another
    rounding."""
    def hsolve(f):
        return (S.Vx @ ((S.Vxi @ (f @ S.Vyi.T)) * inv_hlam)) @ S.Vy.T

    gx, gy = S.Gxr @ (pp @ S.IyTr), S.Ixr @ (pp @ S.GyTr)
    return inv_dt * pp - S.beta_sq * nk.div(S, hsolve(gx), hsolve(gy))


def gate(draws: int, libs: dict) -> None:
    """--gate: phase 2f's budget-16 draws for every implementation."""
    systems = [(n, lid, dt) for lid in ("singular", "smoothing")
               for n in cs.NK_N for dt in (0.05, 1.0, 3e3)]
    kept = cs.NK_PERTURB + 1  # the draws of phase 2f
    ratios, t0 = {}, time.time()
    for n, lid, dt in systems:
        pre, rhs, inv_dt, inv_hlam = cs.nk_system(n, lid, dt)
        S, Sc = pre.schur, cs.schur_on_cpu(pre.schur)
        solves = {}
        for name, lib in libs.items():
            def kernel(b, lib=lib):
                nk._lib = lambda: lib
                return nk.schur_kernel(S, b, inv_dt, inv_hlam, 1e-8, 16)
            solves[name] = kernel
        solves["card loop, reassociated"] = lambda b: nk.schur_bicgstab(
            lambda pp: reassociated_apply(S, pp, inv_dt, inv_hlam), b, 1e-8,
            16)
        solves["cpu loop, host threads"] = lambda b: nk.schur_plain(
            Sc, b.cpu(), inv_dt.cpu(), inv_hlam.cpu(), 1e-8, 16)
        for name, M in cs.nk_mutants(S):
            solves[f"mutant: {name}"] = lambda b, M=M: nk.schur_plain(
                M, b, inv_dt, inv_hlam, 1e-8, 16)
        if (lid, dt) == ("singular", 0.05):
            # the draws' CPU loops side by side are the loops one by one
            rhss = [rhs] + [cs.perturbed(rhs, s) for s in (1, 2, 3)]
            same = all(torch.equal(a[0], cs.cpu_loop(
                Sc, b, inv_dt, inv_hlam, 16)[0]) for a, b in zip(
                    cs.cpu_loops(Sc, rhss, inv_dt, inv_hlam, 16), rhss))
            print(f"[gate] N={n}: cpu_loops bit-equal to cpu_loop: {same}",
                  flush=True)
        got = cs.nk_b16_ratios(S, Sc, rhs, inv_dt, inv_hlam, solves, draws)
        for name, r in got.items():
            ratios.setdefault(name, []).append(r)
        print(f"[gate] N={n} {lid} dt={dt:g}: " + "; ".join(
            f"{name} over {sum(x > 1 for x in r)}, largest {max(r):.3f}"
            for name, r in got.items()) + f" ({time.time() - t0:.0f}s)",
            flush=True)
    nk._lib = lambda: libs["kernel"]
    for name, per in ratios.items():
        r = np.concatenate(per)
        over = [int(np.sum(np.asarray(v) > 1)) for v in per]
        share, worst, ok = cs.nk_gate([x for v in per for x in v[:kept]])
        print(f"[gate] {name}: over the bound in {int(np.sum(r > 1))} of "
              f"{r.size} draws (share {np.mean(r > 1):.4f}); largest "
              f"{np.max(r):.3f}; percentiles 50/90/99 of the distance over "
              f"the bound {np.percentile(r, 50):.4f} / "
              f"{np.percentile(r, 90):.4f} / {np.percentile(r, 99):.4f}; "
              f"most over on one system {max(over)} of {draws}; phase 2f's "
              f"{kept} draws a system: share {share:.4f}, largest "
              f"{worst:.3f}, {'passes' if ok else 'refused'}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--perturb", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--system", nargs=3, metavar=("N", "LID", "DT"))
    ap.add_argument("--checkout", type=Path, default=ROOT)
    ap.add_argument("--compare", nargs="+", metavar="OUT")
    ap.add_argument("--gate", type=int, metavar="DRAWS")
    args = ap.parse_args()
    if args.compare:
        compare(args.compare)
        return 0
    load(args.checkout.resolve())
    if not torch.cuda.is_available():
        print("nk_accuracy: needs a CUDA card", file=sys.stderr)
        return 1
    if args.variants and args.checkout.resolve() != ROOT:
        ap.error("--variants patches this checkout's kernel")
    cs.build_all()
    print(card(), flush=True)
    print(f"[accuracy] the kernel of {args.checkout.resolve()}", flush=True)
    kernel = nk._lib()
    libs = {"kernel": kernel}
    if args.variants:
        libs.update(variant_libraries())
    if args.gate:
        gate(args.gate, libs)
        return 0
    if args.system:
        n, lid, dt = args.system
        systems = [(int(n), lid, float(dt))]
    else:
        systems = [(n, lid, dt) for lid in ("singular", "smoothing")
                   for n in (12, 20, 96, 128) for dt in (0.05, 1.0, 3e3)]
    seeds = range(cs.NK_PERTURB + 1) if args.perturb else range(1)
    impls = list(libs) + ["cpu loop"]
    ratio = {b: {k: [] for k in impls} for b in BUDGETS}
    over = {b: {k: [] for k in libs} for b in cs.NK_EARLY}
    pool = ProcessPoolExecutor(WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    jobs = []
    for n, lid, dt in systems:
        pre, rhs0, inv_dt, inv_hlam = cs.nk_system(n, lid, dt)
        S = pre.schur
        op = {f: getattr(S, f).cpu().numpy() for f in OPERATORS}
        lam = inv_hlam.cpu().numpy()
        for seed in seeds:
            rhs = cs.perturbed(rhs0, seed) if seed else rhs0
            jobs.append(((n, lid, dt, seed), S, rhs, inv_dt, inv_hlam,
                         pool.submit(reference, op, lam, float(inv_dt),
                                     S.beta_sq, rhs.cpu().numpy())))
    try:
        for (n, lid, dt, seed), S, rhs, inv_dt, inv_hlam, ref in jobs:
            ref = ref.result()
            Sc = cs.schur_on_cpu(S)
            lines = {k: [] for k in libs}
            for b in BUDGETS:
                x_p, _ = nk.schur_plain(S, rhs, inv_dt, inv_hlam, 1e-8, b)
                x_c, _ = nk.schur_plain(Sc, rhs.cpu(), inv_dt.cpu(),
                                        inv_hlam.cpu(), 1e-8, b)
                e_p, e_c = dist(x_p, ref[b]), dist(x_c, ref[b])
                ratio[b]["cpu loop"].append(e_c / e_p)
                spread = cs.norm_rel(x_c.cuda(), x_p)
                tol = max(cs.NK_B8_TOL, cs.NK_SPREAD * spread)
                extra = ""
                if args.system:
                    threads = torch.get_num_threads()
                    torch.set_num_threads(1)
                    x_1, _ = nk.schur_plain(Sc, rhs.cpu(), inv_dt.cpu(),
                                            inv_hlam.cpu(), 1e-8, b)
                    torch.set_num_threads(threads)
                    extra = (f", cpu loop in one thread "
                             f"{dist(x_1, ref[b]):.3e} (from the card loop "
                             f"{cs.norm_rel(x_1.cuda(), x_p):.3e})")
                for name, lib in libs.items():
                    nk._lib = lambda lib=lib: lib
                    x_k, _ = nk.schur_kernel(S, rhs, inv_dt, inv_hlam, 1e-8,
                                             b)
                    e_k = dist(x_k, ref[b])
                    ratio[b][name].append(e_k / e_p)
                    text = (f"budget {b}: {name} {e_k:.3e}, card loop "
                            f"{e_p:.3e}, cpu loop {e_c:.3e}{extra}")
                    if b in cs.NK_EARLY:
                        err = cs.norm_rel(x_k, x_p)
                        over[b][name].append(
                            (err / tol, f"N={n} {lid} dt={dt:g} seed {seed}"))
                        text += (f" ({name} from the card loop {err:.3e}, "
                                 f"bound {tol:.3e}"
                                 f"{'' if err <= tol else ' MISS'})")
                    lines[name].append(text)
            for name, text in lines.items():
                print(f"[accuracy] N={n} {lid} dt={dt:g} seed {seed}: "
                      + "; ".join(text), flush=True)
    finally:
        nk._lib = lambda: kernel
        pool.shutdown(cancel_futures=True)
    solves = len(jobs)
    for b in BUDGETS:
        print(f"[accuracy] budget {b}: distance from the extended-precision "
              f"loop over the card loop's, geometric mean over {solves} "
              f"solves: " + ", ".join(
                  f"{k} {gmean(v):.3f}" for k, v in ratio[b].items()),
              flush=True)
    for b in cs.NK_EARLY:
        for name, v in over[b].items():
            worst = max(v)
            print(f"[accuracy] budget {b}: {name} over phase 2f's bound in "
                  f"{sum(r > 1 for r, _ in v)} of {solves} solves; its "
                  f"distance from the card loop over the bound: median "
                  f"{float(np.median([r for r, _ in v])):.3f}, largest "
                  f"{worst[0]:.2f} ({worst[1]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
