"""How close the Schur BiCGSTAB comes to its extended-precision trajectory
in three float64 implementations, on one CUDA card.

Usage (from the repository root, on a machine with a card; ~2 min):

    python3 scripts/nk_accuracy.py

The systems are chip_smoke.py phase 2f's (``chip_smoke.nk_system``: the
Schur system of one preconditioner application at N = 12, 20, 96, 128, dt
0.05, 1 and 3e3, the sharp lid at Re=1000 and the smoothed one at Re=250).
Each is solved for 1, 8 and 16 iterations (no solve stops before 21) by

- the Schur kernel (``nk_kernels.schur_kernel``),
- the plain loop on the card (``schur_plain``: cuBLAS products),
- the plain loop on the CPU (the host BLAS's products),

and by the same loop in numpy ``longdouble`` (x86 extended precision, 64
mantissa bits) from the same float64 operands, the reference. Prints each
implementation's relative distance from the reference, then for each
budget the geometric mean over the systems of each distance over the card
loop's. The budget-1 distance is the rounding of two S-applies; later ones
show how the iterations amplify it.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from anap3_tpu_torch.ops import nk_kernels as nk  # noqa: E402

BUDGETS = (1, 8, 16)
LD = np.longdouble


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def reference(S, rhs, inv_dt, inv_hlam):
    """x after each of BUDGETS iterations of the BiCGSTAB of
    ``nk_kernels.schur_bicgstab`` in longdouble."""
    op = {name: S_np.astype(LD) for name, S_np in (
        (f, getattr(S, f).cpu().numpy()) for f in (
            "Gxr", "IyTr", "Ixr", "GyTr", "Vxi", "Vyi", "Vx", "Vy", "Dxi",
            "DyTi"))}
    lam = inv_hlam.cpu().numpy().astype(LD)
    idt, bsq = LD(float(inv_dt)), LD(S.beta_sq)

    def hsolve(f):
        return op["Vx"] @ ((((op["Vxi"] @ f) @ op["Vyi"].T) * lam)
                           @ op["Vy"].T)

    def A(pp):
        hx = hsolve((op["Gxr"] @ pp) @ op["IyTr"])
        hy = hsolve((op["Ixr"] @ pp) @ op["GyTr"])
        return idt * pp - bsq * (op["Dxi"] @ hx + hy @ op["DyTi"])

    b = rhs.cpu().numpy().astype(LD)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("nk_accuracy: needs a CUDA card", file=sys.stderr)
        return 1
    cs.build_all()
    print(card(), flush=True)
    ratios = {b: {"kernel": [], "cpu": []} for b in BUDGETS}
    for lid in ("singular", "smoothing"):
        for n in (12, 20, 96, 128):
            for dt in (0.05, 1.0, 3e3):
                pre, rhs, inv_dt, inv_hlam = cs.nk_system(n, lid, dt)
                S, Sc = pre.schur, cs.schur_on_cpu(pre.schur)
                ref = reference(S, rhs, inv_dt, inv_hlam)
                line = []
                for b in BUDGETS:
                    x_k, _ = nk.schur_kernel(S, rhs, inv_dt, inv_hlam, 1e-8, b)
                    x_p, _ = nk.schur_plain(S, rhs, inv_dt, inv_hlam, 1e-8, b)
                    x_c, _ = nk.schur_plain(Sc, rhs.cpu(), inv_dt.cpu(),
                                            inv_hlam.cpu(), 1e-8, b)
                    e_k, e_p, e_c = (dist(x, ref[b]) for x in (x_k, x_p, x_c))
                    ratios[b]["kernel"].append(e_k / e_p)
                    ratios[b]["cpu"].append(e_c / e_p)
                    line.append(f"budget {b}: kernel {e_k:.3e}, card loop "
                                f"{e_p:.3e}, cpu loop {e_c:.3e}")
                print(f"[accuracy] N={n} {lid} dt={dt:g}: " + "; ".join(line),
                      flush=True)
    for b in BUDGETS:
        gm = {k: float(np.exp(np.mean(np.log(v))))
              for k, v in ratios[b].items()}
        print(f"[accuracy] budget {b}: distance from the extended-precision "
              f"loop over the card loop's, geometric mean over "
              f"{len(ratios[b]['kernel'])} systems: kernel {gm['kernel']:.3f}, "
              f"cpu loop {gm['cpu']:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
