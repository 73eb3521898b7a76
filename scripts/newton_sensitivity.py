"""How the cold Newton solve's PTC step count moves under rounding-level
perturbations, on one CUDA card.

Usage (from the repository root, on a machine with a card; ~25 min at
--seeds 19):

    python3 scripts/newton_sensitivity.py [--seeds 9] [--only kernel|plain]

The solve is chip_smoke.py's cold one (N=128 Re=1000 sharp lid on the
Legendre grid, newton.yaml's knobs, tolerance 1e-6, from rest), run by
``steady.ptc_solve`` (``chip_smoke.cold_solve``) with the Schur BiCGSTAB
by the Schur kernel (``nk_kernels.schur_kernel``, the port's path) and by
its plain version (the masked loop, in the same CUDA graph), each from x0
(seed 0) and from x0 plus the seeded 1e-15 noise of seeds 1..``--seeds``
(``chip_smoke.cold_noise``); ``--only`` runs one of the two. Prints one
line a run (PTC steps, converged, GMRES vectors, the final ||F||_rms, the
wall seconds), then for each Schur solver the steps' and vectors' median,
mean, least, most and 10th-90th percentile band. chip_smoke.py's
PLAIN_COLD_STEPS is the plain loop's band at --seeds 19.

Then, when both run, at the state after ten steps of the plain loop's
solve, for dt 1, 30 and 3e3, the two preconditioners side by side:
GMRES(60)'s relative residual and vectors on F there, and how far P^{-1}
is from linear (||P(a + b) - P(a) - P(b)|| / ||P(a + b)|| on two seeded
vectors; BiCGSTAB cut by its budget is not linear). The plain loop on the
card is a measuring device here: the port's CUDA path never runs it.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from anap3_tpu_torch.models import spectral_sg as core  # noqa: E402
from anap3_tpu_torch.models import steady  # noqa: E402
from anap3_tpu_torch.ops import nk_kernels as nk  # noqa: E402


def plain_on_card(S, rhs, inv_dt, inv_hlam, tol, maxiter):
    return nk.schur_plain(S, rhs, inv_dt, inv_hlam, tol, maxiter)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def spread(values) -> str:
    v = np.asarray(values, np.float64)
    lo, hi = np.percentile(v, [10, 90])
    return (f"median {np.median(v):g}, mean {v.mean():.2f}, least "
            f"{v.min():g}, most {v.max():g}, 10th-90th percentile "
            f"{lo:g}-{hi:g}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=9,
                    help="the noise seeds 1..SEEDS beside x0 (default 9)")
    ap.add_argument("--only", choices=("kernel", "plain"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("newton_sensitivity: needs a CUDA card", file=sys.stderr)
        return 1
    cs.build_all()
    params = cs.newton_params()
    solver = steady.NewtonSolver(params=params)
    prob = steady._SteadyProblem(solver.ops)
    pre = steady._StokesPreconditioner(prob, solver.grid,
                                       schur_iters=params.newton_schur_iters)
    kernel = nk.schur_kernel
    print(card(), flush=True)
    try:
        for tag, schur in (("kernel", kernel), ("plain", plain_on_card)):
            if args.only not in (None, tag):
                continue
            nk.schur_kernel = schur
            steps, vectors = [], []
            for seed in range(args.seeds + 1):
                t0 = time.time()
                n, conv, vec, rms = cs.cold_solve(prob, pre, params, seed)
                steps.append(n)
                vectors.append(vec)
                src = f"x0 + noise of seed {seed}" if seed else "x0"
                print(f"[sensitivity] {tag}, {src}: {n} PTC steps, "
                      f"converged {conv}, {vec} GMRES vectors, ||F||_rms "
                      f"{rms:.3e}, wall {time.time() - t0:.1f}s", flush=True)
            print(f"[sensitivity] {tag} over {len(steps)} runs: PTC steps "
                  f"{steps} ({spread(steps)}); GMRES vectors {vectors} "
                  f"({spread(vectors)})", flush=True)
        if args.only:
            return 0
        nk.schur_kernel = plain_on_card
        x0 = steady._host(prob.state_to_x(core.initial_state(solver.ops)))
        x10 = steady.ptc_solve(prob, pre, x0, tol_rms=0.0, max_steps=10,
                               gmres_vectors=60, dt0=0.05, dt_max=3e3)[0]
        F10 = steady._host(prob.F(x10))
        rng = np.random.default_rng(0)
        a, b = (rng.standard_normal(prob.n_tot) for _ in range(2))
        for dt in (1.0, 30.0, 3e3):
            for tag, schur in (("kernel", kernel), ("plain", plain_on_card)):
                nk.schur_kernel = schur
                mv = steady._Matvec(prob, pre)
                mv.set_step(x10, 1.0 / dt)
                P = mv.precond_apply
                gap = (np.linalg.norm(P(a + b) - P(a) - P(b))
                       / np.linalg.norm(P(a + b)))
                _, rel, used = steady._gmres(mv, P, F10, 60, 1e-4)
                print(f"[sensitivity] after 10 steps, dt {dt:g}, {tag}: "
                      f"GMRES relative residual {rel:.3e} ({used} vectors), "
                      f"P^-1 off linear by {gap:.3e}", flush=True)
    finally:
        nk.schur_kernel = kernel
    return 0


if __name__ == "__main__":
    sys.exit(main())
