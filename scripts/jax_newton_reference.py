"""The JAX package's Newton reference numbers that chip_smoke.py holds the
PyTorch port's Newton path to, from a run of ``anap3_tpu`` on the CPU.

Usage (from the repository root; several minutes on the CPU):

    python scripts/jax_newton_reference.py             # both solves
    python scripts/jax_newton_reference.py --only warm
    python scripts/jax_newton_reference.py --only cold --basis chebyshev

The configuration is chip_smoke.py's Newton path: the Newton knobs of
conf/solver/spectral/newton.yaml (float64, 50 PTC steps, GMRES(60), dt0
0.05, dt_max 3e3, 40 Schur iterations, no prelude) on the sharp lid
(``corner_treatment=singular``), N=128, Re=1000, on the Legendre-Gauss-
Lobatto grid (``basis_type=legendre``, the parameters' default): the grid
of the stored exact states in data/steady/ (their steady residual is
2e-11 there and O(1) on the Chebyshev grid that sg.yaml selects;
``--basis chebyshev`` runs that grid instead);

- cold: from rest, tolerance 1e-6 (the RMS steady residual);
- warm: from data/steady/sharp_Re1000_N128.npz, tolerance 1e-8.

Prints one line a solve: PTC steps, ``converged``, the final RMS steady
residual ||F||_rms, psi_min, omega_center, the final kinetic energy, the
GMRES vectors of every accepted step (from the solver's log lines), the
wall seconds, and ||F||_rms after each accepted step (from the solver's
residual history). ``--steps n`` caps the solve at n PTC steps (the
trajectory's first steps, which chip_smoke.py holds the port's to).
"""

import argparse
import logging
import re
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from anap3_tpu.models.steady import NewtonSolver, _SteadyProblem  # noqa: E402

BASE = dict(Re=1000.0, nx=128, ny=128, basis_type="legendre", CFL=1.5,
            beta_squared=5.0, corner_treatment="singular", dtype="float64",
            newton_max_steps=50, gmres_vectors=60, newton_dt0=0.05,
            newton_dt_max=3e3, newton_schur_iters=40, newton_prelude=0)
FIXTURE = REPO / "data/steady/sharp_Re1000_N128.npz"
CASES = {
    "cold": dict(tolerance=1e-6),
    "warm": dict(tolerance=1e-8, initial_state_path=str(FIXTURE)),
}


class _Vectors(logging.Handler):
    """GMRES vectors of each accepted PTC step, from the log lines."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.vectors = []

    def emit(self, record):
        m = re.search(r"gmres\(rel \S+, (\d+) vec\)", record.getMessage())
        if m:
            self.vectors.append(int(m.group(1)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=sorted(CASES))
    ap.add_argument("--basis", choices=("legendre", "chebyshev"),
                    default="legendre")
    ap.add_argument("--steps", type=int, default=BASE["newton_max_steps"],
                    help="cap the PTC steps (default: newton.yaml's 50)")
    args = ap.parse_args()
    steady_log = logging.getLogger("anap3_tpu.models.steady")
    steady_log.setLevel(logging.INFO)
    for name, over in CASES.items():
        if args.only and name != args.only:
            continue
        vec = _Vectors()
        steady_log.addHandler(vec)
        solver = NewtonSolver(**dict(BASE, basis_type=args.basis,
                                     newton_max_steps=args.steps, **over))
        t0 = time.time()
        solver.solve()
        wall = time.time() - t0
        steady_log.removeHandler(vec)
        prob = _SteadyProblem(solver.ops)
        F = np.asarray(prob.F(prob.state_to_x(solver.state)))
        rms = float(np.linalg.norm(F) / np.sqrt(prob.n_tot))
        m = solver.metrics
        print(f"{name} N=128 Re=1000 singular {args.basis} "
              f"tol={over['tolerance']:g} "
              f"(JAX, {jax.default_backend()}): steps {m.iterations}, "
              f"converged {m.converged}, ||F||_rms {rms!r}, psi_min "
              f"{m.psi_min!r}, omega_center {m.omega_center!r}, final "
              f"energy {m.final_energy!r}, GMRES vectors {vec.vectors}, "
              f"wall {wall:.1f}s", flush=True)
        ts = solver.time_series
        steps_rms = [float(np.sqrt(u * u + v * v + c * c) / np.sqrt(prob.n_tot))
                     for u, v, c in zip(ts.u_residual, ts.v_residual,
                                        ts.continuity_residual)]
        print(f"{name} ||F||_rms after each step: {steps_rms!r}", flush=True)


if __name__ == "__main__":
    main()
