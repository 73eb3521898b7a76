"""The JAX package's VMG and FMG reference numbers that chip_smoke.py holds
the PyTorch port to (its phases 8 and 9), from a run of ``anap3_tpu`` on
the CPU in float32.

Usage (from the repository root; a few minutes on 4 CPU cores):

    python scripts/jax_vmg_reference.py            # both solves
    python scripts/jax_vmg_reference.py --only vmg

Prints, for each solve, one line with the iterations (V-cycles, summed over
the FMG levels), ``converged``, the final kinetic energy, the Ghia Re=100
u-centerline max error and the wall seconds. The configurations are
chip_smoke.py's: the numerics of conf/solver/spectral/sg.yaml (Chebyshev,
CFL 1.5, beta^2 5, smoothed lid 0.15, chunk 5000), Re=100, tolerance 1e-6,
float32;
- VMG N=48 (conf/solver/spectral/vmg.yaml: 3 levels, coarse factor 1; the
  FAS floor at Re=100 keeps the ladder at [48, 24]);
- FMG N=96 (conf/solver/spectral/fmg.yaml: 3 levels, coarse factor 10;
  ladder [24, 48, 96]).
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from anap3_tpu.models.params import SpectralParameters  # noqa: E402
from anap3_tpu.models.spectral_vmg import FMGSolver, VMGSolver  # noqa: E402

BASE = dict(Re=100.0, basis_type="chebyshev", CFL=1.5, beta_squared=5.0,
            corner_treatment="smoothing", corner_smoothing=0.15,
            dtype="float32", chunk_size=5000, convergence_metric="auto",
            tolerance=1e-6, max_iterations=400_000)
CONFIGS = {
    "vmg": (VMGSolver, dict(nx=48, ny=48, multigrid="vmg", n_levels=3,
                            coarse_tolerance_factor=1.0)),
    "fmg": (FMGSolver, dict(nx=96, ny=96, multigrid="fmg", n_levels=3,
                            coarse_tolerance_factor=10.0)),
}


def ghia_u_error(solver, re: int) -> float:
    """Max |u - Ghia| along x = 0.5: the degree-N Chebyshev interpolant of
    the x=0.5 node column at Ghia's y (chip_smoke.py's check)."""
    data = np.genfromtxt(
        REPO / f"data/validation/ghia/ghia_Re{re}_u_centerline.csv",
        delimiter=",", names=True)
    xn, yn = solver.grid["x_nodes"], solver.grid["y_nodes"]
    xc = int(np.argmin(np.abs(xn - 0.5)))
    u_col = np.asarray(solver.fields.u).reshape(len(xn), len(yn))[xc, :]
    fit = np.polynomial.chebyshev.Chebyshev.fit(
        yn, u_col, deg=len(yn) - 1, domain=[float(yn[0]), float(yn[-1])])
    return float(np.max(np.abs(fit(data["y"]) - data["u"])))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=sorted(CONFIGS))
    args = ap.parse_args()
    for name, (cls, over) in CONFIGS.items():
        if args.only and name != args.only:
            continue
        solver = cls(params=SpectralParameters(**dict(BASE, **over)))
        t0 = time.time()
        solver.solve()
        m = solver.metrics
        print(f"{name} N={over['nx']} Re=100 tol=1e-6 float32 (JAX, "
              f"{jax.default_backend()}): iterations {m.iterations}, "
              f"converged {m.converged}, final energy {m.final_energy!r}, "
              f"Ghia u max err {ghia_u_error(solver, 100)!r}, wall "
              f"{time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
