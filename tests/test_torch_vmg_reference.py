"""The benchmark's plain V-cycle reference (``ldc_bench/reference/vmg.py``)
against anap3_tpu_torch's V-cycle, on the CPU in float64.

- One V-cycle of the port's plain path (``make_v_cycle`` with the plain
  smoothing loop) from seeded random smooth states equals one cycle of the
  reference within 1e-12 relative: three seeds, the smoothed and the plain
  lid, the cell's floor-guarded ladder [48, 24] and a two-level ladder
  [16, 8] forced through ``orders=`` (the reference given the same one).
- The reference's floor-guarded ladder is the port's at every order and Re
  tried.
- A VMG solve to 1e-6 at N=24 (the least order with two levels: the FAS
  floor is 12 up to Re=25) and Re=25 (~7 s) reads ``uv_cycle`` at least
  10x below the same state with one value at the centre moved by 1e-3.
- The reference imports nothing of the port, of the JAX package or of JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.polynomial.chebyshev import chebvander

from anap3_tpu_torch.models import spectral_sg as core
from anap3_tpu_torch.models import spectral_vmg as TV
from anap3_tpu_torch.models.params import SpectralParameters
from ldc_bench.reference import vmg as RV

torch.set_num_threads(1)

REL_TOL = 1e-12


def config(**over):
    """The benchmark's VMG configuration (ldc_bench/configs/vmg-re100.json),
    in float64."""
    base = dict(name="spectral_vmg", basis_type="chebyshev", Re=100.0,
                nx=48, ny=48, n_levels=3, CFL=1.5, beta_squared=5.0,
                corner_treatment="smoothing", corner_smoothing=0.15,
                lid_velocity=1.0, Lx=1.0, Ly=1.0, tolerance=1e-6,
                max_iterations=10_000_000, multigrid="vmg",
                coarse_tolerance_factor=1.0, dtype="float64",
                chunk_size=5000)
    base.update(over)
    return base


def smooth_state(ops, n, seed, degree=6, scale=0.05):
    """A seeded random smooth state: Chebyshev series of degree ``degree``
    in x and y, the wall values imposed."""
    rng = np.random.default_rng(seed)
    V = chebvander(-np.cos(np.pi * np.arange(n + 1) / n), degree)
    field = lambda A: A @ (scale * rng.standard_normal(  # noqa: E731
        (degree + 1, degree + 1))) @ A.T
    u, v = core.enforce_bc(ops, torch.as_tensor(field(V)),
                           torch.as_tensor(field(V)))
    return core.SpectralState(u, v, torch.as_tensor(field(V[1:-1])))


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("lid", ["smoothing", "none"])
@pytest.mark.parametrize("n, orders", [(48, None), (16, [16, 8])],
                         ids=["floor-48-24", "forced-16-8"])
def test_one_cycle_matches_the_reference(seed, lid, n, orders):
    kw = config(nx=n, ny=n, corner_treatment=lid)
    levels = TV.build_vmg_levels(SpectralParameters(device="cpu", **kw),
                                 orders=orders)
    assert [lv.n for lv in levels] == (orders or [48, 24])
    state = smooth_state(levels[0].ops, n, seed)
    port, _ = TV.make_v_cycle(levels)(state)
    ref = RV.v_cycle(kw, n, tuple(state), orders=orders)
    for a, b, s in zip(port, ref, state):
        assert rel(a, b) <= REL_TOL
        assert rel(a, s) > 1e-3  # the cycle moved the state


@pytest.mark.parametrize("n, Re", [(48, 100.0), (32, 100.0), (24, 25.0),
                                   (96, 1000.0), (192, 400.0), (50, 100.0),
                                   (64, 5000.0)])
def test_the_ladder_is_the_ports(n, Re):
    kw = config(nx=n, ny=n, Re=Re)
    levels = TV.build_vmg_levels(SpectralParameters(device="cpu", **kw))
    assert RV.ladder(kw, n) == [lv.n for lv in levels]


def test_a_solve_reads_well_below_a_moved_value():
    kw = config(nx=24, ny=24, Re=25.0)
    solver = TV.VMGSolver(params=SpectralParameters(device="cpu", **kw))
    solver.solve()
    assert solver.ladder == [24, 12] and solver.metrics.converged
    state = [t.numpy().copy() for t in solver.state]
    sound = RV.lane_numbers(kw, 24, state)
    state[0][12, 12] += 1e-3
    moved = RV.lane_numbers(kw, 24, state)
    assert moved["uv_cycle"] >= 10 * sound["uv_cycle"]
    assert sound["uv_cycle"] < 1e-6


def test_the_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys\n"
            "import ldc_bench.reference.vmg\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'anap3_tpu', 'anap3_tpu_torch', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
