"""The port's validation evaluation against the JAX package's.

- ``jacobi_vandermonde`` is bitwise the column stack of ``jacobi_poly``
  and bitwise the JAX package's ``jacobi_vandermonde``;
- ``SGSolver._evaluate_at_points``, which evaluates on the grid of the
  points' unique coordinates and gathers, agrees with the JAX package's
  point-by-point evaluation on the same solver to 1e-13 of the field's max,
  on seeded random float64 states at N = 16 and 24: on the 128 x 128 FV
  truth grid in file order and shuffled, a line x = 0.5, one point and 300
  scattered points, in singular mode, and through
  ``compute_validation_errors`` (to 1e-12).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from anap3_tpu.models.spectral import SGSolver as JaxSGSolver
from anap3_tpu.ops import basis as jax_basis
from anap3_tpu_torch.models import spectral as S
from anap3_tpu_torch.models import spectral_sg as core
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.ops import basis
from anap3_tpu_torch.utils.vts import read_vts

REPO = Path(__file__).resolve().parent.parent
TRUTH = REPO / "data/validation/fv/Re1000/solution.vts"


@pytest.mark.parametrize("points", ["cgl", "random"])
@pytest.mark.parametrize("degree", [0, 1, 2, 5, 40, 96, 128])
@pytest.mark.parametrize("alpha,beta",
                         [(0.0, 0.0), (1.0, 1.0), (-0.5, -0.5), (2.0, 0.5)])
def test_vandermonde_is_bit_equal_to_column_stack(alpha, beta, degree,
                                                  points):
    if points == "cgl":
        x = basis.cgl_nodes(degree + 1)
    else:
        x = np.random.default_rng(degree).uniform(-1.0, 1.0, 500)
    V = basis.jacobi_vandermonde(x, alpha, beta, degree)
    stack = np.stack([basis.jacobi_poly(x, alpha, beta, n)
                      for n in range(degree + 1)], axis=1)
    assert V.dtype == stack.dtype and V.shape == stack.shape
    assert V.flags.c_contiguous
    assert np.array_equal(V, stack)
    assert np.array_equal(V, jax_basis.jacobi_vandermonde(x, alpha, beta,
                                                          degree))


def seeded_solver(n, corner="smoothing", seed=0):
    solver = S.SGSolver(params=SpectralParameters(
        device="cpu", name="spectral", Re=1000.0, nx=n, ny=n,
        basis_type="chebyshev", CFL=1.5, corner_treatment=corner,
        dtype="float64"))
    rng = np.random.default_rng(seed)
    u, v = core.enforce_bc(solver.ops, *(torch.as_tensor(
        0.1 * rng.standard_normal((n + 1, n + 1))) for _ in "uv"))
    solver.state = core.SpectralState(
        u, v, torch.zeros((n - 1, n - 1), dtype=torch.float64))
    return solver


def reference(solver, x, y):
    """The JAX package's point-by-point evaluation on the port's solver."""
    return JaxSGSolver._evaluate_at_points(solver, x, y)


def points(kind):
    if kind in ("truth", "shuffled"):
        g = read_vts(TRUTH)
        x, y = g.points[:, 0], g.points[:, 1]
        assert np.unique(x).size == np.unique(y).size == 128
        if kind == "shuffled":
            order = np.random.default_rng(1).permutation(x.size)
            x, y = x[order], y[order]
        return x, y
    if kind == "line":
        y = np.linspace(0.0, 1.0, 129)
        return np.full_like(y, 0.5), y
    if kind == "point":
        return np.array([0.3]), np.array([0.7])
    rng = np.random.default_rng(2)
    return rng.uniform(0.0, 1.0, 300), rng.uniform(0.0, 1.0, 300)


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("kind", ["truth", "shuffled", "line", "point",
                                  "scattered"])
@pytest.mark.parametrize("n", [16, 24])
def test_evaluation_matches_jax(n, kind):
    solver = seeded_solver(n, seed=n)
    x, y = points(kind)
    u, v = solver._evaluate_at_points(x, y)
    ref_u, ref_v = reference(solver, x, y)
    for got, ref, F in ((u, ref_u, solver.state.u),
                        (v, ref_v, solver.state.v)):
        assert got.dtype == np.float64 and got.shape == x.shape
        assert np.max(np.abs(got - ref)) <= 1e-13 * np.max(np.abs(F.numpy()))


@pytest.mark.parametrize("n", [16, 24])
def test_singular_evaluation_matches_jax(n):
    solver = seeded_solver(n, corner="singular", seed=n + 1)
    assert solver._is_singular()
    x, y = points("shuffled")
    u, v = solver._evaluate_at_points(x, y)
    ref_u, ref_v = reference(solver, x, y)
    assert rel(u, ref_u) <= 1e-13 and rel(v, ref_v) <= 1e-13


def test_nan_state_evaluates_to_nan():
    solver = seeded_solver(16)
    solver.state = solver.state._replace(u=solver.state.u * np.nan)
    u, v = solver._evaluate_at_points(*points("truth"))
    assert np.isnan(u).all() and np.isfinite(v).all()


@pytest.mark.parametrize("n", [16, 24])
def test_validation_errors_match_jax(n, monkeypatch):
    solver = seeded_solver(n, seed=3 * n)
    got = solver.compute_validation_errors(base_dir=REPO, save_plots=False)
    assert set(got) == {"u_L2_error", "v_L2_error", "u_L2_error_regu",
                        "v_L2_error_regu"}
    monkeypatch.setattr(solver, "_evaluate_at_points",
                        lambda x, y: reference(solver, x, y))
    ref = solver.compute_validation_errors(base_dir=REPO, save_plots=False)
    for key, value in ref.items():
        assert got[key] == pytest.approx(value, rel=1e-12, abs=0), key
