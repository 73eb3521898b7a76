"""The float64 Newton polish (``newton_polish=true``) of anap3_tpu_torch's
marched solvers against anap3_tpu's, on the CPU.

The counterparts of the JAX package's ``TestNewtonPolish``
(tests/test_steady.py) with its bounds, for SG and FSG, and the same for
VMG and FMG: march iterations and ``polish_steps`` equal to JAX's, psi_min
within 1e-10, the polished state within 1e-9 and the steady residual under
1e-9. A float32 march polishes to the float64 march's polished state (the
analysis then takes float64 operators of the float32 solver's grid).
"""

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import spectral_sg as T

torch.set_num_threads(1)


def host(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def jx():
    import anap3_tpu.models.spectral as JSP
    import anap3_tpu.models.spectral_vmg as JV

    return type("JX", (), dict(JSP=JSP, JV=JV))


def solve_both(jcls, tcls, **kw):
    ref = jcls(**kw)
    ref.solve()
    port = tcls(device="cpu", **kw)
    port.solve()
    return port, ref


def assert_same(port, ref, psi_tol=1e-10):
    assert port.metrics.iterations == ref.metrics.iterations
    assert port.metrics.converged == ref.metrics.converged
    assert port.metrics.polish_steps == ref.metrics.polish_steps
    assert abs(port.metrics.psi_min - ref.metrics.psi_min) <= psi_tol
    np.testing.assert_allclose(host(port.state.u), np.asarray(ref.state.u),
                               rtol=0, atol=1e-9)


class TestNewtonPolish:
    def test_sg_polish_reaches_exact_steady_state(self, jx):
        from anap3_tpu_torch.models.spectral import SGSolver

        port, ref = solve_both(jx.JSP.SGSolver, SGSolver, Re=100.0,
                               nx=16, ny=16,
                               dtype="float64", tolerance=1e-3,
                               newton_polish=True, chunk_size=200)
        assert_same(port, ref)
        m = port.metrics
        assert m.converged and m.polish_steps > 0
        assert m.steady_residual_rms < 1e-9
        assert m.steady_residual_rms == pytest.approx(
            ref.metrics.steady_residual_rms, rel=1e-3)
        R_u, _, _ = T.residuals(port.ops, *port.state)
        assert float(R_u[1:-1, 1:-1].abs().max()) < 1e-7
        assert port.time_series.rel_iter_residual[-1] < 1e-6
        assert len(port.time_series.rel_iter_residual) == len(
            ref.time_series.rel_iter_residual)

    def test_fsg_polish(self, jx):
        from anap3_tpu_torch.models.spectral import FSGSolver

        port, ref = solve_both(jx.JSP.FSGSolver, FSGSolver, Re=100.0,
                               nx=16, ny=16,
                               n_levels=2, dtype="float64", tolerance=1e-3,
                               newton_polish=True, chunk_size=200)
        assert_same(port, ref)
        assert port.metrics.polish_steps > 0
        assert port.metrics.steady_residual_rms < 1e-9

    @pytest.mark.parametrize("cls_name", ["VMGSolver", "FMGSolver"])
    def test_vmg_fmg_polish(self, jx, cls_name):
        from anap3_tpu_torch.models import spectral_vmg as TV

        kw = dict(name="spectral_vmg", Re=25.0, nx=24, ny=24,
                  basis_type="chebyshev", CFL=1.5, beta_squared=5.0,
                  corner_treatment="smoothing", corner_smoothing=0.15,
                  tolerance=1e-4, max_iterations=40000, n_levels=2,
                  coarse_tolerance_factor=1.0, dtype="float64",
                  chunk_size=200, newton_polish=True)
        port, ref = solve_both(getattr(jx.JV, cls_name),
                               getattr(TV, cls_name), **kw)
        assert_same(port, ref)
        assert port.metrics.polish_steps > 0
        assert port.metrics.steady_residual_rms < 1e-9

    def test_polish_off_by_default(self):
        from anap3_tpu_torch.models.spectral import SGSolver

        s = SGSolver(Re=100.0, nx=12, ny=12, dtype="float64",
                     tolerance=1e-3, chunk_size=200, device="cpu")
        s.solve()
        assert s.metrics.polish_steps == 0
        assert s.metrics.steady_residual_rms == 0.0

    def test_float32_march_polishes_to_the_float64_state(self):
        """A float32 march leaves a float64 polished state; the analysis
        takes float64 operators, and the state is the float64 march's
        polished one."""
        from anap3_tpu_torch.models.spectral import SGSolver

        kw = dict(Re=100.0, nx=16, ny=16, tolerance=1e-3,
                  newton_polish=True, chunk_size=200, device="cpu")
        s32 = SGSolver(dtype="float32", **kw)
        s32.solve()
        s64 = SGSolver(dtype="float64", **kw)
        s64.solve()
        assert s32.ops.dtype == torch.float32
        assert s32.state.u.dtype == torch.float64
        assert s32.metrics.steady_residual_rms < 1e-9
        assert abs(s32.metrics.psi_min - s64.metrics.psi_min) < 1e-8
        np.testing.assert_allclose(host(s32.state.u), host(s64.state.u),
                                   rtol=0, atol=1e-8)
