"""anap3_tpu_torch's FV-SIMPLE path (models/fv.py, ops/fv_stencils.py and
the FV Poisson builders of ops/poisson.py) against anap3_tpu's, on the CPU.

Both packages run float64 on the same seeded inputs (made with numpy):

- every stencil function, in every limiter mode, within 1e-13 absolute;
- the two FV Poisson builders' ``solve`` and ``solve_refined`` on a
  mean-free right-hand side within 1e-12 relative, and the spectral builder
  unchanged bit for bit;
- five ``fv_step`` iterations, from rest and from a seeded state, at 16x16
  and 16x12 (nx != ny catches a swapped operator orientation): states and
  metrics within 1e-10 relative;
- ``FVSolver`` at N=16 Re=100 tol 1e-4: equal iterations and
  ``converged``, fields within 1e-9, ``psi_min`` within 1e-8 relative.

The CLI test drives the port through ``main.py solver=gpu/fv`` with
``solver.device=cpu``.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from anap3_tpu.models import fv as JF
from anap3_tpu.models.params import FVParameters as JaxParameters
from anap3_tpu.ops import fv_stencils as JS
from anap3_tpu.ops import poisson as JP
from anap3_tpu_torch.models import fv as TF
from anap3_tpu_torch.models.params import FVParameters
from anap3_tpu_torch.ops import fv_stencils as TS
from anap3_tpu_torch.ops import poisson as TP

torch.set_num_threads(1)

STENCIL_ATOL = 1e-13
STEP_RTOL = 1e-10


def base(**over):
    kw = dict(name="fv", Re=100.0, nx=16, ny=16, convection_scheme="TVD",
              limiter="MUSCL", alpha_uv=0.4, alpha_p=0.2,
              linear_solver_tol=1e-9, tolerance=1e-4, max_iterations=3000,
              corner_treatment="none", dtype="float64", chunk_size=200)
    kw.update(over)
    return kw


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def j64(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def close(port, ref, atol=STENCIL_ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0,
                               atol=atol)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def seeded_state(ny, nx, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return [scale * rng.standard_normal(s)
            for s in ((ny, nx),) * 3 + ((ny, nx - 1), (ny - 1, nx))]


class TestStencils:
    ny, nx = 7, 9

    def fields(self, seed):
        rng = np.random.default_rng(seed)
        phi = rng.standard_normal((self.ny, self.nx))
        mx = rng.standard_normal((self.ny, self.nx - 1))
        my = rng.standard_normal((self.ny - 1, self.nx))
        return phi, mx, my

    @pytest.mark.parametrize("use_limiter", [False, True])
    @pytest.mark.parametrize("pin", [False, True])
    def test_cell_gradient(self, use_limiter, pin):
        phi, _, _ = self.fields(1)
        phi[2, 3] += 4.0  # a spike: the limiter acts there
        for port, ref in zip(
                TS.cell_gradient(t64(phi), 0.1, 0.2, use_limiter, pin),
                JS.cell_gradient(j64(phi), 0.1, 0.2, use_limiter, pin)):
            close(port, ref)

    def test_momentum_coefficients(self):
        _, mx, my = self.fields(2)
        rng = np.random.default_rng(3)
        bcs = [rng.standard_normal(n) for n in (self.ny, self.ny, self.nx,
                                                self.nx)]
        port = TS.momentum_coefficients(t64(mx), t64(my), 0.01, 0.1, 0.2,
                                        *map(t64, bcs))
        ref = JS.momentum_coefficients(j64(mx), j64(my), 0.01, 0.1, 0.2,
                                       *map(j64, bcs))
        for name in TS.MomentumCoeffs._fields:
            close(getattr(port, name), getattr(ref, name))

    @pytest.mark.parametrize("scheme,limiter", [
        ("TVD", "MUSCL"), ("TVD", None), ("TVD", "MUSCL-sharp"),
        ("Upwind", "MUSCL")])
    def test_deferred_correction(self, scheme, limiter):
        phi, mx, my = self.fields(4)
        port = TS.deferred_correction(t64(phi), t64(mx), t64(my), scheme,
                                      limiter)
        ref = JS.deferred_correction(j64(phi), j64(mx), j64(my), scheme,
                                     limiter)
        close(port, ref)

    def test_face_averages_and_divergence(self):
        phi, mx, my = self.fields(5)
        close(TS.face_average_x(t64(phi)), JS.face_average_x(j64(phi)))
        close(TS.face_average_y(t64(phi)), JS.face_average_y(j64(phi)))
        close(TS.divergence_from_fluxes(t64(mx), t64(my)),
              JS.divergence_from_fluxes(j64(mx), j64(my)))

    def test_apply_momentum_operator(self):
        phi, mx, my = self.fields(6)
        z = np.zeros
        args = (0.01, 0.1, 0.2, z(self.ny), z(self.ny), z(self.nx),
                z(self.nx))
        tc = TS.momentum_coefficients(t64(mx), t64(my), *args[:3],
                                      *map(t64, args[3:]))
        jc = JS.momentum_coefficients(j64(mx), j64(my), *args[:3],
                                      *map(j64, args[3:]))
        close(TS.apply_momentum_operator(tc, t64(phi)),
              JS.apply_momentum_operator(jc, j64(phi)))
        close(TS.apply_momentum_operator(tc, t64(phi), tc.aP / 0.4),
              JS.apply_momentum_operator(jc, j64(phi), jc.aP / 0.4))
        # a leading batch dimension applies the operator per slice
        both = TS.apply_momentum_operator(tc, t64(np.stack([phi, 2 * phi])))
        close(both[1], 2 * np.asarray(JS.apply_momentum_operator(
            jc, j64(phi))))


class TestPoisson:
    @pytest.mark.parametrize("ny,nx", [(12, 12), (10, 14)])
    def test_fv_neumann_pressure_poisson(self, ny, nx):
        dx, dy = 1.0 / nx, 1.0 / ny
        port = TP.fv_neumann_pressure_poisson(nx, ny, dx, dy)
        ref = JP.fv_neumann_pressure_poisson(nx, ny, dx, dy,
                                             dtype=jnp.float64)
        assert port.singular and ref.singular
        assert tuple(port.Vx.shape) == (ny, ny)  # build(Ay, Ax)
        assert tuple(port.inv_lam.shape) == (ny, nx)
        for name in ("Vx", "Vx_inv", "Vy", "Vy_inv", "inv_lam", "Ax", "Ay"):
            close(getattr(port, name), getattr(ref, name), atol=0.0)
        f = np.random.default_rng(7).standard_normal((ny, nx))
        f -= f.mean()
        for n_refine in (0, 1, 2):
            a = port.solve_refined(t64(f), n_refine)
            b = ref.solve_refined(j64(f), n_refine)
            assert rel(a, b) <= 1e-12
        # the solve inverts the operator on mean-free data, mean-free out
        u = port.solve(t64(f))
        assert rel(port.apply(u), f) <= 1e-12
        assert abs(float(u.mean())) <= 1e-13

    def test_fd_dirichlet_poisson(self):
        port = TP.fd_dirichlet_poisson(9, 6, 0.1, 0.15)
        ref = JP.fd_dirichlet_poisson(9, 6, 0.1, 0.15, dtype=jnp.float64)
        assert not port.singular
        torch.testing.assert_close(port.Vx_inv, port.Vx.T, rtol=0, atol=0)
        f = np.random.default_rng(8).standard_normal((9, 6))
        f -= f.mean()
        assert rel(port.solve(t64(f)), ref.solve(j64(f))) <= 1e-12
        assert rel(port.solve_refined(t64(f), 1),
                   ref.solve_refined(j64(f), 1)) <= 1e-12

    def test_spectral_builder_is_unchanged(self):
        """The spectral callers keep the general-eig build bit for bit."""
        from anap3_tpu.ops.basis import chebyshev_diff_matrix

        D = np.asarray(chebyshev_diff_matrix(10))
        D2 = D @ D
        port = TP.spectral_dirichlet_poisson(D2, D2)
        A = D2[1:-1, 1:-1]
        lam, V = np.linalg.eig(A)
        lam, V = np.real(lam), np.real(V)
        expect = dict(Vx=V, Vx_inv=np.linalg.inv(V), Vy=V,
                      Vy_inv=np.linalg.inv(V),
                      inv_lam=1.0 / (lam[:, None] + lam[None, :]))
        for name, arr in expect.items():
            assert torch.equal(getattr(port, name), t64(arr)), name
        assert not port.singular


class TestStep:
    @pytest.mark.parametrize("ny,nx", [(16, 16), (12, 16)])
    @pytest.mark.parametrize("start", ["rest", "seeded"])
    def test_fv_step_matches_jax(self, ny, nx, start):
        kw = base(nx=nx, ny=ny, corner_treatment="smoothing")
        jops, _ = JF.build_fv_ops(JaxParameters(**kw))
        tops, _ = TF.build_fv_ops(FVParameters(device="cpu", **kw))
        if start == "rest":
            state = [np.zeros(s) for s in ((ny, nx),) * 3
                     + ((ny, nx - 1), (ny - 1, nx))]
        else:
            state = seeded_state(ny, nx, seed=nx + ny)
        js = JF.FVState(*map(j64, state))
        ts = TF.fv_state_from_numpy(state, "cpu", torch.float64)
        for _ in range(5):
            js, jm = JF.fv_step(jops, js)
            ts, tm = TF.fv_step(tops, ts)
        for a, b, name in zip(ts, js, TF.FVState._fields):
            assert a.shape == tuple(b.shape)
            assert rel(a, b) <= STEP_RTOL, name
        assert set(tm) == set(jm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]),
                                                 rel=STEP_RTOL), k

    def test_build_fv_ops_matches_jax(self):
        kw = base(nx=12, ny=10, corner_treatment="smoothing")
        for dtype, lin_tol, n_refine in (("float64", 1e-9, 0),
                                         ("float32", None, 1)):
            jops, jgrid = JF.build_fv_ops(JaxParameters(**dict(kw,
                                                               dtype=dtype)))
            tops, tgrid = TF.build_fv_ops(FVParameters(device="cpu",
                                                       **dict(kw,
                                                              dtype=dtype)))
            assert tops.lin_tol == jops.lin_tol
            assert tops.n_refine == jops.n_refine == n_refine
            if lin_tol is not None:
                assert tops.lin_tol == lin_tol
            assert (tops.nx, tops.ny) == (12, 10)
            close(tops.bc_u_n.double(), np.asarray(jops.bc_u_n, np.float64),
                  atol=0.0)
            assert float(tops.mu) == pytest.approx(float(jops.mu), rel=1e-7)
            assert tgrid["mu"] == jgrid["mu"]
            np.testing.assert_array_equal(tgrid["x_centers"],
                                          jgrid["x_centers"])

    def test_ops_from_jax_round_trip(self):
        jops, _ = JF.build_fv_ops(JaxParameters(**base(nx=10, ny=8)))
        tops = TF.fv_ops_from_jax(jops, "cpu", torch.float64)
        ref, _ = TF.build_fv_ops(FVParameters(device="cpu",
                                              **base(nx=10, ny=8)))
        for name in ("Vx", "Vy", "inv_lam", "Ax", "Ay"):
            assert torch.equal(getattr(tops.poisson, name),
                               getattr(ref.poisson, name)), name
        assert tops.poisson.singular
        assert (tops.scheme, tops.limiter, tops.rhie_chow) == (
            ref.scheme, ref.limiter, ref.rhie_chow)

    def test_bicgstab_follows_jax_semantics(self):
        """The iteration count and breakdown codes of jax's bicgstab."""
        import jax

        rng = np.random.default_rng(9)
        n = 30
        A = np.eye(n) * 4 + 0.5 * rng.standard_normal((n, n))
        b = rng.standard_normal(n)
        # (tol, atol, maxiter, iterations): the relative test, the maxiter
        # stop, and the absolute test
        for tol, atol, maxiter, iters in ((1e-10, 0.0, 1000, 21),
                                          (1e-10, 0.0, 3, 3),
                                          (0.0, 1e-6, 1000, 16)):
            x_t, k = TF.bicgstab(lambda x: t64(A) @ x, t64(b),
                                 torch.zeros(n, dtype=torch.float64), tol,
                                 atol=atol, maxiter=maxiter)
            x_j, _ = jax.scipy.sparse.linalg.bicgstab(
                lambda x: j64(A) @ x, j64(b), tol=tol, atol=atol,
                maxiter=maxiter)
            assert rel(x_t, x_j) <= 1e-10
            assert k == iters
        # A = I: s = 0 after one step, the ||s||^2 < atol2 early exit
        x_t, k = TF.bicgstab(lambda x: x, t64(b),
                             torch.zeros(n, dtype=torch.float64), 1e-8)
        assert k == 1 and torch.equal(x_t, t64(b))
        # b = 0: rho = <rhat, r> = 0 on the first step unless the test stops
        # first; with tol = atol = 0 the loop runs and breaks down (-10)
        _, k = TF.bicgstab(lambda x: t64(A) @ x,
                           torch.zeros(n, dtype=torch.float64),
                           torch.zeros(n, dtype=torch.float64), 0.0)
        assert k == 0  # ||r||^2 = 0 <= atol2 = 0: no iteration runs


class TestSolver:
    @pytest.mark.parametrize("variant", [
        {}, {"convection_scheme": "Upwind"},
        {"corner_treatment": "smoothing", "corner_smoothing": 0.2}])
    def test_matches_jax(self, variant, repo_root):
        kw = base(**variant)
        ref = JF.FVSolver(**kw)
        ref.solve()
        port = TF.FVSolver(device="cpu", **kw)
        port.solve()
        assert port.device == torch.device("cpu")
        assert port.metrics.iterations == ref.metrics.iterations
        assert port.metrics.converged == ref.metrics.converged is True
        for name in ("u", "v", "p", "x", "y"):
            np.testing.assert_allclose(getattr(port.fields, name),
                                       getattr(ref.fields, name), rtol=0,
                                       atol=1e-9, err_msg=name)
        assert port.metrics.psi_min == pytest.approx(ref.metrics.psi_min,
                                                     rel=1e-8)
        assert port.metrics.final_energy == pytest.approx(
            ref.metrics.final_energy, rel=1e-9)
        if not variant:
            # the JAX base class's bilinear evaluation, now the port's too
            e_t = port.compute_validation_errors(base_dir=repo_root,
                                                 save_plots=False)
            e_j = ref.compute_validation_errors(base_dir=repo_root,
                                                save_plots=False)
            assert set(e_t) == set(e_j) and e_t
            for k in e_j:
                assert e_t[k] == pytest.approx(e_j[k], rel=1e-7), k
            U = port.fields.u.reshape(16, 16)
            V = port.fields.v.reshape(16, 16)
            xs = np.unique(port.fields.x)
            np.testing.assert_allclose(
                port._vorticity_for_export(U, V, xs, xs),
                ref._vorticity_for_export(U, V, xs, xs), rtol=0, atol=1e-12)

    def test_vorticity_and_streamfunction_match_jax(self):
        kw = base(nx=12, ny=10, max_iterations=40, tolerance=1e-12)
        ref = JF.FVSolver(**kw)
        ref.solve()
        port = TF.FVSolver(device="cpu", **kw)
        port.solve()
        assert port.metrics.iterations == ref.metrics.iterations == 40
        close(port._vorticity_full(), ref._vorticity_full(), atol=1e-9)
        psi_t, X_t, _ = port._streamfunction()
        psi_j, X_j, _ = ref._streamfunction()
        np.testing.assert_allclose(np.asarray(psi_t), np.asarray(psi_j),
                                   rtol=0, atol=1e-10)
        np.testing.assert_array_equal(X_t, X_j)

    def test_device_policy(self):
        assert FVParameters().device == "cuda"
        s = TF.FVSolver(device="cpu", **base(dtype="auto", max_iterations=1))
        assert s.params.dtype == "float64"
        assert s.state.u.dtype == torch.float64
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                TF.FVSolver(**base())

    def test_checkpointing_is_not_ported(self):
        with pytest.raises(NotImplementedError, match="checkpoint"):
            TF.FVSolver(device="cpu", checkpoint_dir="/nonexistent", **base())


def test_main_cli_drives_the_port(repo_root, tmp_path):
    cmd = [sys.executable, str(repo_root / "main.py"), "solver=gpu/fv",
           "N=12", "Re=100", "solver.device=cpu", "tolerance=1e-3",
           "max_iterations=300", "plots=false",
           f"mlflow.tracking_uri={tmp_path / 'mlruns'}"]
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "Done:" in out
    assert "anap3_tpu_torch" in out  # the port's modules logged the run


def test_fv_port_imports_no_jax(repo_root):
    """The FV modules load with jax blocked: any jax import would raise."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import anap3_tpu_torch, anap3_tpu_torch.models.fv, "
            "anap3_tpu_torch.ops.fv_kernels, anap3_tpu_torch.ops.fv_stencils, "
            "anap3_tpu_torch.ops.poisson; "
            "from anap3_tpu_torch.models import FVSolver; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo_root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-3000:]
