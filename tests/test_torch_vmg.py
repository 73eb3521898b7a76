"""anap3_tpu_torch's VMG/FMG (models/spectral_vmg.py) against anap3_tpu's.

On the CPU in float64, on the JAX tests' configuration
(tests/test_spectral_vmg.py: Re=25, ladder [24, 12]): the level operators
and transfers within 1e-14, one V-cycle from a seeded state within 1e-12
relative on the same matrices (``levels_from_jax``), and whole VMG and FMG
solves with equal cycle counts and fields within 1e-9 absolute. The
V-cycle's safeguards (the non-finite coarse-correction rejection, the
cold-start prelude) are mirrored from the JAX tests, and the two reference
faults the port fixes each have a test that the JAX behaviour fails.

In float32 against the Pallas kernels in interpret mode (x6, full-f32
products), within 1e-4 relative: one step of the smoother's plain version
against ``make_aligned_tau_step`` with a tau that is zero on the velocity
boundary ring, and the port's x6 step and chunk (quadratures every step)
against ``make_pallas_sg_step`` / ``make_pallas_chunk_runner``, flags
equal.
"""

import dataclasses
import logging
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anap3_tpu.models import spectral_sg as J
from anap3_tpu.models import spectral_vmg as JV
from anap3_tpu.models.params import SpectralParameters as JaxParameters
from anap3_tpu_torch.models import runner as TR
from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models import spectral_vmg as TV
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.models.spectral import make_fused_paths
from anap3_tpu_torch.ops import sg_kernels as sgk
from anap3_tpu_torch.ops.basis import make_basis
from anap3_tpu_torch.ops.transfer import nodal_interpolation_matrix

torch.set_num_threads(1)

F32_TOL = 1e-4


def config(**over):
    """tests/test_spectral_vmg.py's make_params, at tolerance 1e-6."""
    base = dict(name="spectral_vmg", Re=25.0, nx=24, ny=24,
                basis_type="chebyshev", CFL=1.5, beta_squared=5.0,
                corner_treatment="smoothing", corner_smoothing=0.15,
                tolerance=1e-6, max_iterations=40000, n_levels=2,
                coarse_tolerance_factor=1.0, dtype="float64", chunk_size=200)
    base.update(over)
    return base


def both_params(**over):
    kw = config(**over)
    return JaxParameters(**kw), SpectralParameters(device="cpu", **kw)


def rel(a, b):
    a = np.asarray(a.detach().numpy() if torch.is_tensor(a) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def seeded_state(jops, seed, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    nf = jops.bc_u.shape[0]
    u, v, p = (0.05 * rng.standard_normal(s)
               for s in ((nf, nf), (nf, nf), (nf - 2, nf - 2)))
    u, v = J.enforce_bc(jops, jnp.asarray(u, dtype), jnp.asarray(v, dtype))
    return J.SpectralState(u=u, v=v, p=jnp.asarray(p, dtype))


def ring_zero_tau(nf, seed, scale=1e-2):
    rng = np.random.default_rng(seed)
    t_u = np.zeros((nf, nf))
    t_v = np.zeros((nf, nf))
    t_u[1:-1, 1:-1] = scale * rng.standard_normal((nf - 2, nf - 2))
    t_v[1:-1, 1:-1] = scale * rng.standard_normal((nf - 2, nf - 2))
    return t_u, t_v, scale * rng.standard_normal((nf - 2, nf - 2))


_OPS_FIELDS = [f.name for f in dataclasses.fields(T.SpectralOps)]


class TestLevels:
    @pytest.mark.parametrize("over", [
        {},
        dict(nx=48, ny=48, n_levels=3),
        dict(basis_type="legendre"),
        dict(corner_treatment="singular", Re=100.0, nx=48, ny=48),
    ], ids=["cheb-24-12", "cheb-48-24-12", "legendre", "singular-48-24"])
    def test_levels_match_jax(self, over):
        jp, tp = both_params(**over)
        jl, tl = JV.build_vmg_levels(jp), TV.build_vmg_levels(tp)
        assert [lv.n for lv in tl] == [lv.n for lv in jl]
        assert len(tl) >= 2
        for a, b in zip(tl, jl):
            for name in TV._TRANSFERS:
                x, y = getattr(a, name), getattr(b, name)
                assert (x is None) == (y is None), name
                if y is not None:
                    np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                               rtol=0, atol=1e-14,
                                               err_msg=name)
            for name in _OPS_FIELDS:
                x, y = getattr(a.ops, name), getattr(b.ops, name, None)
                if torch.is_tensor(x):
                    np.testing.assert_allclose(x.double().numpy(),
                                               np.asarray(y, np.float64),
                                               rtol=0, atol=1e-14,
                                               err_msg=name)
        if over.get("corner_treatment") == "singular":
            # the singular ladder restricts the defect by injection
            assert torch.equal(tl[0].res_full, tl[0].inj_full)

    def test_floors_match_jax(self):
        for re in (25.0, 100.0, 1000.0, 3200.0, 10000.0):
            for sing in (False, True):
                assert TV.fas_coarsest_n(re, sing) == JV.fas_coarsest_n(re, sing)
            assert TV.cell_peclet(re, 96) == JV.cell_peclet(re, 96)
        jp, tp = both_params(Re=1000.0, nx=96, ny=96, n_levels=5)
        assert [lv.n for lv in TV.build_vmg_levels(tp)] == [96]
        jp, tp = both_params(Re=1000.0, nx=192, ny=192, n_levels=3)
        assert [lv.n for lv in TV.build_vmg_levels(tp)] == \
            [lv.n for lv in JV.build_vmg_levels(jp)] == [192, 96]

    def test_orders_must_be_strictly_decreasing_from_the_fine_order(self):
        """Reference fault (anap3_tpu/models/spectral_vmg.py:283): JAX
        accepts a repeated order and a ladder that does not start at the
        fine order; the port refuses both."""
        jp, tp = both_params(nx=48, ny=48)
        JV.build_vmg_levels(jp, orders=[48, 48, 24])  # the JAX behaviour
        with pytest.raises(ValueError, match="strictly decreasing"):
            TV.build_vmg_levels(tp, orders=[48, 48, 24])
        with pytest.raises(ValueError, match="strictly decreasing"):
            TV.build_vmg_levels(tp, orders=[24, 48])
        with pytest.raises(ValueError, match="fine order 48"):
            TV.build_vmg_levels(tp, orders=[32, 16])
        assert [lv.n for lv in TV.build_vmg_levels(tp, orders=[48, 32])] \
            == [48, 32]

    def test_non_nested_inner_restriction_is_exact_resampling(self):
        """Reference fault (anap3_tpu/models/spectral_vmg.py:364): on a
        non-nested Chebyshev pair the inner-grid state restriction must
        resample polynomials exactly, as the full-grid one does; JAX's
        nearest-node injection does not."""
        jp, tp = both_params(nx=48, ny=48)
        tl = TV.build_vmg_levels(tp, orders=[48, 32])
        jl = JV.build_vmg_levels(jp, orders=[48, 32])
        b = make_basis("chebyshev", (0.0, 1.0))
        x_fi, x_ci = b.nodes(49)[1:-1], b.nodes(33)[1:-1]
        f = lambda x: 3 * x ** 4 - x ** 2 + 0.5
        np.testing.assert_allclose(tl[0].inj_inner.numpy() @ f(x_fi),
                                   f(x_ci), atol=1e-12)
        np.testing.assert_allclose(tl[0].inj_inner.numpy(),
                                   nodal_interpolation_matrix(x_fi, x_ci),
                                   rtol=0, atol=0)
        jax_err = np.abs(np.asarray(jl[0].inj_inner) @ f(x_fi) - f(x_ci))
        assert jax_err.max() > 1e-3  # what the port no longer does
        # the full-grid transfers are the JAX package's
        np.testing.assert_allclose(tl[0].inj_full.numpy(),
                                   np.asarray(jl[0].inj_full), atol=1e-14)


class TestVCycle:
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_one_cycle_matches_jax(self, corner):
        over = dict(corner_treatment=corner)
        if corner == "singular":
            over.update(Re=100.0, nx=48, ny=48)  # ladder [48, 24]
        jp, _ = both_params(**over)
        jl = JV.build_vmg_levels(jp)
        tl = TV.levels_from_jax(jl, "cpu", torch.float64)
        jst = seeded_state(jl[0].ops, 7)
        js, jm = JV.make_v_cycle(jl)(jst)
        ts, tm = TV.make_v_cycle(tl)(T.state_from_numpy(jst, "cpu",
                                                        torch.float64))
        for a, b in zip(ts, js):
            assert rel(a, b) <= 1e-12
        for k in jm:
            assert rel(tm[k], jm[k]) <= 1e-12, k

    def test_kernel_smoothers_on_cpu_take_the_plain_loop(self):
        """The smoother wrappers (plain on CPU tensors) give the plain
        cycle bit for bit."""
        _, tp = both_params()
        tl = TV.build_vmg_levels(tp)
        st = TV.make_v_cycle(tl)(T.initial_state(tl[0].ops))[0]
        sgk.reset_counts()
        smoothers = {i: sgk.make_sg_smoother(lv.ops)
                     for i, lv in enumerate(tl)}
        a, ma = TV.make_v_cycle(tl, smoothers=smoothers)(st)
        assert sgk.PLAIN_CALLS["sg_smooth"] == 3  # pre, coarse, post
        b, mb = TV.make_v_cycle(tl)(st)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert all(torch.equal(ma[k], mb[k]) for k in mb)

    def test_nonfinite_coarse_correction_rejected(self):
        """A NaN coarse level's correction is dropped: the cycle equals
        nu1 + nu2 plain fine steps (the JAX test of the same name)."""
        _, tp = both_params()
        levels = TV.build_vmg_levels(tp)
        levels[1].ops = dataclasses.replace(levels[1].ops, nu=float("nan"))
        state = T.initial_state(levels[0].ops)
        for _ in range(20):
            state, _ = T.sg_step(levels[0].ops, state)
        cycled, _ = TV.make_v_cycle(levels)(state)
        ref = state
        for _ in range(TV.VMGSolver.NU1 + TV.VMGSolver.NU2):
            ref, _ = T.sg_step(levels[0].ops, ref)
        for a, b in zip(cycled, ref):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=0, atol=1e-13)


def _solve_both(cls_name, **over):
    kw = config(**over)
    ref = getattr(JV, cls_name)(**kw)
    ref.solve()
    port = getattr(TV, cls_name)(device="cpu", **kw)
    port.solve()
    return port, ref


def assert_same_solve(port, ref, atol=1e-9):
    assert port.metrics.iterations == ref.metrics.iterations
    assert port.metrics.converged == ref.metrics.converged
    for name in ("u", "v", "p"):
        np.testing.assert_allclose(getattr(port.fields, name),
                                   getattr(ref.fields, name), rtol=0,
                                   atol=atol, err_msg=name)


class TestSolvers:
    @pytest.mark.parametrize("cls_name,over", [
        ("VMGSolver", {}),
        ("FMGSolver", dict(name="spectral_fmg", coarse_tolerance_factor=10.0)),
    ])
    def test_solve_matches_jax(self, cls_name, over):
        port, ref = _solve_both(cls_name, **over)
        assert port.metrics.converged
        assert_same_solve(port, ref)
        assert port.metrics.final_energy == pytest.approx(
            ref.metrics.final_energy, rel=1e-10)
        assert port.metrics.psi_min == pytest.approx(ref.metrics.psi_min,
                                                     rel=1e-8)

    def test_cold_start_prelude_above_ceiling_matches_jax(self, monkeypatch,
                                                          caplog):
        monkeypatch.setattr(JV, "VMG_COLD_START_MAX_N", 12)
        monkeypatch.setattr(TV, "VMG_COLD_START_MAX_N", 12)
        with caplog.at_level(logging.INFO, logger=TV.__name__):
            port, ref = _solve_both("VMGSolver")
        msgs = [r.message for r in caplog.records if r.name == TV.__name__]
        assert any("warm-starting from the nested-iteration cascade" in m
                   for m in msgs)
        assert any("warm-start prelude done" in m for m in msgs)
        assert port.metrics.converged
        assert_same_solve(port, ref)

    def test_cold_start_prelude_divergence_fallback(self, monkeypatch):
        """A diverged prelude level falls back to its finite warm start
        and is prolongated through every remaining pair to the finest
        level (the JAX test of the same name)."""
        _, tp = both_params(nx=48, ny=48, n_levels=3)
        vmg = TV.VMGSolver(params=tp)
        levels = TV.build_vmg_levels(tp)
        assert len(levels) == 3

        def fake_rfp(step, get_uv, state, **kw):
            bad = T.SpectralState(*(torch.full_like(t, float("nan"))
                                    for t in state))
            return TR.IterationResult(state=bad, iterations=5,
                                      converged=False, diverged=True,
                                      wall_time=0.0, history={})

        monkeypatch.setattr(TV, "run_fixed_point", fake_rfp)
        st, total = vmg._cold_start_warm_state(levels, 1e-6, 100)
        assert st.u.shape == (49, 49)
        assert torch.isfinite(st.u).all()
        assert total == 5

    def test_fmg_divergence_is_fine_shaped_nan(self, monkeypatch):
        def fake_rfp(step, get_uv, state, **kw):
            bad = T.SpectralState(*(torch.full_like(t, float("nan"))
                                    for t in state))
            return TR.IterationResult(state=bad, iterations=7,
                                      converged=False, diverged=True,
                                      wall_time=0.0, history={})

        monkeypatch.setattr(TV, "run_fixed_point", fake_rfp)
        solver = TV.FMGSolver(device="cpu", **config())
        solver.solve()
        assert solver.metrics.converged is False
        assert solver.state.u.shape == (25, 25)
        assert torch.isnan(solver.state.u).all()
        assert not np.isfinite(solver.time_series.energy[-1])

    def test_degenerate_hierarchy_runs_sg_with_a_warning(self, caplog):
        kw = config(Re=1000.0, max_iterations=40)
        with caplog.at_level(logging.WARNING):
            port = TV.VMGSolver(device="cpu", **kw)
            port.solve()
        assert any("single level" in r.message for r in caplog.records)
        ref = JV.VMGSolver(**kw)
        ref.solve()
        assert port.metrics.iterations == ref.metrics.iterations == 40

    @pytest.mark.parametrize("cls_name", ["VMGSolver", "FMGSolver"])
    def test_singular_legendre_falls_back_to_sg(self, cls_name, caplog):
        kw = config(basis_type="legendre", corner_treatment="singular",
                    max_iterations=40)
        with caplog.at_level(logging.WARNING):
            port = getattr(TV, cls_name)(device="cpu", **kw)
            port.solve()
        assert any("falling back to the single-grid solve" in r.message
                   for r in caplog.records)
        ref = getattr(JV, cls_name)(**kw)
        ref.solve()
        assert port.metrics.iterations == ref.metrics.iterations == 40
        # the fallback SG solve runs the float64 polish as JAX's does
        kw = dict(kw, newton_polish=True)
        port = getattr(TV, cls_name)(device="cpu", **kw)
        port.solve()
        ref = getattr(JV, cls_name)(**kw)
        ref.solve()
        assert port.metrics.polish_steps == ref.metrics.polish_steps > 0
        assert port.metrics.converged and ref.metrics.converged
        assert port.metrics.steady_residual_rms <= 1e-9

    def test_tf32_is_refused_on_cuda_not_set(self, monkeypatch):
        """The FAS cancellation needs full-f32 products: TF32 on the card
        raises, and the check leaves the settings as it found them."""
        TV.check_fp32_matmul(torch.device("cpu"))  # nothing to check
        old = torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            with pytest.raises(RuntimeError, match="full-float32"):
                TV.check_fp32_matmul(torch.device("cuda"))
            assert torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            TV.check_fp32_matmul(torch.device("cuda"))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old


# ------------------------------------------- against the Pallas kernels


def f32_jax_ops(n, corner="smoothing", Re=400.0):
    p = JaxParameters(Re=Re, nx=n, ny=n, dtype="float32",
                      basis_type="chebyshev", CFL=1.5,
                      corner_treatment=corner)
    return J.build_spectral_ops(p, dtype=jnp.float32)[0]


class TestAgainstPallas:
    @pytest.mark.parametrize("n", [32, 48])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_smoother_step_matches_aligned_tau_step(self, n, corner):
        """One forced step of the smoother's plain version against TPU
        kernel #6, the VMG smoother (x6), with a ring-zero tau."""
        from anap3_tpu.ops.pallas_aligned import make_aligned_tau_step

        jops = f32_jax_ops(n, corner)
        nf = n + 1
        jst = seeded_state(jops, n, jnp.float32)
        tau = ring_zero_tau(nf, n + 1)
        js, jm = make_aligned_tau_step(jops, interpret=True, algorithm="x6")(
            jst, tuple(jnp.asarray(a, jnp.float32) for a in tau))
        ops = T.ops_from_jax(jops, "cpu", torch.float32)
        ts, tm = sgk.smooth_plain(
            ops, T.state_from_numpy(jst, "cpu", torch.float32),
            tuple(torch.as_tensor(a, dtype=torch.float32) for a in tau), 1)
        for a, b in zip(ts, js):
            assert rel(a, b) <= F32_TOL
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=F32_TOL), k

    @pytest.mark.parametrize("n", [16, 24])
    def test_x6_step_matches_pallas_step(self, n):
        """TPU kernel #4: the port's x6 step is its SG step kernel."""
        from anap3_tpu.ops.pallas_step import make_pallas_sg_step

        jops = f32_jax_ops(n)
        jst = seeded_state(jops, n, jnp.float32)
        js, jm = make_pallas_sg_step(jops, interpret=True)(jst)
        ops = T.ops_from_jax(jops, "cpu", torch.float32)
        step, _ = make_fused_paths(ops, "x6")
        ts, tm = step(T.state_from_numpy(jst, "cpu", torch.float32))
        for a, b in zip(ts, js):
            assert rel(a, b) <= F32_TOL
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=F32_TOL), k

    @pytest.mark.parametrize("n", [16, 24])
    def test_x6_chunk_matches_pallas_chunk(self, n):
        """TPU kernel #5: the port's x6 route runs its chunk kernel with
        quadratures every step, so every row matches, and a tolerance met
        mid-chunk gives the same flags."""
        from anap3_tpu.ops.pallas_chunk import make_pallas_chunk_runner

        jops = f32_jax_ops(n, Re=100.0)
        ops = T.ops_from_jax(jops, "cpu", torch.float32)
        _, factory = make_fused_paths(ops, "x6")
        jst = J.initial_state(jops)
        tst = T.state_from_numpy(jst, "cpu", torch.float32)
        chunk = 24
        probe = None
        for tol in (1e-30, None):
            if tol is None:  # between two rel_iter values of the probe
                rel_col = probe[:, 0]
                tol = float(rel_col[10:18].min()) * 1.001
            jout = make_pallas_chunk_runner(jops, chunk, tol, 10,
                                            interpret=True)(
                jst, jnp.int32(0), jnp.float32(np.inf))
            tout = factory(chunk, tol, "rel_iter")(tst, 0, np.inf)
            assert (bool(tout[1]), int(tout[2]), bool(tout[3])) == (
                bool(jout[1]), int(jout[2]), bool(jout[3]))
            for a, b in zip(tout[0], jout[0]):
                assert rel(a, b) <= F32_TOL
            trows, jrows = tout[4].numpy(), np.asarray(jout[4])
            np.testing.assert_array_equal(np.isnan(trows), np.isnan(jrows))
            fin = np.isfinite(jrows)
            for c in range(7):
                col = fin[:, c]
                if col.any():
                    assert rel(trows[col, c], jrows[col, c]) <= F32_TOL, c
            probe = trows
        assert bool(jout[3]) and 11 <= int(jout[2]) <= 18


def test_main_cli_drives_vmg(repo_root, tmp_path):
    cmd = [sys.executable, str(repo_root / "main.py"), "solver=gpu/vmg",
           "N=24", "Re=25", "solver.device=cpu", "tolerance=1e-4",
           "max_iterations=400", "solver.n_levels=2", "plots=false",
           f"mlflow.tracking_uri={tmp_path / 'mlruns'}"]
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "Done:" in out
    assert "VMG hierarchy: N = [24, 12]" in out
