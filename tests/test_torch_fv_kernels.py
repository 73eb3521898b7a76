"""The FV-SIMPLE kernel wrappers of anap3_tpu_torch (ops/fv_kernels.py).

On the CPU (every run): the wrappers' plain versions against the Pallas TPU
kernels themselves (``anap3_tpu/ops/pallas_fv.py``), run as their own tests
run them (``interpret=True``, float32, K=16 BiCGSTAB iterations, chunks of
30), at 16x16 and at ny=12, nx=16; then the wrappers' checks, dispatch and
counters, and ``FVSolver``'s choice of path. Tolerances: state within 1e-5
absolute, metrics and rows[:, 0] within 1e-4 relative, flags and conv_iter
equal. Both sides are float32 and sum in different orders; 1e-5 absolute
is about 100 ulp of the O(0.1-1) velocities.

On a CUDA card (marker ``gpu``): every FV kernel against its plain version
on the same device tensors, the checks of ``chip_smoke.py`` phase 2b:
relative error <= 1e-10 in float64 (with n_refine 0 and 1), <= 1e-4 in
float32 (the step and a 32-iteration chunk from rest: measured <= 1e-6 on
an H100), flags equal, and two runs of a chunk equal bit for bit. Run
them there with
``python -m pytest tests/test_torch_fv_kernels.py -m gpu --noconftest``
(tests/conftest.py imports JAX, which that machine lacks). Without a card
these tests skip, saying so.
"""

import dataclasses
import logging
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import fv as TF
from anap3_tpu_torch.models import runner as TR
from anap3_tpu_torch.models.params import FVParameters
from anap3_tpu_torch.ops import _build
from anap3_tpu_torch.ops import fv_kernels as fvk

torch.set_num_threads(1)

F32_ABS = 1e-5
F32_TOL = 1e-4
F64_TOL = 1e-10
K = 16
CHUNK = 30


def base(**over):
    """The numerics of conf/solver/fv.yaml at a test size."""
    kw = dict(name="fv", Re=100.0, nx=16, ny=16, convection_scheme="TVD",
              limiter="MUSCL", alpha_uv=0.4, alpha_p=0.2,
              linear_solver_tol=1e-9, tolerance=1e-4, max_iterations=3000,
              corner_treatment="none", dtype="float32", chunk_size=200)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: imported here, not at module level, because the
    card's machine has no JAX and runs only the ``gpu`` tests of this file
    (with ``--noconftest``: tests/conftest.py imports JAX too)."""
    import jax.numpy as jnp
    from anap3_tpu.models import fv as JF
    from anap3_tpu.models.params import FVParameters as JaxParameters
    from anap3_tpu.ops.pallas_fv import (make_pallas_fv_chunk_runner,
                                         make_pallas_fv_step)

    def setup(ny, nx, **over):
        kw = base(nx=nx, ny=ny, **over)
        jp = JaxParameters(**kw)
        jops, _ = JF.build_fv_ops(jp)
        tops = TF.fv_ops_from_jax(jops, "cpu", torch.float32)
        return jp, jops, tops

    def rest(ny, nx):
        return [np.zeros(s, np.float32) for s in ((ny, nx),) * 3
                + ((ny, nx - 1), (ny - 1, nx))]

    def jstate(arrs):
        return JF.FVState(*(jnp.asarray(a, jnp.float32) for a in arrs))

    return SimpleNamespace(jnp=jnp, setup=setup, rest=rest, jstate=jstate,
                           step=make_pallas_fv_step,
                           chunk=make_pallas_fv_chunk_runner)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def absd(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def tstate(arrs, device="cpu", dtype=torch.float32):
    return TF.fv_state_from_numpy(arrs, device, dtype)


def perturbed(inv_lam, size=0.5, seed=0):
    """Eigenvalue inverses of the pressure solve scaled by 1 + size * u, u
    uniform in [-1, 1] (the zero mode stays zero)."""
    rng = np.random.default_rng(seed)
    return inv_lam * (1 + size * rng.uniform(-1, 1, inv_lam.shape))


SHAPES = [(16, 16), (12, 16)]  # (ny, nx): nx != ny catches a swapped basis


class TestAgainstPallas:
    @pytest.mark.parametrize("ny,nx", SHAPES)
    def test_step_matches_pallas_step(self, jx, ny, nx):
        """Three steps from rest (the transient with the largest updates)."""
        jp, jops, tops = jx.setup(ny, nx)
        jstep = jx.step(jp, jops, bicgstab_iters=K, interpret=True)
        tstep = fvk.make_fv_step(jp, tops, bicgstab_iters=K)
        js, ts = jx.jstate(jx.rest(ny, nx)), tstate(jx.rest(ny, nx))
        for _ in range(3):
            js, jm = jstep(js)
            ts, tm = tstep(ts)
        for a, b, name in zip(ts, js, TF.FVState._fields):
            assert a.dtype == torch.float32 and a.shape == tuple(b.shape)
            assert absd(a, b) <= F32_ABS, name
        assert set(tm) == set(jm) == set(fvk.METRIC_NAMES)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=F32_TOL), k

    @pytest.mark.parametrize("ny,nx", SHAPES)
    def test_chunks_match_pallas_chunks(self, jx, ny, nx):
        """Two chunks of 30 from rest, tol 1e-4 (tests/test_fv.py's case)."""
        jp, jops, tops = jx.setup(ny, nx)
        jrun = jx.chunk(jp, jops, CHUNK, 1e-4, 10, bicgstab_iters=K,
                        interpret=True)
        trun = fvk.make_fv_chunk_runner(jp, tops, CHUNK, 1e-4, 10,
                                        bicgstab_iters=K)
        js, ts = jx.jstate(jx.rest(ny, nx)), tstate(jx.rest(ny, nx))
        rn = jx.jnp.asarray(np.inf, jx.jnp.float32)
        for c in range(2):
            js, jd, jci, jcv, jrows, _ = jrun(js, jx.jnp.int32(c * CHUNK), rn)
            ts, td, tci, tcv, trows, _ = trun(ts, c * CHUNK, np.inf)
            assert (bool(td), int(tci), bool(tcv)) == (bool(jd), int(jci),
                                                       bool(jcv))
            for a, b, name in zip(ts, js, TF.FVState._fields):
                assert absd(a, b) <= F32_ABS, name
            assert trows.dtype == torch.float32
            assert tuple(trows.shape) == (CHUNK, 7)
            np.testing.assert_allclose(trows[:, 0].numpy(),
                                       np.asarray(jrows)[:, 0], rtol=F32_TOL)

    def test_refinement_on_a_perturbed_solve_matches_pallas(self, jx):
        """The pressure refinement (one step in float32) with the eigenvalue
        inverses scaled by 1 + 0.5 u: the first solve then misses by up to
        50%, and the refinement moves the state by far more than the bound
        (with the exact inverses it moves it by the solve's rounding)."""
        ny, nx = 12, 16
        jp, jops, _ = jx.setup(ny, nx)
        P = jops.poisson
        inv = perturbed(np.asarray(P.inv_lam))
        jops = jops._replace(poisson=dataclasses.replace(
            P, inv_lam=jx.jnp.asarray(inv, P.inv_lam.dtype)))
        tops = TF.fv_ops_from_jax(jops, "cpu", torch.float32)
        assert tops.n_refine == 1
        js = jx.jstate(jx.rest(ny, nx))
        ts = t0 = tstate(jx.rest(ny, nx))
        jstep = jx.step(jp, jops, bicgstab_iters=K, interpret=True)
        S = fvk.statics(jp, tops)
        for _ in range(3):
            js, _ = jstep(js)
            ts, _ = fvk.step_plain(S, ts, K)
            t0, _ = fvk.step_plain(dict(S, n_refine=0), t0, K)
        for a, b, c, name in zip(ts, js, t0, TF.FVState._fields):
            assert absd(a, b) <= F32_ABS, name
            assert absd(c, b) > 10 * F32_ABS, name

    def test_convergence_flags_match_pallas_chunk(self, jx):
        """A tolerance met mid-chunk: equal conv_iter, converged, and NaN
        rows from there on."""
        ny, nx = 12, 16
        jp, jops, tops = jx.setup(ny, nx)
        st = tstate(jx.rest(ny, nx))
        probe = fvk.make_fv_chunk_runner(jp, tops, CHUNK, 1e-30, 10, K)(
            st, 0, np.inf)[4].numpy()
        tol = float(probe[12:20, 0].min()) * 1.001
        jout = jx.chunk(jp, jops, CHUNK, tol, 10, bicgstab_iters=K,
                        interpret=True)(jx.jstate(jx.rest(ny, nx)),
                                        jx.jnp.int32(0),
                                        jx.jnp.asarray(np.inf,
                                                       jx.jnp.float32))
        tout = fvk.make_fv_chunk_runner(jp, tops, CHUNK, tol, 10, K)(
            st, 0, np.inf)
        assert bool(jout[3]) and 13 <= int(jout[2]) <= 20
        assert (bool(tout[1]), int(tout[2]), bool(tout[3])) == (
            bool(jout[1]), int(jout[2]), bool(jout[3]))
        trows, jrows = tout[4].numpy(), np.asarray(jout[4])
        np.testing.assert_array_equal(np.isnan(trows), np.isnan(jrows))
        assert np.isnan(trows[int(tout[2]):]).all()
        for a, b, name in zip(tout[0], jout[0], TF.FVState._fields):
            assert absd(a, b) <= F32_ABS, name


class TestWrappers:
    def ops(self, **over):
        kw = dict(nx=10, ny=8, dtype="float64")
        kw.update(over)
        p = FVParameters(device="cpu", **base(**kw))
        return p, TF.build_fv_ops(p)[0]

    def test_cpu_tensors_take_the_plain_versions(self):
        p, ops = self.ops()
        st = TF.initial_state(ops)
        fvk.reset_counts()
        s1, m1 = fvk.make_fv_step(p, ops, K)(st)
        s2, m2 = fvk.step_plain(fvk.statics(p, ops), st, K)
        assert all(torch.equal(a, b) for a, b in zip(s1, s2))
        assert all(torch.equal(m1[k], m2[k]) for k in m2)
        fvk.make_fv_chunk_runner(p, ops, 4, 1e-30, 10, K)(st, 0, np.inf)
        assert fvk.PLAIN_CALLS == {"fv_step": 2, "fv_chunk": 1,
                                   "fv_unfused": 0}
        assert fvk.LAUNCHES == {k: 0 for k in fvk.KERNELS}
        fvk.reset_counts()
        assert not any(fvk.PLAIN_CALLS.values())

    def test_plain_chunk_matches_generic_runner(self):
        """The chunk's plain state machine is runner.make_chunk_runner over
        the plain step, converging mid-chunk (rows NaN once done)."""
        p, ops = self.ops()
        S = fvk.statics(p, ops)
        st = TF.initial_state(ops)
        probe = fvk.chunk_plain(S, st, 0, np.inf, 25, 1e-30, 10, K)[4]
        tol = float(probe[12:20, 0].min()) * (1 + 1e-9)
        a = fvk.chunk_plain(S, st, 0, np.inf, 25, tol, 10, K)
        b = TR.make_chunk_runner(
            lambda s: fvk.step_plain(S, s, K), lambda s: (s.u, s.v),
            25, tol, 10)(st, 0, torch.tensor(np.inf, dtype=torch.float64))
        assert bool(a[3]) and 13 <= int(a[2]) <= 20
        assert [int(a[i]) for i in (1, 2, 3)] == [int(b[i]) for i in (1, 2, 3)]
        torch.testing.assert_close(a[4][:, 0], b[4][:, 0], rtol=1e-13, atol=0,
                                   equal_nan=True)
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))

    def test_nan_state_diverges(self):
        p, ops = self.ops()
        st = TF.initial_state(ops)
        u = st.u.clone()
        u[3, 4] = float("nan")
        out = fvk.make_fv_chunk_runner(p, ops, 6, 1e-3, 10, K)(
            TF.FVState(u, *st[1:]), 30, np.inf)
        assert [int(out[i]) for i in (1, 2, 3)] == [1, 31, 0]
        assert torch.isnan(out[4]).all()

    @pytest.mark.parametrize("over,match", [
        ({"limiter": "MUSCL-sharp"}, "MUSCL-sharp"),
        ({"rhie_chow": "averaged"}, "compact"),
        ({"nx": 2}, "nx, ny >= 3")])
    def test_unsupported_configs_raise(self, over, match):
        p, ops = self.ops(**over)
        with pytest.raises(ValueError, match=match):
            fvk.make_fv_step(p, ops, K)
        with pytest.raises(ValueError, match=match):
            fvk.make_fv_chunk_runner(p, ops, 4, 1e-3, 10, K)

    def test_checks_dtype_shape_contiguity(self):
        p, ops = self.ops()
        step = fvk.make_fv_step(p, ops, K)
        st = TF.initial_state(ops)
        with pytest.raises(TypeError, match="dtype"):
            step(TF.FVState(st.u.float(), *st[1:]))
        with pytest.raises(ValueError, match="shape"):
            step(TF.FVState(st.u, st.v, st.p, st.u, st.my))
        with pytest.raises(ValueError, match="contiguous"):
            wide = torch.zeros((ops.ny, 2 * ops.nx), dtype=torch.float64)
            step(TF.FVState(wide[:, ::2], *st[1:]))
        with pytest.raises(TypeError, match="float32 or float64"):
            fvk._dtype_code(torch.float16)

    def test_sources_and_hash_of_the_fv_family(self):
        srcs = _build.sources("fv")
        assert [s.name for s in srcs] == [
            "fv_bicgstab.cu", "fv_host.cu", "fv_pressure.cu",
            "fv_common.cuh", "fv_phases.cuh"]
        assert _build._library_path("fv").name == "libfvkernels.so"
        assert _build._library_path("fv").parent.name == \
            _build._source_hash(srcs)

    def test_import_builds_nothing(self, repo_root):
        code = ("import anap3_tpu_torch.ops.fv_kernels, "
                "anap3_tpu_torch.models.fv; "
                "from anap3_tpu_torch.ops import _build; "
                "assert _build._libs == {}")
        proc = subprocess.run([sys.executable, "-c", code], cwd=repo_root,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr


class TestSolverPaths:
    """FVSolver's use_pallas: auto = fv_step on the CPU (the kernels on
    CUDA), true = the kernel wrappers, false = fv_step."""

    def solve(self, **over):
        kw = base(nx=10, ny=10, dtype="float64", tolerance=1e-3,
                  max_iterations=60, chunk_size=20)
        kw.update(over)
        fvk.reset_counts()
        s = TF.FVSolver(device="cpu", **kw)
        s.solve()
        return s, dict(fvk.PLAIN_CALLS)

    @pytest.mark.parametrize("use_pallas", ["auto", "false"])
    def test_fv_step_paths(self, use_pallas):
        s, calls = self.solve(use_pallas=use_pallas)
        assert s.metrics.iterations == 60
        assert not any(calls.values())

    def test_true_runs_the_chunk_wrapper(self):
        s, calls = self.solve(use_pallas="true")
        # 60 iterations in chunks of 20; the runner may launch one more
        # chunk speculatively before it reads the last one's flags
        assert calls["fv_chunk"] in (3, 4) and calls["fv_step"] == 0
        assert s.metrics.iterations == 60

    def test_true_under_residual_runs_the_step_wrapper(self):
        s, calls = self.solve(use_pallas="true",
                              convergence_metric="residual",
                              max_iterations=12, chunk_size=6)
        assert calls["fv_chunk"] == 0 and calls["fv_step"] >= 12
        assert s.metrics.iterations == 12

    def test_true_on_an_unsupported_config_raises(self):
        with pytest.raises(ValueError, match="MUSCL-sharp"):
            self.solve(use_pallas="true", limiter="MUSCL-sharp")

    def test_auto_on_cuda_with_an_unsupported_config_warns(self, caplog):
        """Auto on the card runs fv_step for MUSCL-sharp, with a warning,
        counted in PLAIN_CALLS["fv_unfused"] (the device is only read)."""
        s = TF.FVSolver(device="cpu", **base(nx=8, ny=8, dtype="float64",
                                             limiter="MUSCL-sharp"))
        s.device = torch.device("cuda")
        fvk.reset_counts()
        with caplog.at_level(logging.WARNING):
            step, factory = s._fused_paths("rel_iter")
        assert factory is None
        assert any("unfused fv_step" in r.message for r in caplog.records)
        step(s.state)
        assert fvk.PLAIN_CALLS["fv_unfused"] == 1

    def test_kernel_path_matches_fv_step_in_float32(self):
        """use_pallas=true (the kernels' plain versions on the CPU) and
        false (fv_step, BiCGSTAB to tolerance) converge to the same flow:
        the fixed-K inner solve changes the path, not the fixed point."""
        kw = dict(dtype="float32", tolerance=1e-5, max_iterations=3000,
                  chunk_size=200)
        a, _ = self.solve(use_pallas="true", **kw)
        b, _ = self.solve(use_pallas="false", **kw)
        assert a.metrics.converged and b.metrics.converged
        for name in ("u", "v"):
            np.testing.assert_allclose(getattr(a.fields, name),
                                       getattr(b.fields, name), rtol=0,
                                       atol=2e-4, err_msg=name)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the FV kernels have no CPU mode")
    return torch.device("cuda")


def cuda_setup(ny, nx, dtype, scheme="TVD", Re=100.0):
    p = FVParameters(**base(nx=nx, ny=ny, Re=Re, convection_scheme=scheme,
                            device="cuda",
                            dtype="float64" if dtype == torch.float64
                            else "float32"))
    ops = TF.build_fv_ops(p)[0]
    assert ops.device.type == "cuda"
    return p, ops


def seeded_state(ops, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    ny, nx = ops.ny, ops.nx
    return tstate([scale * rng.standard_normal(s) for s in (
        (ny, nx),) * 3 + ((ny, nx - 1), (ny - 1, nx))], ops.device, ops.dtype)


def tol_of(dtype):
    return F64_TOL if dtype == torch.float64 else F32_TOL


def bicg_solutions(setups, states):
    """(lanes, 2, ny, nx): each lane's BiCGSTAB solution u*, v* from one
    lane-chunk iteration (its later phases read x and leave it alone)."""
    from anap3_tpu_torch.ops import fv_lane_kernels as fvl
    from anap3_tpu_torch.parallel.sweep import stack_states

    S_list = [fvk.statics(p, o) for p, o in setups]
    ops = setups[0][1]
    ws = fvl.run_lanes(S_list, ops, fvl.lane_statics(S_list),
                       stack_states(states), 0,
                       TR.fresh_carry(len(states), ops.dtype, ops.device),
                       1, 1e-30, 10, K, False)
    return ws["x"]


def rel_t(a, b):
    return rel(a.detach().cpu().double().numpy(),
               b.detach().cpu().double().numpy())


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("ny,nx", [(20, 20), (12, 16)])
    # float64 also with float32's one refinement step: its correction is
    # of the order of the float32 solve's rounding, so only the float64
    # bound can fail a wrong refinement residual or accumulating product
    @pytest.mark.parametrize("dtype,n_refine", [
        (torch.float32, None), (torch.float64, None), (torch.float64, 1)])
    @pytest.mark.parametrize("scheme", ["TVD", "Upwind"])
    def test_step_and_chunk_match_plain(self, cuda, ny, nx, dtype, n_refine,
                                        scheme):
        p, ops = cuda_setup(ny, nx, dtype, scheme)
        if n_refine is not None:
            ops = dataclasses.replace(ops, n_refine=n_refine)
        S = fvk.statics(p, ops)
        st = seeded_state(ops, ny * nx)
        fvk.reset_counts()
        s_k, m_k = fvk.make_fv_step(p, ops, K)(st)
        torch.cuda.synchronize()
        s_p, m_p = fvk.step_plain(S, st, K)
        for a, b in zip(s_k, s_p):
            assert rel_t(a, b) <= tol_of(dtype)
        for k in m_p:
            assert rel_t(m_k[k], m_p[k]) <= tol_of(dtype), k
        st0 = TF.initial_state(ops)
        run = fvk.make_fv_chunk_runner(p, ops, 32, 1e-30, 10, K)
        out_k = run(st0, 0, np.inf)
        out_p = fvk.chunk_plain(S, st0, 0, np.inf, 32, 1e-30, 10, K)
        assert [int(out_k[i]) for i in (1, 2, 3)] == [
            int(out_p[i]) for i in (1, 2, 3)]
        for a, b in zip(out_k[0], out_p[0]):
            assert rel_t(a, b) <= tol_of(dtype)
        for c in range(7):
            assert rel_t(out_k[4][:, c], out_p[4][:, c]) <= tol_of(dtype), c
        again = run(st0, 0, np.inf)  # fixed-order reductions: same bits
        assert all(torch.equal(a, b) for a, b in zip(out_k[0], again[0]))
        assert torch.equal(out_k[4], again[4])
        # one step and two chunks of 32 ran on the kernels, 2 launches an
        # iteration
        assert fvk.LAUNCHES == {"fv_bicgstab": 1 + 2 * 32,
                                "fv_pressure": 1 + 2 * 32}

    @pytest.mark.parametrize("ny,nx", [(20, 20), (12, 16)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_refinement_on_a_perturbed_solve_matches_plain(self, cuda, ny,
                                                           nx, dtype):
        """One refinement step after a pressure solve whose eigenvalue
        inverses are perturbed by up to 50%: the refinement residual and the
        accumulating product then move the state by far more than the
        bound, so a wrong one fails it."""
        p, ops = cuda_setup(ny, nx, dtype)
        ops = dataclasses.replace(ops, n_refine=1)
        S = fvk.statics(p, ops)
        inv = S["inv_lam"]
        S = dict(S, inv_lam=torch.as_tensor(
            perturbed(inv.cpu().numpy()), dtype=dtype, device=inv.device))
        st = seeded_state(ops, ny * nx)
        s_k, m_k = fvk._step_kernel(S, ops, st, K)
        s_p, m_p = fvk.step_plain(S, st, K)
        s_0, _ = fvk.step_plain(dict(S, n_refine=0), st, K)
        for a, b, c in zip(s_k, s_p, s_0):
            assert rel_t(a, b) <= tol_of(dtype)
            assert rel_t(c, b) > 10 * tol_of(dtype)
        for k in m_p:
            assert rel_t(m_k[k], m_p[k]) <= tol_of(dtype), k

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_chunk_converging_mid_chunk_matches_plain(self, cuda, dtype):
        p, ops = cuda_setup(12, 16, dtype)
        S = fvk.statics(p, ops)
        st = TF.initial_state(ops)
        probe = fvk.chunk_plain(S, st, 0, np.inf, 30, 1e-30, 10, K)[4]
        tol = float(probe[12:20, 0].min()) * (1 + 1e-3)
        out_k = fvk.make_fv_chunk_runner(p, ops, 30, tol, 10, K)(
            st, 0, np.inf)
        out_p = fvk.chunk_plain(S, st, 0, np.inf, 30, tol, 10, K)
        assert bool(out_p[3]) and 13 <= int(out_p[2]) <= 20
        assert [int(out_k[i]) for i in (1, 2, 3)] == [
            int(out_p[i]) for i in (1, 2, 3)]
        rk, rp = out_k[4].cpu().numpy(), out_p[4].cpu().numpy()
        np.testing.assert_array_equal(np.isnan(rk), np.isnan(rp))
        for a, b in zip(out_k[0], out_p[0]):
            assert rel_t(a, b) <= tol_of(dtype)

    def test_nan_state_diverges_like_plain(self, cuda):
        p, ops = cuda_setup(12, 16, torch.float64)
        st = TF.initial_state(ops)
        u = st.u.clone()
        u[4, 6] = float("nan")
        st = TF.FVState(u, *st[1:])
        out_k = fvk.make_fv_chunk_runner(p, ops, 6, 1e-3, 10, K)(
            st, 30, np.inf)
        out_p = fvk.chunk_plain(fvk.statics(p, ops), st, 30, np.inf, 6, 1e-3,
                                10, K)
        assert [int(out_k[i]) for i in (1, 2, 3)] == [1, 31, 0] == [
            int(out_p[i]) for i in (1, 2, 3)]
        assert torch.isnan(out_k[4]).all()

    def test_speculative_dispatch_keeps_the_converging_chunk(self, cuda):
        """Chunk k+1 is launched before chunk k's flags are read: it must
        write its own buffers, so a run converging in chunk k returns
        chunk k's frozen state."""
        p, ops = cuda_setup(12, 16, torch.float64)
        S = fvk.statics(p, ops)
        st = TF.initial_state(ops)
        probe = fvk.chunk_plain(S, st, 0, np.inf, 60, 1e-30, 10, K)[4]
        tol = float(probe[30:45, 0].min()) * (1 + 1e-6)
        results = []
        for factory in (
                lambda c, t, m: fvk.make_fv_chunk_runner(p, ops, c, t, 10, K),
                None):
            results.append(TR.run_fixed_point(
                lambda s: fvk.step_plain(S, s, K), lambda s: (s.u, s.v),
                st, tolerance=tol, max_iterations=120, chunk=30,
                chunk_runner=factory))
        kern, plain = results
        assert kern.converged and kern.iterations == plain.iterations
        assert 31 <= kern.iterations <= 45
        for a, b in zip(kern.state, plain.state):
            assert rel_t(a, b) <= F64_TOL

    @pytest.mark.parametrize("ny,nx", [(20, 20), (12, 16), (128, 128)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("lanes", [1, 3])
    def test_one_launch_solve_matches_plain_bicgstab(self, cuda, ny, nx,
                                                     dtype, lanes):
        """One BiCGSTAB solve a lane (one cooperative launch for all
        lanes) from seeded states, lanes at Re 100, 400, 1000: u*, v*
        against plain_bicgstab on the lane's assembled system, a repeat bit
        for bit, and each lane bit for bit its one-lane solve (the step
        entry)."""
        setups = [cuda_setup(ny, nx, dtype, Re=re)
                  for re in (100.0, 400.0, 1000.0)[:lanes]]
        states = [seeded_state(o, ny * nx + b)
                  for b, (_, o) in enumerate(setups)]
        x = bicg_solutions(setups, states)
        assert torch.equal(x, bicg_solutions(setups, states))
        for b, ((p, ops), st) in enumerate(zip(setups, states)):
            S = fvk.statics(p, ops)
            u, v, pr, mx, my = fvk.pad_state(st)
            us, vs = fvk.plain_bicgstab(
                fvk.plain_assemble(S, u, v, pr, mx, my), u, v, K)
            assert rel_t(x[b, 0], us) <= tol_of(dtype)
            assert rel_t(x[b, 1], vs) <= tol_of(dtype)
            assert torch.equal(x[b], fvk.bench_workspace(S, ops, st, K)["x"])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("lanes", [1, 3, 8])
    def test_launch_counters(self, cuda, dtype, lanes):
        """float32 (one refinement step of the pressure solve) and float64
        alike, for any number of lanes: 2 launches an iteration (the
        momentum launch with the assembly, the pressure launch with
        control), and none more a step or a chunk."""
        from anap3_tpu_torch.ops import fv_lane_kernels as fvl
        from anap3_tpu_torch.parallel.sweep import stack_states

        per_iter = {"fv_bicgstab": 1, "fv_pressure": 1}
        setups = [cuda_setup(12, 16, dtype, Re=(100.0, 400.0, 1000.0)[b % 3])
                  for b in range(lanes)]
        p, ops = setups[0]
        st = TF.initial_state(ops)
        if lanes == 1:
            fvk.reset_counts()
            fvk.make_fv_step(p, ops, K)(st)
            assert fvk.LAUNCHES == per_iter
            fvk.reset_counts()
            fvk.make_fv_chunk_runner(p, ops, 10, 1e-30, 10, K)(st, 0, np.inf)
            assert fvk.LAUNCHES == {k: 10 * n for k, n in per_iter.items()}
            assert not any(fvk.PLAIN_CALLS.values())
            return
        fvl.reset_counts()
        fvl.make_fv_lane_runner([q for q, _ in setups], [o for _, o in setups],
                                10, 1e-30, 10, K)(
            stack_states([TF.initial_state(o) for _, o in setups]), 0)
        assert fvl.LAUNCHES["fv_lanes"] == 10 * sum(per_iter.values())
        assert not any(fvl.PLAIN_CALLS.values())

    def test_state_on_another_device_raises(self, cuda):
        p, ops = cuda_setup(12, 16, torch.float32)
        cpu_state = tstate([np.zeros(s, np.float32) for s in (
            (12, 16),) * 3 + ((12, 15), (11, 16))])
        with pytest.raises(ValueError, match="expected cuda"):
            fvk.make_fv_step(p, ops, K)(cpu_state)

    def test_solver_runs_on_the_kernels_alone(self, cuda):
        fvk.reset_counts()
        s = TF.FVSolver(**base(nx=24, ny=24, device="cuda", tolerance=1e-4,
                               max_iterations=4000, chunk_size=500))
        s.solve()
        assert s.metrics.converged
        assert all(fvk.LAUNCHES[k] > 0 for k in fvk.KERNELS)
        assert not any(fvk.PLAIN_CALLS.values())
