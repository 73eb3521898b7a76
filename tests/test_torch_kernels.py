"""The SG kernel wrappers of anap3_tpu_torch (ops/sg_kernels.py).

On the CPU (every run): the wrappers' plain versions against the Pallas TPU
kernels themselves, run as their own tests run them (``interpret=True``,
float32, x6 = full-f32 products), and the wrappers' checks and dispatch.
Tolerance 1e-4 relative per field or per column: both sides are float32
and sum in different orders. Rows are compared where both sides sampled
their quadratures (the port follows the aligned kernel's cadence
``(i == 0) | (idx % M == 0)``; the aligned kernel also holds its residual
norms between samples under rel_iter, the port's are exact every step).

On a CUDA card (marker ``gpu``): every CUDA kernel against its plain
version on the same device tensors, relative error <= 1e-11 in float64 and
<= 1e-4 in float32, flags equal. Run them there with
``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``
(tests/conftest.py imports JAX, which that machine lacks). Without a card
these tests skip, saying so.
"""

import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import runner as TR
from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.ops import _build
from anap3_tpu_torch.ops import sg_kernels as sgk

torch.set_num_threads(1)

F32_TOL = 1e-4
F64_TOL = 1e-11


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: imported here, not at module level, because the
    card's machine has no JAX and runs only the ``gpu`` tests of this file
    (with ``--noconftest``: tests/conftest.py imports JAX too)."""
    import jax.numpy as jnp
    from anap3_tpu.models import spectral_sg as J
    from anap3_tpu.models.params import SpectralParameters as JaxParameters
    from anap3_tpu.ops.pallas_aligned import make_aligned_chunk_runner
    from anap3_tpu.ops.pallas_tiled import (make_tiled_chunk_runner,
                                            make_tiled_sg_step)

    def f32_ops(n, corner="smoothing", Re=400.0):
        p = JaxParameters(Re=Re, nx=n, ny=n, dtype="float32",
                          basis_type="chebyshev", CFL=1.5,
                          corner_treatment=corner)
        return J.build_spectral_ops(p, dtype=jnp.float32)[0]

    def chunk(runner, jops):
        return runner(J.initial_state(jops), jnp.int32(0),
                      jnp.float32(np.inf))

    return SimpleNamespace(jnp=jnp, J=J, f32_ops=f32_ops, chunk=chunk,
                           aligned=make_aligned_chunk_runner,
                           tiled=make_tiled_chunk_runner,
                           tiled_step=make_tiled_sg_step)


def rel_cols(a, b):
    """Largest per-column error relative to the column's max."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    err = 0.0
    for c in range(b.shape[1]):
        scale = max(np.max(np.abs(b[:, c])), 1e-30)
        err = max(err, np.max(np.abs(a[:, c] - b[:, c])) / scale)
    return err


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def port_chunk(jx, jops, chunk, tol, metric, m_every):
    ops = T.ops_from_jax(jops, "cpu", torch.float32)
    st = T.state_from_numpy(jx.J.initial_state(jops), "cpu", torch.float32)
    run = sgk.make_sg_chunk_runner(ops, chunk, tol, 10, metric, m_every)
    return run(st, 0, np.inf)


def assert_flags(tout, jout):
    assert (bool(tout[1]), int(tout[2]), bool(tout[3])) == (
        bool(jout[1]), int(jout[2]), bool(jout[3]))


class TestAgainstPallas:
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_chunk_matches_aligned_kernel(self, jx, corner):
        """N=32 (aligned tier), 20 steps, metrics_every=16."""
        jops = jx.f32_ops(32, corner)
        chunk, m = 20, 16
        jrun = jx.aligned(jops, chunk, 1e-30, 10,
                                         interpret=True, algorithm="x6",
                                         metrics_every=m)
        jout = jx.chunk(jrun, jops)
        tout = port_chunk(jx, jops, chunk, 1e-30, "rel_iter", m)
        assert_flags(tout, jout)
        for a, b in zip(tout[0], jout[0]):
            assert rel(a.numpy(), b) <= F32_TOL
        trows, jrows = tout[4].numpy(), np.asarray(jout[4])
        assert trows.dtype == np.float32
        assert rel_cols(trows[:, :1], jrows[:, :1]) <= F32_TOL
        sampled = [i for i in range(chunk) if i == 0 or i % m == 0]
        assert rel_cols(trows[sampled], jrows[sampled]) <= F32_TOL

    def test_convergence_flags_match_aligned_kernel(self, jx):
        jops = jx.f32_ops(32)
        probe = jx.chunk(jx.aligned(
            jops, 20, 1e-30, 10, interpret=True, algorithm="x6",
            metrics_every=16), jops)
        tol = float(np.asarray(probe[4])[10:16, 0].min()) * 1.001
        jout = jx.chunk(jx.aligned(
            jops, 20, tol, 10, interpret=True, algorithm="x6",
            metrics_every=16), jops)
        tout = port_chunk(jx, jops, 20, tol, "rel_iter", 16)
        assert bool(jout[3]) and 11 <= int(jout[2]) <= 16
        assert_flags(tout, jout)
        for a, b in zip(tout[0], jout[0]):
            assert rel(a.numpy(), b) <= F32_TOL

    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    @pytest.mark.parametrize("metric", ["rel_iter", "residual"])
    def test_chunk_matches_tiled_kernel(self, jx, corner, metric):
        """N=20 (nf=21, ni=19: no tile multiple), 8 steps; both sides
        sample the quadratures at idx 0 and 4."""
        jops = jx.f32_ops(20, corner)
        chunk, m = 8, 4
        jrun = jx.tiled(jops, chunk, 1e-30, 10,
                                       interpret=True, algorithm="x6",
                                       convergence_metric=metric,
                                       metrics_every=m)
        jout = jx.chunk(jrun, jops)
        tout = port_chunk(jx, jops, chunk, 1e-30, metric, m)
        assert_flags(tout, jout)
        for a, b in zip(tout[0], jout[0]):
            assert rel(a.numpy(), b) <= F32_TOL
        trows, jrows = tout[4].numpy(), np.asarray(jout[4])
        assert rel_cols(trows[:, :4], jrows[:, :4]) <= F32_TOL
        assert rel_cols(trows[::m], jrows[::m]) <= F32_TOL

    @pytest.mark.parametrize("with_tau", [False, True])
    def test_step_matches_tiled_step(self, jx, with_tau):
        jops = jx.f32_ops(20, "singular")
        ops = T.ops_from_jax(jops, "cpu", torch.float32)
        rng = np.random.default_rng(4)
        nf = 21
        shapes = ((nf, nf), (nf, nf), (nf - 2, nf - 2))
        u, v, p = (0.05 * rng.standard_normal(s) for s in shapes)
        jnp = jx.jnp
        jst = jx.J.SpectralState(*(jnp.asarray(a, jnp.float32)
                                   for a in (u, v, p)))
        tst = T.state_from_numpy((u, v, p), "cpu", torch.float32)
        jstep = jx.tiled_step(jops, interpret=True, algorithm="x6",
                                   with_tau=with_tau)
        tstep = sgk.make_sg_step(ops, with_tau=with_tau)
        if with_tau:
            tau = [0.01 * rng.standard_normal(s) for s in shapes]
            js, jm = jstep(jst, tuple(jnp.asarray(a, jnp.float32) for a in tau))
            ts, tm = tstep(tst, tuple(torch.as_tensor(a, dtype=torch.float32)
                                      for a in tau))
        else:
            js, jm = jstep(jst)
            ts, tm = tstep(tst)
        for a, b in zip(ts, js):
            assert rel(a.numpy(), b) <= F32_TOL
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=F32_TOL)


class TestWrappers:
    def ops(self, n=12, dtype=torch.float64):
        p = SpectralParameters(device="cpu", nx=n, ny=n, dtype="float64")
        return T.build_spectral_ops(p, dtype=dtype)[0]

    def test_cpu_tensors_take_the_plain_versions(self):
        ops = self.ops()
        st = T.initial_state(ops)
        sgk.reset_counts()
        s1, m1 = sgk.make_sg_step(ops)(st)
        s2, m2 = T.sg_step(ops, st)
        assert all(torch.equal(a, b) for a, b in zip(s1, s2))
        assert all(torch.equal(m1[k], m2[k]) for k in m2)
        sgk.make_sg_chunk_runner(ops, 4, 1e-30)(st, 0, np.inf)
        s3, m3 = sgk.make_sg_smoother(ops)(st, None, 2)
        s4, m4 = T.sg_step(ops, T.sg_step(ops, st)[0])
        assert all(torch.equal(a, b) for a, b in zip(s3, s4))
        assert all(torch.equal(m3[k], m4[k]) for k in m4)
        assert sgk.PLAIN_CALLS == {"sg_step": 1, "sg_chunk": 1,
                                   "sg_smooth": 1}
        assert sgk.LAUNCHES == {k: 0 for k in sgk.KERNELS}
        sgk.reset_counts()
        assert sgk.PLAIN_CALLS == {"sg_step": 0, "sg_chunk": 0,
                                   "sg_smooth": 0}

    def test_plain_chunk_matches_generic_runner_rel_iter(self):
        """With metrics every step, the kernel's plain chunk is the generic
        plain chunk over sg_step."""
        ops = self.ops()
        st = T.initial_state(ops)
        a = sgk.chunk_plain(ops, st, 0, np.inf, 25, 1e-30, 10, False, 1)
        b = TR.make_chunk_runner(lambda s: T.sg_step(ops, s),
                                 lambda s: (s.u, s.v), 25, 1e-30)(
            st, 0, torch.tensor(np.inf, dtype=torch.float64))
        torch.testing.assert_close(a[4], b[4], rtol=1e-13, atol=0)
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))

    def test_held_quadratures_follow_the_cadence(self):
        ops = self.ops()
        rows = sgk.chunk_plain(ops, T.initial_state(ops), 5, np.inf, 19,
                               1e-30, 10, False, 8)[4].numpy()
        # sampled at i=0 (idx 5), idx 8 and idx 16; held in between
        for lo, hi in ((0, 3), (3, 11), (11, 19)):
            assert (rows[lo:hi, 4:] == rows[lo, 4:]).all()
        assert not (rows[3, 4:] == rows[2, 4:]).all()
        assert len(np.unique(rows[:, 1])) == 19  # residuals every step

    def test_checks_dtype_shape_contiguity(self):
        ops = self.ops()
        step = sgk.make_sg_step(ops)
        st = T.initial_state(ops)
        with pytest.raises(TypeError, match="dtype"):
            step(T.SpectralState(st.u.float(), st.v, st.p))
        with pytest.raises(ValueError, match="shape"):
            step(T.SpectralState(st.u, st.v, st.u))
        with pytest.raises(ValueError, match="contiguous"):
            step(T.SpectralState(st.u.T, st.v, st.p))
        with pytest.raises(ValueError, match="mapped criterion"):
            sgk.make_sg_chunk_runner(ops, 4, 1e-3, convergence_metric="energy")
        with pytest.raises(TypeError, match="float32 or float64"):
            sgk._dtype_code(torch.float16)
        with pytest.raises(ValueError, match="n_steps"):
            sgk.make_sg_smoother(ops)(st, None, 0)
        with pytest.raises(ValueError, match="shape"):
            sgk.make_sg_smoother(ops)(st, (st.u, st.v, st.u), 1)

    def test_build_needs_nvcc(self, monkeypatch):
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build._nvcc()

    def test_source_hash_follows_the_sources(self, tmp_path):
        srcs = _build.sources("sg")
        assert [s.name for s in srcs] == [
            "sg_control.cu", "sg_diag.cu", "sg_host.cu", "sg_resident.cu",
            "sg_stage.cu", "sg_common.cuh"]
        h = _build._source_hash(srcs)
        edited = tmp_path / srcs[0].name
        edited.write_bytes(srcs[0].read_bytes() + b"\n// edit\n")
        assert _build._source_hash([edited] + srcs[1:]) != h
        # an FV edit leaves the SG library's key alone
        assert _build._library_path("sg").parent.name == h
        assert _build._library_path("fv") != _build._library_path("sg")
        with pytest.raises(ValueError, match="unknown kernel family"):
            _build.sources("xx")

    def test_import_builds_nothing(self, repo_root):
        code = ("import anap3_tpu_torch.ops.sg_kernels, "
                "anap3_tpu_torch.models.spectral as s; "
                "from anap3_tpu_torch.ops import _build; "
                "assert _build._libs == {}")
        proc = subprocess.run([sys.executable, "-c", code], cwd=repo_root,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SG kernels have no CPU mode")
    return torch.device("cuda")


def cuda_ops(n, dtype, corner="smoothing", Re=1000.0):
    p = SpectralParameters(Re=Re, nx=n, ny=n, basis_type="chebyshev",
                           CFL=1.5, corner_treatment=corner, device="cuda",
                           dtype="float64" if dtype == torch.float64
                           else "float32")
    return T.build_spectral_ops(p)[0]


def random_state(ops, seed):
    rng = np.random.default_rng(seed)
    nf = ops.nf
    st = T.state_from_numpy(tuple(0.05 * rng.standard_normal(s) for s in (
        (nf, nf), (nf, nf), (nf - 2, nf - 2))), ops.device, ops.dtype)
    u, v = T.enforce_bc(ops, st.u, st.v)
    return T.SpectralState(u, v, st.p)


def tol_of(dtype):
    return F64_TOL if dtype == torch.float64 else F32_TOL


def rel_t(a, b):
    return rel(a.detach().cpu().double().numpy(),
               b.detach().cpu().double().numpy())


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("n", [20, 48])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    @pytest.mark.parametrize("with_tau", [False, True])
    def test_step_matches_plain(self, cuda, n, dtype, corner, with_tau):
        ops = cuda_ops(n, dtype, corner)
        st = random_state(ops, n)
        tau = None
        if with_tau:
            tau = tuple(0.2 * t for t in random_state(ops, n + 1))
            s_k, m_k = sgk.make_sg_step(ops, with_tau=True)(st, tau)
        else:
            s_k, m_k = sgk.make_sg_step(ops)(st)
        torch.cuda.synchronize()
        s_p, m_p = sgk.step_plain(ops, st, tau)
        for a, b in zip(s_k, s_p):
            assert rel_t(a, b) <= tol_of(dtype)
        for k in m_p:
            assert rel_t(m_k[k], m_p[k]) <= tol_of(dtype), k

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("metric", ["rel_iter", "residual"])
    def test_chunk_converging_mid_chunk_matches_plain(self, cuda, dtype,
                                                      metric):
        ops = cuda_ops(20, dtype, Re=100.0)
        st = T.initial_state(ops)
        probe = sgk.chunk_plain(ops, st, 0, np.inf, 40, 1e-30, 10,
                                metric == "residual", 16)[4].cpu().numpy()
        col = 0 if metric == "rel_iter" else 3
        crit = probe[:, col] / (1.0 if col == 0 else probe[10, 3])
        tol = float(crit[10:25].min()) * (1 + 1e-3)
        out_k = sgk.make_sg_chunk_runner(ops, 40, tol, 10, metric, 16)(
            st, 0, np.inf)
        out_p = sgk.chunk_plain(ops, st, 0, np.inf, 40, tol, 10,
                                metric == "residual", 16)
        assert bool(out_p[3]) and 11 <= int(out_p[2]) <= 25
        assert [int(out_k[i]) for i in (1, 2, 3)] == [
            int(out_p[i]) for i in (1, 2, 3)]
        rk, rp = out_k[4].cpu().numpy(), out_p[4].cpu().numpy()
        np.testing.assert_array_equal(np.isnan(rk), np.isnan(rp))
        fin = np.isfinite(rp)
        assert rel_cols(np.where(fin, rk, 0), np.where(fin, rp, 0)) <= \
            tol_of(dtype)
        for a, b in zip(out_k[0], out_p[0]):
            assert rel_t(a, b) <= tol_of(dtype)

    def test_nan_state_diverges_like_plain(self, cuda):
        ops = cuda_ops(20, torch.float64)
        st = T.initial_state(ops)
        u = st.u.clone()
        u[4, 6] = float("nan")
        st = T.SpectralState(u, st.v, st.p)
        out_k = sgk.make_sg_chunk_runner(ops, 8, 1e-3)(st, 30, np.inf)
        out_p = sgk.chunk_plain(ops, st, 30, np.inf, 8, 1e-3, 10, False, 16)
        assert [int(out_k[i]) for i in (1, 2, 3)] == [1, 31, 0] == [
            int(out_p[i]) for i in (1, 2, 3)]
        assert torch.isnan(out_k[4]).all()
        # the diverging step is committed (runner.make_chunk_runner freezes
        # only the steps after it): both hold its NaN state
        for a, b in zip(out_k[0], out_p[0]):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert torch.isnan(a).any()

    def test_speculative_dispatch_keeps_the_converging_chunk(self, cuda):
        """Chunk k+1 is launched before chunk k's flags are read: it must
        write its own buffers, so a run converging in chunk k returns
        chunk k's frozen state."""
        ops = cuda_ops(20, torch.float64, Re=100.0)
        st = T.initial_state(ops)
        probe = sgk.chunk_plain(ops, st, 0, np.inf, 60, 1e-30, 10, False,
                                16)[4].cpu().numpy()
        tol = float(probe[30:45, 0].min()) * (1 + 1e-6)
        results = []
        for factory in (
                lambda c, t, m: sgk.make_sg_chunk_runner(ops, c, t, 10, m),
                None):
            results.append(TR.run_fixed_point(
                lambda s: sgk.step_plain(ops, s), lambda s: (s.u, s.v), st,
                tolerance=tol, max_iterations=120, chunk=30,
                chunk_runner=factory))
        kern, plain = results
        assert kern.converged and kern.iterations == plain.iterations
        assert 31 <= kern.iterations <= 45
        for a, b in zip(kern.state, plain.state):
            assert rel_t(a, b) <= F64_TOL

    def test_launch_counters(self, cuda):
        ops = cuda_ops(20, torch.float32)
        st = T.initial_state(ops)
        sgk.reset_counts()
        sgk.make_sg_step(ops)(st)
        # dt, one stage launch per RK stage, and the tail kernel (the
        # quadratures and the metrics)
        assert sgk.LAUNCHES == {"sg_stage": 4, "sg_diag": 2, "sg_control": 0,
                                "sg_stage_x1": 0, "sg_diag_x1": 0,
                                "sg_resident": 0}
        sgk.reset_counts()
        sgk.make_sg_chunk_runner(ops, 20, 1e-30, 10, "rel_iter", 16)(
            st, 0, np.inf)
        # N=20 is an order of the resident geometry: the whole chunk in
        # one launch, no dt of its own
        assert sgk.LAUNCHES == {"sg_stage": 0, "sg_diag": 0,
                                "sg_control": 0, "sg_stage_x1": 0,
                                "sg_diag_x1": 0, "sg_resident": 1}
        assert sgk.PART_LAUNCHES == {"dt_kernel": 0}
        # past it (N=64) the multi-launch chunk: 5 launches a step, 4
        # stages and one tail; the 2 sampled steps (i=0, idx=16) take the
        # tail kernel, the 18 others control; dt once, at the chunk's
        # first step
        wide = cuda_ops(64, torch.float32)
        assert sgk.resident_geometry(wide.nf, wide.dtype) is None
        sgk.reset_counts()
        sgk.make_sg_chunk_runner(wide, 20, 1e-30, 10, "rel_iter", 16)(
            T.initial_state(wide), 0, np.inf)
        assert sgk.LAUNCHES == {"sg_stage": 80, "sg_diag": 3,
                                "sg_control": 18, "sg_stage_x1": 0,
                                "sg_diag_x1": 0, "sg_resident": 0}
        assert sgk.PART_LAUNCHES == {"dt_kernel": 1}
        assert sgk.PLAIN_CALLS == {"sg_step": 0, "sg_chunk": 0,
                                   "sg_smooth": 0}
        sgk.reset_counts()
        sgk.make_sg_smoother(ops)(st, None, 5)
        # 4 launches a step (the stages; each step after the first takes
        # its dt from the partials the last stage left), dt at the first
        # step and the tail kernel at the end: 4 n + 2
        assert sgk.LAUNCHES == {"sg_stage": 20, "sg_diag": 2,
                                "sg_control": 0, "sg_stage_x1": 0,
                                "sg_diag_x1": 0, "sg_resident": 0}
        assert sgk.PART_LAUNCHES == {"dt_kernel": 1}
        assert sgk.PLAIN_CALLS == {"sg_step": 0, "sg_chunk": 0,
                                   "sg_smooth": 0}

    @pytest.mark.parametrize("n", [20, 48])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    @pytest.mark.parametrize("n_steps", [1, 2, 5])
    def test_smoother_matches_plain(self, cuda, n, dtype, corner, n_steps):
        """The smoothing loop against its plain version, forced by a tau
        that is zero on the velocity boundary ring (as a V-cycle's is), and
        unforced."""
        ops = cuda_ops(n, dtype, corner)
        st = random_state(ops, n)
        ring = ops.interior.to(dtype)
        tu, tv, tp = random_state(ops, n + 1)
        tau = (0.2 * tu * ring, 0.2 * tv * ring, 0.2 * tp)
        for forcing in (tau, None):
            s_k, m_k = sgk.make_sg_smoother(ops)(st, forcing, n_steps)
            torch.cuda.synchronize()
            s_p, m_p = sgk.smooth_plain(ops, st, forcing, n_steps)
            for a, b in zip(s_k, s_p):
                assert rel_t(a, b) <= tol_of(dtype)
            for k in m_p:
                assert rel_t(m_k[k], m_p[k]) <= tol_of(dtype), k

    def test_smoother_leaves_its_input_and_returns_fresh_tensors(self, cuda):
        ops = cuda_ops(20, torch.float64)
        st = random_state(ops, 3)
        kept = [t.clone() for t in st]
        smooth = sgk.make_sg_smoother(ops)
        a, _ = smooth(st, None, 3)
        b, _ = smooth(st, None, 3)
        for x, y, z in zip(st, kept, a):
            assert torch.equal(x, y)
            assert x.data_ptr() != z.data_ptr()
        for x, y in zip(a, b):
            assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()

    @pytest.mark.parametrize("x1", [False, True])
    def test_capped_solve_stops_at_its_cap(self, cuda, x1):
        """A cap that is no multiple of the chunk: the kernel chunk of the
        remainder runs, and the state is the state at the cap (chunk 200
        gives the bits of chunk 100 at cap 300)."""
        ops = cuda_ops(32, torch.float32, Re=100.0)
        out = []
        for chunk in (200, 100):
            out.append(TR.run_fixed_point(
                None, lambda s: (s.u, s.v), T.initial_state(ops),
                tolerance=1e-30, max_iterations=300, chunk=chunk,
                chunk_runner=lambda c, t, m: sgk.make_sg_chunk_runner(
                    ops, c, t, 10, m, 16, x1=x1)))
        a, b = out
        assert a.iterations == b.iterations == 300
        for x, y in zip(a.state, b.state):
            assert torch.equal(x, y)

    def test_state_on_another_device_raises(self, cuda):
        ops = cuda_ops(20, torch.float32)
        st = T.state_to_numpy(T.initial_state(ops))
        cpu_state = T.state_from_numpy(st, "cpu", torch.float32)
        with pytest.raises(ValueError, match="expected cuda"):
            sgk.make_sg_step(ops)(cpu_state)
