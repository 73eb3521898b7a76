"""anap3_tpu_torch's runner against anap3_tpu's.

The plain chunk (``runner.make_chunk_runner`` over the port's ``sg_step``)
is held against the JAX ``make_chunk_runner`` over the JAX ``sg_step`` at
N=16, chunk=30, float64 on the CPU: ``done``, ``conv_iter`` and
``converged`` equal, rows within 1e-12 relative per column with equal NaN
positions. ``run_fixed_point`` is held against the JAX one on whole solves
(iterations, flags and histories), and the speculative dispatch is checked
to return the state of the converging chunk, not of the one after it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anap3_tpu.models import runner as JR
from anap3_tpu.models import spectral_sg as J
from anap3_tpu.models.params import SpectralParameters as JaxParameters
from anap3_tpu_torch.models import runner as TR
from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.ops import sg_kernels as sgk

torch.set_num_threads(1)

N, CHUNK = 16, 30


def both(n=N, Re=100.0, corner="smoothing"):
    kw = dict(Re=Re, nx=n, ny=n, dtype="float64", corner_treatment=corner,
              basis_type="chebyshev", CFL=1.5)
    jops, _ = J.build_spectral_ops(JaxParameters(**kw))
    tops, _ = T.build_spectral_ops(SpectralParameters(device="cpu", **kw))
    return jops, tops


def run_both(jops, tops, tol, metric, u=None, start=0):
    js = J.initial_state(jops)
    ts = T.initial_state(tops)
    if u is not None:
        js = js._replace(u=jnp.asarray(u))
        ts = ts._replace(u=torch.as_tensor(u))
    jrun = JR.make_chunk_runner(lambda s: J.sg_step(jops, s),
                                lambda s: (s.u, s.v), CHUNK, tol, 10, metric)
    trun = TR.make_chunk_runner(lambda s: T.sg_step(tops, s),
                                lambda s: (s.u, s.v), CHUNK, tol, 10, metric)
    jout = jrun(js, jnp.int32(start), jnp.asarray(np.inf))
    tout = trun(ts, start, torch.tensor(np.inf, dtype=torch.float64))
    return jout, tout


def assert_rows_match(trows, jrows, rtol=1e-12):
    trows = trows.numpy() if isinstance(trows, torch.Tensor) else trows
    jrows = np.asarray(jrows)
    np.testing.assert_array_equal(np.isnan(trows), np.isnan(jrows))
    for c in range(jrows.shape[1]):
        fin = np.isfinite(jrows[:, c])
        if fin.any():
            scale = np.max(np.abs(jrows[fin, c]))
            err = np.max(np.abs(trows[fin, c] - jrows[fin, c]))
            assert err <= rtol * scale, (c, err, scale)


def assert_flags_match(tout, jout):
    assert bool(tout[1]) == bool(jout[1])
    assert int(tout[2]) == int(jout[2])
    assert bool(tout[3]) == bool(jout[3])


def mid_chunk_tol(rows, col, ref=None):
    """A tolerance the criterion first meets inside [10, 20): the rows'
    minimum there, nudged up."""
    vals = np.asarray(rows)[10:20, col] / (1.0 if ref is None else ref)
    return float(vals.min()) * (1 + 1e-6)


class TestChunkRunnerParity:
    @pytest.mark.parametrize("metric", ["rel_iter", "residual"])
    def test_unconverged_chunk(self, metric):
        jops, tops = both()
        jout, tout = run_both(jops, tops, 1e-30, metric)
        assert_flags_match(tout, jout)
        assert not bool(tout[1])
        assert_rows_match(tout[4], jout[4])
        for a, b in zip(tout[0], jout[0]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-12)

    @pytest.mark.parametrize("metric", ["rel_iter", "residual"])
    def test_converges_mid_chunk(self, metric):
        jops, tops = both()
        probe, _ = run_both(jops, tops, 1e-30, metric)
        rows = np.asarray(probe[4])
        if metric == "rel_iter":
            tol = mid_chunk_tol(rows, 0)
        else:
            tol = mid_chunk_tol(rows, 3, ref=rows[10, 3])
        jout, tout = run_both(jops, tops, tol, metric)
        assert_flags_match(tout, jout)
        assert bool(tout[3]) and 11 <= int(tout[2]) <= 20
        assert_rows_match(tout[4], jout[4])
        assert np.isnan(tout[4].numpy()[int(tout[2]):]).all()
        if metric == "residual":
            assert float(tout[5]) == pytest.approx(float(jout[5]), rel=1e-12)

    def test_nan_injection_diverges(self):
        jops, tops = both()
        u = np.asarray(J.initial_state(jops).u).copy()
        u[5, 7] = np.nan
        jout, tout = run_both(jops, tops, 1e-3, "rel_iter", u=u, start=40)
        assert_flags_match(tout, jout)
        assert bool(tout[1]) and not bool(tout[3]) and int(tout[2]) == 41
        assert_rows_match(tout[4], jout[4])
        assert np.isnan(tout[4].numpy()).all()


class TestRunFixedPoint:
    @pytest.mark.parametrize("metric,tol", [("rel_iter", 1e-3),
                                            ("residual", 1e-2),
                                            ("energy", 1e-3)])
    def test_matches_jax(self, metric, tol):
        jops, tops = both(n=12)
        jres = JR.run_fixed_point(lambda s: J.sg_step(jops, s),
                                  lambda s: (s.u, s.v), J.initial_state(jops),
                                  tolerance=tol, max_iterations=3000,
                                  chunk=40, convergence_metric=metric,
                                  energy_plateau_chunks=3)
        tres = TR.run_fixed_point(lambda s: T.sg_step(tops, s),
                                  lambda s: (s.u, s.v), T.initial_state(tops),
                                  tolerance=tol, max_iterations=3000,
                                  chunk=40, convergence_metric=metric,
                                  energy_plateau_chunks=3)
        assert tres.converged and tres.converged == jres.converged
        assert tres.iterations == jres.iterations
        assert tres.diverged == jres.diverged
        np.testing.assert_array_equal(tres.history_iters, jres.history_iters)
        for k in TR.METRIC_KEYS:
            np.testing.assert_allclose(tres.history[k], jres.history[k],
                                       rtol=1e-10, err_msg=k)
        np.testing.assert_allclose(tres.state.u.numpy(),
                                   np.asarray(jres.state.u), atol=1e-12)

    def test_history_decimation_and_stall_match_jax(self):
        jops, tops = both(n=12)
        kw = dict(tolerance=1e-14, max_iterations=900, chunk=50,
                  max_history_points=100, stall_chunks=2)
        jres = JR.run_fixed_point(lambda s: J.sg_step(jops, s),
                                  lambda s: (s.u, s.v), J.initial_state(jops),
                                  **kw)
        tres = TR.run_fixed_point(lambda s: T.sg_step(tops, s),
                                  lambda s: (s.u, s.v), T.initial_state(tops),
                                  **kw)
        assert (tres.iterations, tres.stalled, tres.converged) == (
            jres.iterations, jres.stalled, jres.converged)
        np.testing.assert_array_equal(tres.history_iters, jres.history_iters)
        assert len(tres.history["rel_iter"]) <= 2 * 100 + 1

    def test_speculative_dispatch_keeps_the_converging_chunk(self):
        """Convergence inside chunk 2 of 3: the result is the state frozen
        at conv_iter, although chunk 3 was dispatched before chunk 2's flags
        were read."""
        _, tops = both(n=12)
        probe = sgk.chunk_plain(tops, T.initial_state(tops), 0, np.inf, 60,
                                1e-30, 10, False, 16)
        tol = float(probe[4][45, 0]) * (1 + 1e-9)
        calls = []

        def factory(chunk, tol_, metric_):
            run = sgk.make_sg_chunk_runner(tops, chunk, tol_, 10, metric_, 16)

            def counted(state, start, ref):
                calls.append(start)
                return run(state, start, ref)
            return counted

        res = TR.run_fixed_point(None, lambda s: (s.u, s.v),
                                 T.initial_state(tops), tolerance=tol,
                                 max_iterations=90, chunk=30,
                                 chunk_runner=factory)
        assert res.converged and 31 <= res.iterations <= 46
        assert calls == [0, 30, 60]  # chunk 3 was speculated
        state = T.initial_state(tops)
        for _ in range(res.iterations):
            state, _ = T.rk4_step(tops, state)
        for a, b in zip(res.state, state):
            assert torch.equal(a, b)


class TestIterationCap:
    """A cap that is not a multiple of the chunk: the last chunk runs only
    the steps left below it (the JAX runner runs it whole and reports the
    cap). Cap 300 with chunk 200 must give the bits of chunk 100."""

    @staticmethod
    def sg_solve(tops, chunk, factory=None, cap=300):
        return TR.run_fixed_point(lambda s: T.sg_step(tops, s),
                                  lambda s: (s.u, s.v), T.initial_state(tops),
                                  tolerance=1e-30, max_iterations=cap,
                                  chunk=chunk, chunk_runner=factory)

    @pytest.mark.parametrize("path", ["generic", "sg_chunk_runner"])
    def test_sg_stops_at_its_cap(self, path):
        _, tops = both(n=12)
        lengths = []

        def factory(chunk, tol_, metric_):
            lengths.append(chunk)
            return sgk.make_sg_chunk_runner(tops, chunk, tol_, 10, metric_)

        fac = factory if path == "sg_chunk_runner" else None
        a = self.sg_solve(tops, 200, fac)
        b = self.sg_solve(tops, 100, fac)
        assert a.iterations == b.iterations == 300
        assert not a.converged and not a.diverged
        for x, y in zip(a.state, b.state):
            assert torch.equal(x, y)
        np.testing.assert_array_equal(a.history_iters, b.history_iters)
        state = T.initial_state(tops)
        for _ in range(300):
            state, _ = T.rk4_step(tops, state)
        for x, y in zip(a.state, state):
            assert torch.equal(x, y)
        if fac is not None:
            assert lengths == [200, 100, 100]

    def test_fv_stops_at_its_cap(self):
        from anap3_tpu_torch.models import fv as TFV
        from anap3_tpu_torch.models.params import FVParameters

        out = []
        for chunk in (20, 10):
            solver = TFV.FVSolver(params=FVParameters(
                device="cpu", Re=100.0, nx=16, ny=16, dtype="float64",
                tolerance=1e-30, max_iterations=30, chunk_size=chunk))
            solver.solve()
            out.append(solver)
        a, b = out
        assert a.metrics.iterations == b.metrics.iterations == 30
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(a.state, name), getattr(b.state, name))

    def test_sweep_stops_at_its_cap(self):
        from anap3_tpu_torch.parallel import sweep as TS

        tops = [both(n=12, Re=Re)[1] for Re in (100.0, 400.0)]
        out = []
        for chunk in (200, 100):
            states = TS.stack_states([T.initial_state(o) for o in tops])
            out.append(TS.run_batched_sweep(
                T.sg_step, lambda s: (s.u, s.v), TS.stack_ops(tops), states,
                tolerance=1e-30, max_iterations=300, chunk=chunk))
        a, b = out
        np.testing.assert_array_equal(a.iterations, [300, 300])
        np.testing.assert_array_equal(b.iterations, [300, 300])
        for x, y in zip(a.states, b.states):
            assert torch.equal(x, y)
        for k, o in enumerate(tops):
            state = T.initial_state(o)
            for _ in range(300):
                state, _ = T.rk4_step(o, state)
            for x, y in zip(a.states, state):
                assert torch.equal(x[k], y)
