"""Batched parameter sweeps of anap3_tpu_torch (parallel/sweep.py) against
anap3_tpu.parallel.sweep (FSG sweeps and the batched entry:
tests/test_torch_fsg_sweep.py).

Every comparison runs on the CPU in float64 with the same operators on both
sides (``ops_from_jax``), through the plain batched path (the port's
counterpart of the vmapped XLA chunk). Bounds: states within 1e-12
relative, history rows within 1e-10 relative per metric, iterations and
flags equal.

Two documented differences from the JAX package are tested as such:

- a lane that converged in an earlier chunk stays frozen with its own
  iteration count; the JAX batched chunk restarts every chunk with no lane
  done, so such a lane takes one more step per later chunk and reports the
  first step of the last chunk as its iterations;
- ``convergence_metric=residual`` is honoured per lane (``main.py``
  downgrades it to rel_iter).
"""

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import fv as TFV
from anap3_tpu_torch.models import runner as TR
from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import FVParameters
from anap3_tpu_torch.ops import fv_lane_kernels as fvl
from anap3_tpu_torch.ops import sg_lane_kernels as sgl
from anap3_tpu_torch.parallel import batched as TB
from anap3_tpu_torch.parallel import sweep as TS

import jax
import jax.numpy as jnp
from anap3_tpu.models import spectral_sg as J
from anap3_tpu.models.params import SpectralParameters as JaxParameters
from anap3_tpu.parallel import sweep as JS

torch.set_num_threads(1)

STATE_TOL = 1e-12
ROWS_TOL = 1e-10
UV = (lambda s: (s.u, s.v))


def spec(Re, cs=0.15, cfl=1.5, n=12, **over):
    """conf/solver/spectral/sg.yaml numerics at a test size, float64."""
    kw = dict(Re=Re, nx=n, ny=n, basis_type="chebyshev", CFL=cfl,
              beta_squared=5.0, corner_treatment="smoothing",
              corner_smoothing=cs, tolerance=1e-3, max_iterations=1500,
              dtype="float64")
    kw.update(over)
    return kw


def lanes(specs):
    """(JAX ops, port ops) of each lane: the port's from the JAX arrays."""
    jops = [J.build_spectral_ops(JaxParameters(**s))[0] for s in specs]
    tops = [T.ops_from_jax(o, "cpu", torch.float64) for o in jops]
    return jops, tops


def jax_sweep(jops, **kw):
    states = jax.tree.map(lambda *a: jnp.stack(a),
                          *[J.initial_state(o) for o in jops])
    return JS.run_batched_sweep(J.sg_step, UV, JS.stack_ops(jops), states,
                                **kw)


def port_sweep(tops, **kw):
    states = TS.stack_states([T.initial_state(o) for o in tops])
    return TS.run_batched_sweep(T.sg_step, UV, TS.stack_ops(tops), states,
                                **kw)


def single(ops, **kw):
    """The lane's B=1 plain solve through the port's runner."""
    return TR.run_fixed_point(lambda s: T.sg_step(ops, s), UV,
                              T.initial_state(ops), **kw)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def assert_lane_state(port_states, k, jax_states, tol=STATE_TOL):
    for a, b in zip(port_states, jax_states):
        assert rel(a[k].numpy(), np.asarray(b[k])) <= tol


def assert_rows(port_hist, jax_hist, lane=slice(None), cols=slice(None)):
    """Per metric, rows within ROWS_TOL of the metric's largest value;
    NaN (a done lane) at the same places."""
    for key, jv in jax_hist.items():
        a = np.asarray(port_hist[key])[lane, cols]
        b = np.asarray(jv)[lane, cols]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        fin = np.isfinite(b)
        if fin.any():
            assert rel(a[fin], b[fin]) <= ROWS_TOL, key


LANES3 = [spec(100.0), spec(400.0, 0.10, 1.2), spec(1000.0, 0.20)]


class TestPlainSweepAgainstJax:
    def test_one_chunk_matches_jax(self):
        """Three lanes (Re, corner_smoothing and CFL varying) in one chunk:
        two converge at different steps, one runs to the cap."""
        jops, tops = lanes(LANES3)
        kw = dict(tolerance=1e-3, max_iterations=1500, chunk=1500)
        jr, tr = jax_sweep(jops, **kw), port_sweep(tops, **kw)
        np.testing.assert_array_equal(tr.iterations, jr.iterations)
        np.testing.assert_array_equal(tr.converged, jr.converged)
        np.testing.assert_array_equal(tr.diverged, jr.diverged)
        assert list(tr.converged) == [True, True, False]
        for k in range(3):
            assert_lane_state(tr.states, k, jr.states)
        np.testing.assert_array_equal(tr.history_iters, jr.history_iters)
        assert_rows(tr.history, jr.history)

    def test_a_lane_done_in_an_earlier_chunk_stays_frozen(self):
        """Chunks of 100 with speculative dispatch: every lane equals its
        B=1 solve (count and bits). The lane running to the cap equals
        JAX; the early lanes keep their own count where JAX reports the
        first step of the last chunk (its chunk restarts with no lane
        done), and their rows up to convergence equal JAX's."""
        jops, tops = lanes(LANES3)
        kw = dict(tolerance=1e-3, max_iterations=1500, chunk=100)
        jr, tr = jax_sweep(jops, **kw), port_sweep(tops, **kw)
        for k, ops in enumerate(tops):
            one = single(ops, **kw)
            assert int(tr.iterations[k]) == one.iterations
            assert bool(tr.converged[k]) == one.converged
            for a, b in zip(tr.states, one.state):
                assert torch.equal(a[k], b)
        assert list(tr.iterations[:2]) == [584, 1005]
        assert list(jr.iterations[:2]) == [1401, 1401]
        assert int(tr.iterations[2]) == int(jr.iterations[2]) == 1500
        np.testing.assert_array_equal(tr.converged, jr.converged)
        assert_lane_state(tr.states, 2, jr.states)
        for k in range(2):
            n_rec = int(np.sum(tr.history_iters < tr.iterations[k]))
            assert_rows(tr.history, jr.history, lane=k,
                        cols=slice(0, n_rec))
            assert np.isnan(tr.history["rel_iter"][k, n_rec:]).all()

    def test_energy_criterion_per_lane(self):
        """The per-lane energy plateau with its net-drift gate: iterations,
        flags and states as JAX's and as each lane's B=1 energy solve."""
        jops, tops = lanes([spec(100.0, n=8), spec(200.0, n=8)])
        kw = dict(tolerance=1e-4, max_iterations=3000, chunk=50,
                  convergence_metric="energy", energy_plateau_chunks=3)
        jr, tr = jax_sweep(jops, **kw), port_sweep(tops, **kw)
        assert tr.converged.all() and not tr.diverged.any()
        np.testing.assert_array_equal(tr.iterations, jr.iterations)
        np.testing.assert_array_equal(tr.converged, jr.converged)
        for k, ops in enumerate(tops):
            assert_lane_state(tr.states, k, jr.states)
            one = single(ops, **kw)
            assert one.converged and int(tr.iterations[k]) == one.iterations
        assert_rows(tr.history, jr.history)

    def test_singular_lanes(self):
        """Sharp-lid lanes with different lid speeds: the nine singular
        fields (they scale with the lid) stack per lane."""
        specs = [spec(Re, n=16, corner_treatment="singular", lid_velocity=U)
                 for Re, U in ((100.0, 1.0), (200.0, 1.5))]
        jops, tops = lanes(specs)
        stacked = TS.stack_ops(tops)
        assert stacked.sing_u.shape == (2, 17, 17)
        assert stacked.Dx.shape == (17, 17)  # shared, kept once
        kw = dict(tolerance=1e-14, max_iterations=200, chunk=50)
        jr, tr = jax_sweep(jops, **kw), port_sweep(tops, **kw)
        np.testing.assert_array_equal(tr.iterations, jr.iterations)
        for k in range(2):
            assert_lane_state(tr.states, k, jr.states)
        assert_rows(tr.history, jr.history)

    def test_a_diverging_lane_leaves_the_others_alone(self):
        jops, tops = lanes([spec(100.0), spec(100.0, cfl=50.0)])
        kw = dict(tolerance=1e-3, max_iterations=1500, chunk=100)
        jr, tr = jax_sweep(jops, **kw), port_sweep(tops, **kw)
        assert tr.converged[0] and not tr.diverged[0]
        assert tr.diverged[1] and not tr.converged[1]
        np.testing.assert_array_equal(tr.diverged, jr.diverged)
        assert int(tr.iterations[0]) == int(jr.iterations[0])
        assert_lane_state(tr.states, 0, jr.states)
        one = single(tops[0], **kw)
        for a, b in zip(tr.states, one.state):
            assert torch.equal(a[0], b)
        assert all(bool(torch.isfinite(t[0]).all()) for t in tr.states)

    def test_history_decimation_bound(self):
        """History stays within twice the cap, strided from the warmup
        gate, and equal to JAX's decimated history."""
        jops, tops = lanes([spec(100.0, n=8), spec(400.0, n=8)])
        kw = dict(tolerance=1e-30, max_iterations=1500, chunk=100,
                  max_history_points=100)
        jr, tr = jax_sweep(jops, **kw), port_sweep(tops, **kw)
        n_rec = tr.history["energy"].shape[1]
        assert n_rec <= 200 and tr.history_iters.shape == (n_rec,)
        strides = np.diff(tr.history_iters)
        assert (strides == strides[0]).all() and strides[0] > 1
        assert tr.history_iters[0] >= 10 and tr.history_iters[-1] < 1500
        np.testing.assert_array_equal(tr.history_iters, jr.history_iters)
        assert_rows(tr.history, jr.history)


class TestResidualCriterion:
    """``convergence_metric=residual`` per lane, each with its own
    normalization (the continuity norm at the warmup step): the batch's
    lanes are the B=1 residual solves of the port, through the plain
    batched path and through the lane runner's plain version. The JAX
    sweep has no residual criterion; ``main.py:485-492`` runs such batches
    on rel_iter."""

    @pytest.mark.parametrize("path", ["plain", "lane_runner"])
    def test_lanes_equal_their_residual_solves(self, path):
        specs = [spec(100.0), spec(400.0, 0.10, 1.2)]
        _, tops = lanes(specs)
        kw = dict(tolerance=0.1, max_iterations=1200, chunk=100,
                  convergence_metric="residual")
        runner = None
        if path == "lane_runner":
            runner = lambda c, t, w, m: sgl.make_lane_chunk_runner(
                tops, c, t, w, m)
        sgl.reset_counts()
        tr = port_sweep(tops, lane_runner=lambda lanes: runner, **kw)
        assert (sgl.PLAIN_CALLS["sg_lanes"] > 0) == (path == "lane_runner")
        assert tr.converged.all()
        for k, ops in enumerate(tops):
            one = single(ops, **kw)
            assert one.converged and int(tr.iterations[k]) == one.iterations
            for a, b in zip(tr.states, one.state):
                assert torch.equal(a[k], b)
        # the residual criterion stops elsewhere than rel_iter would
        rel = port_sweep(tops, **dict(kw, convergence_metric="rel_iter"))
        assert list(rel.iterations) != list(tr.iterations)

    @pytest.mark.parametrize("use_pallas", ["false", "true"])
    def test_fv_lanes_equal_their_residual_solves(self, use_pallas):
        """FV lanes (Re and lid varying) under the residual criterion,
        through run_batched: false takes the plain batched chunk over
        fv_step, true the FV lane runner's plain version (the fused
        kernels' arithmetic and state machine). Both converge mid-chunk and
        every lane is its own B=1 residual solve: count and bits."""
        ps = [FVParameters(Re=Re, nx=8, ny=8, dtype="float64", device="cpu",
                           tolerance=0.05, max_iterations=300,
                           chunk_size=100, lid_velocity=U,
                           convergence_metric="residual",
                           use_pallas=use_pallas)
              for Re, U in ((100.0, 1.0), (400.0, 1.5))]
        solvers = [TFV.FVSolver(params=p) for p in ps]
        TS.reset_counts()
        fvl.reset_counts()
        results = TB.run_batched(solvers)
        assert (fvl.PLAIN_CALLS["fv_lanes"] > 0) == (use_pallas == "true")
        assert (TS.PLAIN_CALLS["batched_chunk"] > 0) == (
            use_pallas == "false")
        assert [r.iterations for r in results] == [49, 47]
        for p, s, r in zip(ps, solvers, results):
            one = TFV.FVSolver(params=p)
            one.solve()
            assert r.converged and one.metrics.converged
            assert r.iterations == one.metrics.iterations
            for a, b in zip(s.state, one.state):
                assert torch.equal(a, b)


class TestStackedOps:
    def test_shared_and_per_lane_fields(self):
        _, tops = lanes([spec(100.0, n=8), spec(400.0, 0.1, 1.2, n=8)])
        s = TS.stack_ops(tops)
        assert len(s) == 2 and s.lane(1) is tops[1]
        assert s.Dx is tops[0].Dx  # equal in every lane: kept once
        assert s.bc_u.shape == (2, 9, 9)  # lid profiles differ
        assert s.nu.shape == (2,) and s.CFL.dtype == torch.float64
        torch.testing.assert_close(
            s.nu, torch.tensor([o.nu for o in tops], dtype=torch.float64))
        assert s.sing_u is None
        with pytest.raises(AttributeError):
            s.no_such_field

    def test_fv_ops_stack(self):
        p = [FVParameters(Re=Re, nx=8, ny=8, dtype="float64", device="cpu")
             for Re in (100.0, 400.0)]
        ops = [TFV.build_fv_ops(q)[0] for q in p]
        s = TS.stack_ops(ops)
        assert s.mu.shape == (2,) and s.alpha_uv.shape == (2,)
        assert s.bc_u_n is ops[0].bc_u_n and s.scheme == ops[0].scheme
