"""Batched FSG sweeps and the batched entry of anap3_tpu_torch
(parallel/fsg_sweep.py, parallel/batched.py) against anap3_tpu.

On the CPU in float64, through the plain batched path: ``run_batched_fsg``
against ``anap3_tpu.parallel.fsg_sweep.run_batched_fsg`` (per-lane
iterations equal, fields within 1e-9) and against the port's own
``FSGSolver.solve()`` lane by lane (the same levels, iterations and bits:
both share one prolongation routine); the sweep's FSG ladder, which keeps
the FSG solver's coarsest-level floors where the JAX sweep halves down to
12; and ``batchable`` / ``batch_signature`` / ``run_batched`` against
``main.py``'s grouping, each lane repeating its own solve.
"""

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models.fv import FVSolver
from anap3_tpu_torch.models.params import FVParameters, SpectralParameters
from anap3_tpu_torch.models.spectral import FSGSolver, SGSolver
from anap3_tpu_torch.ops import fv_lane_kernels as fvl
from anap3_tpu_torch.ops import sg_lane_kernels as sgl
from anap3_tpu_torch.parallel import batched as TB
from anap3_tpu_torch.parallel import fsg_sweep as TFS
from anap3_tpu_torch.parallel import sweep as TS

from anap3_tpu.models.params import SpectralParameters as JaxParameters
from anap3_tpu.parallel import fsg_sweep as JFS
from test_torch_sweep import STATE_TOL, rel, spec

torch.set_num_threads(1)


# ------------------------------------------------------------ FSG sweeps


def fsg_spec(Re, n=24, **over):
    kw = dict(multigrid="fsg", n_levels=2, tolerance=1e-3,
              max_iterations=1000, chunk_size=1000)
    kw.update(over)
    return spec(Re, n=n, **kw)


class TestBatchedFSG:
    def test_matches_jax_fsg_sweep(self):
        """N=24, Re 100 and 400, ladder [12, 24] in both packages: per-lane
        iterations equal, fields within 1e-9."""
        specs = [fsg_spec(100.0), fsg_spec(400.0)]
        jps = [JaxParameters(**s) for s in specs]
        tps = [SpectralParameters(device="cpu", **s) for s in specs]
        assert JFS._level_orders(jps[0]) == [12, 24]
        assert TFS.lane_ladders(tps) == [[12, 24], [12, 24]]
        jres = JFS.run_batched_fsg(jps)
        tres = TFS.run_batched_fsg(tps)
        for j, t in zip(jres, tres):
            assert t.iterations == j.iterations and t.converged == j.converged
            assert [lv["n"] for lv in t.levels] == [12, 24]
            for a, b in zip(t.state, j.state):
                assert rel(a.numpy(), np.asarray(b)) <= 1e-9
            for key in j.history:
                assert t.history[key][0] == pytest.approx(
                    j.history[key][0], rel=1e-9), key
        assert tres[0].wall_time == tres[1].wall_time  # the shared wall

    def test_a_lane_repeats_its_fsg_solve(self):
        """The sweep shares the FSG solver's prolongation and ladder: each
        lane takes the levels, iterations and bits of its FSGSolver.solve()."""
        specs = [fsg_spec(100.0), fsg_spec(400.0, corner_smoothing=0.1)]
        tps = [SpectralParameters(device="cpu", **s) for s in specs]
        tres = TFS.run_batched_fsg(tps)
        for p, t in zip(tps, tres):
            solver = FSGSolver(params=p)
            solver.solve()
            assert [(lv["n"], lv["iterations"]) for lv in solver.levels] == [
                (lv["n"], lv["iterations"]) for lv in t.levels]
            assert t.iterations == solver.metrics.iterations
            for a, b in zip(t.state, solver.state):
                assert torch.equal(a, b)

    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    @pytest.mark.parametrize("Re", [1000.0, 3200.0, 5000.0])
    def test_ladder_is_the_fsg_solvers(self, Re, corner):
        """The sweep's ladder keeps the coarsest-level floors of the FSG
        solver (cell Peclet, and the sharp-lid floor in singular mode); the
        JAX sweep halves down to 12 regardless."""
        kw = spec(Re, n=128, multigrid="fsg", n_levels=2,
                  corner_treatment=corner)
        solver = FSGSolver(params=SpectralParameters(device="cpu", **kw))
        ladder = TFS.lane_ladders([solver.params])[0]
        assert ladder == solver._level_orders()
        jax_ladder = JFS._level_orders(JaxParameters(**kw))
        assert jax_ladder == [64, 128]
        if Re == 5000.0:
            assert ladder == [128] != jax_ladder  # Peclet floor 72 > 64

    def test_lanes_with_different_ladders_run_as_groups(self):
        specs = [fsg_spec(100.0, max_iterations=300, chunk_size=300),
                 fsg_spec(3000.0, max_iterations=300, chunk_size=300)]
        tps = [SpectralParameters(device="cpu", **s) for s in specs]
        assert TFS.lane_ladders(tps) == [[12, 24], [24]]  # Peclet floor 43
        res = TFS.run_batched_fsg(tps)
        assert [lv["n"] for lv in res[0].levels] == [12, 24]
        assert [lv["n"] for lv in res[1].levels] == [24]


# ------------------------------------------------------------ dispatch


def job(target, N=12, **solver):
    cfg = {"_target_": target, "nx": N, "ny": N, "Re": 100.0,
           "dtype": "float64", "tolerance": 1e-3}
    cfg.update(solver)
    return {"N": N, "solver": cfg}


JAX_SG = "anap3_tpu.models.spectral.SGSolver"
PORT_SG = "anap3_tpu_torch.models.spectral.SGSolver"
BATCH_CASES = [
    ([{"Re": 100.0}, {"Re": 400.0}], True),
    ([{"Re": 100.0, "corner_smoothing": 0.1},
      {"Re": 400.0, "CFL": 1.2, "corner_treatment": "singular"}], True),
    ([{"Re": 100.0}], False),
    ([{"Re": 100.0}, {"N": 16}], False),
    ([{"Re": 100.0}, {"tolerance": 1e-4}], False),
    ([{"Re": 100.0}, {"Re": 400.0, "lid_velocity": 2.0}], True),
]


def jobs_of(case, target):
    out = []
    for over in case:
        over = dict(over)
        N = over.pop("N", 12)
        out.append(job(target, N=N, **over))
    return out


class TestDispatch:
    @pytest.mark.parametrize("case,expected", BATCH_CASES)
    def test_batchable_and_signature_as_main(self, case, expected):
        import main as M

        assert TB.BATCHABLE_VARYING == M._BATCHABLE_VARYING
        port, ref = jobs_of(case, PORT_SG), jobs_of(case, JAX_SG)
        assert TB.batchable(port) == M._batchable(ref) == expected
        sig = [TB.batch_signature(j) for j in port]
        ref_sig = [M._batch_signature(j) for j in ref]
        strip = lambda s: tuple(kv for kv in s if kv[0] != "_target_")
        assert [strip(s) for s in sig] == [strip(s) for s in ref_sig]
        assert (len(set(sig)) == 1) == (len(set(ref_sig)) == 1)

    def test_only_the_ports_solvers_batch(self):
        mixed = [job(PORT_SG), job("anap3_tpu_torch.models.fv.FVSolver")]
        assert not TB.batchable(mixed)
        assert not TB.batchable([job(JAX_SG), job(JAX_SG, Re=400.0)])
        assert TB.batch_signature(job(JAX_SG)) is None
        assert TB.BATCHABLE_SOLVERS == {
            f"anap3_tpu_torch.models.{m}" for m in (
                "spectral.SGSolver", "spectral.FSGSolver", "fv.FVSolver")}

    def test_run_batched_sg_group(self):
        """An SG group on the CPU takes the plain batched path (auto: the
        plain lane runner, quadratures every step) and stores each lane's
        result into its solver, as its own solve would (iterations,
        state)."""
        ps = [SpectralParameters(device="cpu", **spec(Re, n=8,
                                                     max_iterations=600))
              for Re in (100.0, 400.0)]
        solvers = [SGSolver(params=p) for p in ps]
        TS.reset_counts()
        sgl.reset_counts()
        results = TB.run_batched(solvers)
        assert sgl.PLAIN_CALLS["sg_lanes"] > 0
        assert TS.PLAIN_CALLS["batched_chunk"] == 0
        for p, s, r in zip(ps, solvers, results):
            one = SGSolver(params=p)
            one.solve()
            assert s.metrics.iterations == r.iterations == \
                one.metrics.iterations
            assert s.metrics.converged == one.metrics.converged
            assert all(torch.equal(a, b) for a, b in zip(s.state, one.state))
            assert s.fields is not None and len(s.time_series.energy) > 0

    def test_run_batched_fsg_group(self):
        ps = [SpectralParameters(device="cpu", **fsg_spec(
            Re, max_iterations=400, chunk_size=400))
            for Re in (100.0, 200.0)]
        solvers = [FSGSolver(params=p) for p in ps]
        results = TB.run_batched(solvers)
        for s, r in zip(solvers, results):
            assert [lv["n"] for lv in r.levels] == [12, 24]
            assert s.levels == r.levels
            assert s.metrics.iterations == r.iterations
            assert len(s.time_series.rel_iter_residual) == 1

    @pytest.mark.parametrize("use_pallas", ["auto", "true"])
    def test_run_batched_fv_group(self, use_pallas, monkeypatch):
        """FV lanes: auto on the CPU runs the plain batched path over
        fv_step (chunks of 200); true runs the lane runner's plain version
        (the fused kernels' arithmetic) with the chunk capped at 500.
        Either way each lane repeats its own solve with the same
        use_pallas."""
        ps = [FVParameters(Re=Re, nx=8, ny=8, dtype="float64", device="cpu",
                           tolerance=1e-3, max_iterations=160,
                           chunk_size=1000, lid_velocity=U,
                           use_pallas=use_pallas)
              for Re, U in ((100.0, 1.0), (400.0, 1.5))]
        solvers = [FVSolver(params=p) for p in ps]
        TS.reset_counts()
        fvl.reset_counts()
        chunks = []
        real = TB.run_batched_sweep
        monkeypatch.setattr(TB, "run_batched_sweep", lambda *a, **kw: (
            chunks.append(kw["chunk"]), real(*a, **kw))[1])
        results = TB.run_batched(solvers)
        lane_calls = fvl.PLAIN_CALLS["fv_lanes"]
        if use_pallas == "true":
            assert chunks == [500] and lane_calls == 1
            assert TS.PLAIN_CALLS["batched_chunk"] == 0
        else:
            assert chunks == [200] and lane_calls == 0
            assert TS.PLAIN_CALLS["batched_chunk"] == 1
        for p, s, r in zip(ps, solvers, results):
            one = FVSolver(params=p)
            one.solve()
            assert r.iterations == one.metrics.iterations
            assert r.converged == one.metrics.converged
            for a, b in zip(s.state, one.state):
                assert rel(a.numpy(), b.numpy()) <= STATE_TOL

    def test_run_batched_refuses_what_batchable_refuses(self):
        """run_batched checks its group as main.py checks jobs: alpha_uv
        is not among the keys that may vary between lanes."""
        ps = [FVParameters(Re=100.0, nx=8, ny=8, dtype="float64",
                           device="cpu", alpha_uv=a) for a in (0.4, 0.5)]
        solvers = [FVSolver(params=p) for p in ps]
        assert not TB.batchable([TB.solver_job(s) for s in solvers])
        with pytest.raises(ValueError, match="cannot share a batch"):
            TB.run_batched(solvers)
        assert TB.solver_job(solvers[0])["solver"]["_target_"] == \
            "anap3_tpu_torch.models.fv.FVSolver"

    def test_fv_lane_kernels_refuse_what_the_fused_kernels_refuse(self):
        ps = [FVParameters(Re=Re, nx=8, ny=8, dtype="float64", device="cpu",
                           limiter="MUSCL-sharp", use_pallas="true")
              for Re in (100.0, 400.0)]
        solvers = [FVSolver(params=p) for p in ps]
        with pytest.raises(ValueError):
            TB.run_batched(solvers)
