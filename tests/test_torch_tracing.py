"""The port's own spans and its marched-steps counter, on the CPU.

- ``utils/profiling.span`` opens nothing without a profiler: a capped FSG
  solve, a capped FV solve and their validation run with the tracer's
  record-function reference made to raise.
- Under ``torch.profiler`` the solves' spans appear with their ``anap3.``
  names: the chunk, level and finish spans as leaves that never overlap,
  ``validate.load`` and ``validate.evaluate`` inside ``validate``; a span's
  interval on the profiler's clock agrees with a ``time.time_ns()``
  bracket around it.
- ``STEPS`` of the four kernel modules counts the steps the chunk runners
  were asked to march, the dropped speculated chunk included, on their
  plain paths here; ``reset_counts()`` zeroes it.
- A VMG solve opens ``vmg.smooth``, ``vmg.restrict`` and ``vmg.prolong``
  at each level of every V-cycle, inside the chunk's dispatch, and none
  without a profiler; ``SMOOTH_STEPS`` counts a smoother's steps by order
  (its plain path here), apart from ``STEPS``, and ``reset_counts()``
  empties it.
"""

import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from anap3_tpu_torch.models import fv as TFV
from anap3_tpu_torch.models import runner as TR
from anap3_tpu_torch.models import spectral_sg as core
from anap3_tpu_torch.models.params import FVParameters, SpectralParameters
from anap3_tpu_torch.models import spectral_vmg as TV
from anap3_tpu_torch.models.spectral import FSGSolver
from anap3_tpu_torch.ops import fv_kernels as fvk
from anap3_tpu_torch.ops import fv_lane_kernels as fvl
from anap3_tpu_torch.ops import sg_kernels as sgk
from anap3_tpu_torch.ops import sg_lane_kernels as sgl
from anap3_tpu_torch.parallel import batched as TB
from anap3_tpu_torch.parallel import sweep as TS
from anap3_tpu_torch.utils import profiling as TP

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
UV = lambda s: (s.u, s.v)  # noqa: E731
# the leaves of a solve: no two of them overlap
LEAVES = {"chunk.dispatch", "chunk.wait", "chunk.control", "level.setup",
          "level.prolong", "solve.finish"}
SOLVE_SPANS = LEAVES | {"validate", "validate.load", "validate.evaluate"}


def fsg(**kw):
    """A two-level FSG solve [12, 24], capped."""
    kw = dict(dict(Re=100.0, nx=24, ny=24, n_levels=2, dtype="float64",
                   tolerance=1e-10, max_iterations=60, chunk_size=20,
                   coarse_tolerance_factor=1.0), **kw)
    return FSGSolver(params=SpectralParameters(device="cpu", **kw))


def fv(**kw):
    kw = dict(dict(Re=100.0, nx=8, ny=8, dtype="float64", tolerance=1e-10,
                   max_iterations=30, chunk_size=10), **kw)
    return TFV.FVSolver(params=FVParameters(device="cpu", **kw))


def solve_and_validate(solver):
    solver.solve()
    return solver.compute_validation_errors(base_dir=ROOT, save_plots=False)


def spans_of(prof):
    """(name without the prefix, start, end) of every span, in ns, by
    start."""
    return sorted(((e.name()[len(TP.PREFIX):], e.start_ns(),
                    e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(TP.PREFIX)), key=lambda s: s[1])


def assert_leaves(spans):
    """No two leaf spans of different names overlap (a span may hold
    spans of its own name)."""
    leaves = [s for s in spans if s[0] in LEAVES]
    for i, (n, a0, a1) in enumerate(leaves):
        for m, b0, b1 in leaves[i + 1:]:
            if b0 >= a1:
                break
            assert m == n and b1 <= a1, f"{m} overlaps {n}"


def test_no_span_is_made_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span {name!r} was made with no profiler")

    monkeypatch.setattr(TP, "_record", refuse)
    assert not torch._C._autograd._profiler_enabled()
    for solver in (fsg(), fv()):
        errors = solve_and_validate(solver)
        assert solver.metrics.iterations > 0
        assert "u_L2_error" in errors
    with TP.PhaseTimer().phase("solve"):
        pass


@pytest.mark.parametrize("make", [fsg, fv], ids=["fsg", "fv"])
def test_spans_name_the_solve_and_nest(make):
    solver = make()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve_and_validate(solver)
    spans = spans_of(prof)
    names = {n for n, _, _ in spans}
    want = SOLVE_SPANS - ({"level.prolong"} if make is fv else set())
    assert names == want
    assert_leaves(spans)
    outer = [(a, b) for n, a, b in spans if n == "validate"]
    for n, a, b in spans:
        inside = any(o0 <= a and b <= o1 and (o0, o1) != (a, b)
                     for o0, o1 in outer)
        assert inside == n.startswith("validate."), n
    # one chunk.dispatch per chunk: 60 steps a level in chunks of 20 (FSG:
    # two levels), no speculation past the cap
    chunks = 6 if make is fsg else 3
    assert sum(n == "chunk.dispatch" for n, _, _ in spans) == chunks
    assert sum(n == "chunk.wait" for n, _, _ in spans) == chunks


def test_round_spans_name_every_lane_step():
    solvers = [fsg(corner_smoothing=c, max_iterations=40) for c in
               (0.1, 0.15)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TB.run_batched(solvers)
    spans = spans_of(prof)
    assert_leaves(spans)
    counts = {n: sum(m == n for m, _, _ in spans) for n in LEAVES}
    # two levels of two chunks; each lane's operators at each level, each
    # lane's prolongation; a lane's closing residuals, its final fields and
    # the three parts of its vortex metrics
    assert counts["chunk.dispatch"] == counts["chunk.wait"] == 4
    assert counts["level.prolong"] == 2
    assert counts["solve.finish"] == 2 * (1 + 4)
    assert counts["level.setup"] >= 2 * 2


def test_a_span_is_on_the_host_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        with TP.span("probe"):
            time.sleep(0.02)
        t1 = time.time_ns()
    (name, start, end), = spans_of(prof)
    assert name == "probe"
    assert abs(start - t0) < 1e6 and abs(end - t1) < 1e6


def test_phase_timer_opens_a_cli_span():
    timer = TP.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("analysis"):
            pass
    assert [n for n, _, _ in spans_of(prof)] == ["cli.analysis"]
    assert list(timer.as_metrics()) == ["time_analysis_seconds"]


def sg_ops(n=12, **kw):
    p = SpectralParameters(device="cpu", nx=n, ny=n, dtype="float64",
                           Re=100.0, **kw)
    return core.build_spectral_ops(p)[0]


def fv_case(Re=100.0):
    p = FVParameters(device="cpu", nx=8, ny=8, dtype="float64", Re=Re)
    return p, TFV.build_fv_ops(p)[0]


def one_lane(kind):
    """(counter module, key, solve(tolerance, cap, chunk) -> iterations)
    of a one-lane runner's plain path."""
    if kind == "sg":
        ops = sg_ops()

        def factory(n, tol, metric):
            return sgk.make_sg_chunk_runner(ops, n, tol,
                                            convergence_metric=metric)
        state = core.initial_state(ops)
        step = lambda s: core.sg_step(ops, s)  # noqa: E731
        mod, key = sgk, "sg_chunk"
    else:
        params, ops = fv_case()

        def factory(n, tol, metric):
            return fvk.make_fv_chunk_runner(params, ops, n, tol)
        state = TFV.initial_state(ops)
        step = lambda s: TFV.fv_step(ops, s)  # noqa: E731
        mod, key = fvk, "fv_chunk"

    def solve(tol, cap, chunk):
        return TR.run_fixed_point(step, UV, state, tolerance=tol,
                                  max_iterations=cap, chunk=chunk,
                                  chunk_runner=factory).iterations

    return mod, key, solve


def lanes(kind):
    """The same for a two-lane ``run_batched_sweep``."""
    if kind.startswith("sg"):
        tops = [sg_ops(corner_smoothing=c) for c in (0.1, 0.15)]
        states = TS.stack_states([core.initial_state(o) for o in tops])
        if kind == "sg_lanes":
            runner = lambda l: lambda c, t, w, m: sgl.make_lane_chunk_runner(
                tops, c, t, w, m)  # noqa: E731
        else:
            runner = lambda l: sgl.plain_lane_runner(tops)  # noqa: E731
        mod, key, step = sgl, "sg_lanes", core.sg_step
    else:
        cases = [fv_case(Re) for Re in (100.0, 400.0)]
        tops = [o for _, o in cases]
        states = TS.stack_states([TFV.initial_state(o) for o in tops])
        runner = lambda l: lambda c, t, w, m: fvl.make_fv_lane_runner(
            [p for p, _ in cases], tops, c, t, w)  # noqa: E731
        mod, key, step = fvl, "fv_lanes", TFV.fv_step

    def solve(tol, cap, chunk):
        res = TS.run_batched_sweep(step, UV, TS.stack_ops(tops), states,
                                   tolerance=tol, max_iterations=cap,
                                   chunk=chunk, lane_runner=runner)
        return int(max(res.iterations))

    return mod, key, solve


@pytest.mark.parametrize("kind", ["sg", "fv", "sg_lanes", "sg_lanes_plain",
                                  "fv_lanes"])
def test_steps_count_the_chunks_asked_for(kind):
    mod, key, solve = (one_lane if kind in ("sg", "fv") else lanes)(kind)
    for m in (sgk, fvk, sgl, fvl):
        m.reset_counts()
    # never converged: the cap in whole chunks and the remainder, no
    # speculation past it
    assert solve(0.0, 25, 10) == 25
    assert mod.STEPS[key] == 25
    mod.reset_counts()
    assert mod.STEPS[key] == 0
    # converged in chunk k: chunks 0..k and the speculated k+1, dropped
    done = solve(1.0, 1000, 8)
    assert done < 1000
    assert mod.STEPS[key] == ((done - 1) // 8 + 2) * 8
    others = [m.STEPS for m in (sgk, fvk, sgl, fvl) if m is not mod]
    assert all(sum(t.values()) == 0 for t in others)
    mod.reset_counts()
    assert sum(mod.STEPS.values()) == 0


def vmg(**kw):
    """A two-level VMG solve [24, 12], capped at 6 V-cycles in chunks of
    2."""
    kw = dict(dict(Re=25.0, nx=24, ny=24, n_levels=2, dtype="float64",
                   basis_type="chebyshev", CFL=1.5, tolerance=1e-10,
                   max_iterations=24, chunk_size=8), **kw)
    return TV.VMGSolver(params=SpectralParameters(device="cpu", **kw))


def test_no_vmg_span_is_made_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span {name!r} was made with no profiler")

    monkeypatch.setattr(TP, "_record", refuse)
    solver = vmg()
    solver.solve()
    assert solver.metrics.iterations == 6


def test_vmg_spans_name_each_phase_of_a_cycle_and_nest():
    solver = vmg()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver.solve()
    assert solver.ladder == [24, 12] and solver.metrics.iterations == 6
    spans = spans_of(prof)
    cycle = [s for s in spans if s[0].startswith("vmg.")]
    # a cycle: pre, coarsest and post sweeps; the defect, the injection,
    # the coarse defect and tau_H; the correction, then its BCs and check
    counts = {n: sum(m == n for m, _, _ in cycle) for n in TV.SPANS}
    assert counts == {"vmg.smooth": 3 * 6, "vmg.restrict": 4 * 6,
                      "vmg.prolong": 2 * 6}
    assert [n for n, _, _ in cycle[:9]] == [
        "vmg.smooth"] + ["vmg.restrict"] * 4 + ["vmg.smooth"] + [
        "vmg.prolong"] * 2 + ["vmg.smooth"]
    dispatch = [(a, b) for n, a, b in spans if n == "chunk.dispatch"]
    assert len(dispatch) == 3
    for i, (n, a, b) in enumerate(cycle):
        assert any(d0 <= a and b <= d1 for d0, d1 in dispatch), n
        if i + 1 < len(cycle):
            assert cycle[i + 1][1] >= b  # one after another, none nested


def test_smooth_steps_count_each_sweep_by_order():
    levels = TV.build_vmg_levels(vmg().params)
    smoothers = {i: sgk.make_sg_smoother(lv.ops)
                 for i, lv in enumerate(levels)}
    step = TV.make_v_cycle(levels, smoothers=smoothers)
    for m in (sgk, fvk, sgl, fvl):
        m.reset_counts()
    state = core.initial_state(levels[0].ops)
    for _ in range(3):
        state, _ = step(state)
    assert sgk.SMOOTH_STEPS == {24: 3 * (2 + 2), 12: 3 * 30}
    assert sgk.PLAIN_CALLS["sg_smooth"] == 3 * 3
    assert all(sum(m.STEPS.values()) == 0 for m in (sgk, fvk, sgl, fvl))
    sgk.reset_counts()
    assert sgk.SMOOTH_STEPS == {}
