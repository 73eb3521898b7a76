"""The readers of the program's own spans and steps counter
(``frozen_steps``, ``launch_idle``, ``control_idle``) on a made-up run: the
program's modules stand in ``sys.modules`` as the run leaves them."""

import sys
from types import SimpleNamespace

import pytest

from ldc_bench import spec
from ldc_bench.drive import Job, Lane
from ldc_bench.metrics import _program

METRICS = ("frozen_steps", "launch_idle", "control_idle")


def job(levels_by_lane, step_s=2.0):
    lanes = [Lane(params={}, n=96, state=(), converged=True,
                  iterations=sum(i for _, i in lv), levels=lv, validation={})
             for lv in levels_by_lane]
    return Job(kind="round" if len(lanes) > 1 else "solve", lanes=lanes,
               build_s=0.05, step_s=step_s, validate_s=0.1,
               wall_s=step_s + 0.15)


# a traced solve: 2 s stepping; the breakdown's gaps by name
GAPS = [["anap3.validate.evaluate", 1.3], ["anap3.chunk.dispatch", 0.08],
        ["anap3.chunk.wait", 0.01], ["Command Buffer Full", 0.02],
        ["anap3.level.setup", 0.03], ["anap3.solve.finish", 0.005],
        ["anap3.chunk.control", 0.004], ["aten::copy_", 0.002],
        ["ldc_bench.solve", 0.001], ["anap3.level.prolong", 0.002]]


def ctx_of(kind, jobs, traced, gaps=GAPS):
    tr = None if traced is None else {"job": traced, "idle_gaps": gaps,
                                      "busy_s": 1.0, "window_s": 3.0}
    return {"kind": kind, "config": {"solver": "fsg"}, "jobs": jobs,
            "window_s": 10.0,
            "setup_s": 7.5, "launches": 5000, "trace": tr}


@pytest.fixture
def program(monkeypatch):
    """The program's kernel modules and tracer as a run leaves them: 190,000
    steps asked of the chunk runners over the window and the traced job."""
    tables = [{"sg_chunk": 150000}, {"fv_chunk": 0},
              {"sg_lanes": 40000}, {"fv_lanes": 0}]
    for name, steps in zip(_program.KERNEL_MODULES, tables):
        monkeypatch.setitem(sys.modules, name, SimpleNamespace(STEPS=steps))
    monkeypatch.setitem(sys.modules, _program.TRACER,
                        SimpleNamespace(span=lambda name: None))


@pytest.fixture
def parent(monkeypatch):
    """A program without the counter and the spans."""
    for name in _program.KERNEL_MODULES:
        monkeypatch.setitem(sys.modules, name,
                            SimpleNamespace(LAUNCHES={"k": 1}))
    monkeypatch.setitem(sys.modules, _program.TRACER, SimpleNamespace())


def read(name, ctx):
    return spec.reader(name)(ctx, name)


def test_frozen_steps_reads_the_steps_no_lane_needed(program):
    # window: two solves of 85,000 steps; the traced job 1,805 more
    jobs = [job([[(48, 80000), (96, 5000)]])] * 2
    ctx = ctx_of("solve", jobs, job([[(48, 1000), (96, 805)]]))
    assert read("frozen_steps.solve", ctx) == pytest.approx(
        100 * (1 - 171805 / 190000))
    # a round: the slowest lane at each level
    rnd = job([[(20, 100000), (40, 30000)], [(20, 90000), (40, 40000)]])
    ctx = ctx_of("round", [rnd], job([[(20, 5000), (40, 5000)]] * 2))
    assert read("frozen_steps.round", ctx) == pytest.approx(
        100 * (1 - 150000 / 190000))


def test_idle_readers_add_up_their_names(program):
    ctx = ctx_of("solve", [], job([[(96, 1000)]], step_s=2.0))
    assert read("launch_idle.solve", ctx) == pytest.approx(
        100 * (0.08 + 0.02) / 2.0)
    assert read("control_idle.solve", ctx) == pytest.approx(
        100 * (0.01 + 0.004 + 0.03 + 0.002 + 0.005) / 2.0)


def test_an_absent_span_name_reads_0(program):
    gaps = [["anap3.validate", 1.0], ["ldc_bench.solve", 0.2]]
    ctx = ctx_of("round", [], job([[(40, 10)]] * 2), gaps)
    assert read("launch_idle.round", ctx) == 0.0
    assert read("control_idle.round", ctx) == 0.0
    part = [["anap3.chunk.wait", 0.5]]
    ctx = ctx_of("round", [], job([[(40, 10)]] * 2, step_s=5.0), part)
    assert read("control_idle.round", ctx) == pytest.approx(10.0)


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_to_read_in_the_other_kind_or_untraced(program, metric):
    jobs = [job([[(96, 1000)]])]
    traced = ctx_of("solve", jobs, job([[(96, 100)]]))
    assert read(f"{metric}.round", traced) is None
    assert read(f"{metric}.solve", traced) is not None
    assert read(f"{metric}.solve", ctx_of("solve", jobs, None)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_a_program_without_them_reads_none(parent, metric):
    jobs = [job([[(96, 1000)]])]
    ctx = ctx_of("solve", jobs, job([[(96, 100)]]))
    assert read(f"{metric}.solve", ctx) is None
