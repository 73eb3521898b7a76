"""The VMG cell (``vmg-re100.n48-solve``): its files are found and build
the port's VMG solver at N=48 with the ladder [48, 24]; ``work_vmg.py``
counts a V-cycle at N=48 as a hand count does; the readers of the V-cycle's
spans and smoother counter read None where the program lacks them, in
another solver's cell and untraced, and the share or bound they should on
a made-up run; on the CPU, a small VMG cell judged by the V-cycle
reference reads correct and its bfloat16 control does not. On a card
(``gpu``), at the cell's own size: the program's answer passes the cell's
limits, and its bfloat16 answer and the answer with one value at the
centre moved by 1e-3 (its validation worked out again from it) do not,
each refused by ``uv_cycle``."""

import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ldc_bench import control, drive, judge, spec, work, work_vmg
from ldc_bench import traffic as gen
from ldc_bench.drive import Job, Lane
from ldc_bench.metrics import _program, _vmg
from ldc_bench.reference import validation as ref_val
from ldc_bench.run import run_cell
from ldc_bench.tests.conftest import make_copy
from ldc_bench.tests.test_bench_solvers import add_cell

CELL = "vmg-re100.n48-solve"
NEW = ("smooth_idle.solve", "transfer_idle.solve", "vcycle_roofline.solve")
SEED = 2_147_700_123


def test_the_cell_is_found_and_builds_the_vmg_solver():
    bench = spec.benchmark()
    cell = spec.cell(bench, CELL)
    config = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    assert cell["chips"] == 1 and config["solver"] == "vmg"
    assert config["reference"] == "vmg" and config["reduced"] == []
    assert set(spec.limits(CELL)) >= {"uv_cycle", "p_cycle", "uv_step",
                                      "unconverged"}
    prog = drive.program()
    lanes = gen.job(config, mix, SEED, 0)
    solver = drive.make_solver(prog, config, lanes[0], "cpu")
    from anap3_tpu_torch.models.spectral_vmg import (VMGSolver,
                                                     build_vmg_levels)
    assert type(solver) is VMGSolver
    assert [lv.n for lv in build_vmg_levels(solver.params)] == [48, 24]
    assert spec.reference("vmg").ladder(lanes[0], 48) == [48, 24]
    names = [m["name"] for m in spec.metrics(bench, CELL, True)]
    assert set(NEW) | {"iterations.solve", "steps_per_s.solve",
                       "validate_ms.solve", "launches_per_step.solve",
                       "device_idle.solve"} == set(names)
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
    assert [m["name"] for m in spec.metrics(bench, CELL, False)] == [
        "setup_s", "solve_s"]


def test_a_cycle_at_n48_is_the_hand_count():
    stage = lambda nf, ni: (16 * nf ** 3 + 4 * nf * ni * ni  # noqa: E731
                            + 4 * nf * nf * ni)
    quad = lambda nf: 8 * nf ** 3  # noqa: E731
    fine, coarse = stage(49, 47), stage(25, 23)
    assert (fine, coarse) == (2_766_736, 360_400)
    smooth = 4 * 4 * fine + 2 * quad(49) + 30 * 4 * coarse + quad(25)
    # three sandwiches (injection, restriction, prolongation) of u and v
    # (25 x 49) and p (23 x 47)
    full = 2 * 25 * 49 ** 2 + 2 * 25 ** 2 * 49
    inner = 2 * 23 * 47 ** 2 + 2 * 23 ** 2 * 47
    assert (full, inner) == (181_300, 151_340)
    hand = smooth + fine + coarse + 3 * (2 * full + inner)
    assert hand == 94_192_116
    flops, nbytes = work_vmg.vcycle_work({48: 4, 24: 30}, 1, "float32")
    assert flops == hand
    seconds, what = work_vmg.vcycle_bound({48: 4000, 24: 30000}, 1000,
                                          "float32")
    assert what == "operations"
    assert seconds == pytest.approx(1000 * hand / work.PEAK_FLOPS["float32"])
    # the bytes: three sweeps and one pass, at least the states they move
    assert nbytes > 4 * 3 * (2 * 49 ** 2 + 2 * 25 ** 2)
    assert work_vmg.vcycle_work({48: 8, 24: 60}, 2, "float32") == (
        2 * flops, 2 * nbytes)


def lane(n=48, cycles=1000):
    return Lane(params={}, n=n, state=(), converged=False,
                iterations=cycles, levels=[(n, cycles)], validation={})


def job(cycles=1000, step_s=2.0):
    return Job(kind="solve", lanes=[lane(cycles=cycles)], build_s=0.05,
               step_s=step_s, validate_s=0.1, wall_s=step_s + 0.15)


# a traced VMG solve: 2 s stepping; the breakdown's gaps by name
GAPS = [["ldc_bench.solve", 0.3], ["anap3.vmg.smooth", 0.5],
        ["aten::mm", 0.4], ["anap3.vmg.restrict", 0.2],
        ["anap3.vmg.prolong", 0.1], ["aten::mul", 0.05]]


def ctx_of(solver="vmg", traced=True, kind="solve"):
    tr = {"job": job(), "idle_gaps": GAPS, "busy_s": 1.0, "window_s": 3.0,
          "span_busy_s": {"solve": 0.5}} if traced else None
    return {"kind": kind, "jobs": [job(1678)] * 3, "window_s": 51.0,
            "setup_s": 8.0, "launches": 1000, "trace": tr,
            "config": {"solver": solver, "params": {"dtype": "float32"}}}


@pytest.fixture
def program(monkeypatch):
    """The program as a run leaves it: three window solves of 1,678 cycles
    (and 16 more marched past each convergence) and the traced job's
    1,000."""
    cycles = 3 * (1678 + 16) + 1000
    monkeypatch.setitem(sys.modules, _vmg.SMOOTHER_MODULE, SimpleNamespace(
        SMOOTH_STEPS={48: 4 * cycles, 24: 30 * cycles}, STEPS={}))
    monkeypatch.setitem(sys.modules, _vmg.CYCLE_MODULE, SimpleNamespace(
        SPANS=("vmg.smooth", "vmg.restrict", "vmg.prolong")))


@pytest.fixture
def parent(monkeypatch):
    """A program without the V-cycle's spans and counter (but with the
    spans of its chunks)."""
    monkeypatch.setitem(sys.modules, _vmg.SMOOTHER_MODULE,
                        SimpleNamespace(STEPS={"sg_chunk": 0}))
    monkeypatch.setitem(sys.modules, _vmg.CYCLE_MODULE, SimpleNamespace())
    monkeypatch.setitem(sys.modules, _program.TRACER,
                        SimpleNamespace(span=lambda name: None))


def read(name, ctx):
    return spec.reader(name)(ctx, name)


def test_the_readers_read_the_made_up_run(program):
    ctx = ctx_of()
    assert read("smooth_idle.solve", ctx) == pytest.approx(100 * 0.5 / 2.0)
    assert read("transfer_idle.solve", ctx) == pytest.approx(
        100 * (0.2 + 0.1) / 2.0)
    least = 1000 * 94_192_116 / work.PEAK_FLOPS["float32"]
    assert read("vcycle_roofline.solve", ctx) == pytest.approx(
        100 * least / 0.5)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_them(program, parent, name):
    assert read(name, ctx_of()) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_elsewhere(program, name):
    assert read(name, ctx_of()) is not None
    assert read(name, ctx_of(solver="fsg")) is None
    assert read(name, ctx_of(traced=False)) is None
    assert read(name.replace(".solve", ".round"), ctx_of()) is None


def test_a_small_vmg_cell_is_judged_by_the_cycle(tmp_path):
    """N=24 Re=25 (the ladder [24, 12]) to 1e-6 on the CPU: the limits
    between the CPU readings (uv_cycle 4.6e-7, p_cycle 1.4e-6, uv_step
    6.4e-8, p_step 2.7e-7) and the bfloat16 state's (2.8e-3, 6.7e-3,
    1.7e-3, 7.7e-5); no ``l2_gap``, as no truth is stored at Re=25."""
    root = make_copy(tmp_path / "copy")
    pkg = root / "ldc_bench"
    config = json.loads((pkg / "configs/vmg-re100.json").read_text())
    config["params"].update(Re=25.0, dtype="float64")
    (pkg / "traffic/t-n24.json").write_text(json.dumps({
        "kind": "solve", "N": 24, "params": {}, "lanes": [{}],
        "perturb": {"key": "lid_velocity", "ulps": 8}, "trace_steps": 400}))
    limits = {"uv_step": 1e-6, "p_step": 5e-6, "wall": 1e-6,
              "uv_cycle": 1e-5, "p_cycle": 3e-5, "unconverged": 0}
    cell = add_cell(root, "small-vmg", config, "t-n24", limits)
    out = run_cell(cell, SEED, 0.5, False, device="cpu", root=root)
    assert out["correct"], out["checks"]
    assert out["checks"]["uv_cycle"]["value"] < 1e-6
    rows = control.readings(cell, [SEED], False, 0, "cpu", root=root,
                            emit=lambda s: None)
    verdict = {r["what"]: judge.over(r["numbers"], limits) for r in rows}
    assert verdict == {"program": False, "bf16": True}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_moved_value_is_not_correct_on_the_card():
    card()
    bench = spec.benchmark()
    config = spec.config(bench, "vmg-re100")
    mix = spec.traffic("n48-solve")
    limits = spec.limits(CELL)
    got = drive.run_job(drive.program(), config, "solve",
                        gen.job(config, mix, SEED, 0), "cuda", spec.ROOT)
    sound = got.lanes[0]
    assert not judge.over(judge.lane_numbers(spec.ROOT, config, sound),
                          limits)
    ref = spec.reference("vmg")
    moved = [np.array(a, np.float64) for a in sound.state]
    moved[0][24, 24] += 1e-3
    for state, reported in (
            control.bf16_answer(spec.ROOT, config, sound),
            (moved, ref_val.l2_errors(spec.ROOT, sound.params,
                                      ref.lane_evaluator(sound.params, 48,
                                                         moved)))):
        nums = judge.lane_numbers(spec.ROOT, config, sound, state=state,
                                  reported=reported)
        assert nums["uv_cycle"] > limits["uv_cycle"], nums
