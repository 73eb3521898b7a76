"""Solvers and references named by file. The VMG, FMG and Newton cells of
``conftest.py``, added to the copy as files only, run whole on the CPU and
read ``correct``, with every harness module of the copy the repository's
own; a step that returns its state unchanged makes the VMG cell read
not correct; the
solver table covers every solver class the port's ``conf/solver/gpu``
files target; a reference added as a new file is found and used; an
unknown solver or reference raises ``SpecError``; and the readers that
model an RK4 step or a SIMPLE iteration read nothing for a solver whose
iterations are something else."""

import json
import re

import pytest

from anap3_tpu_torch.models.params import FVParameters, SpectralParameters
from ldc_bench import drive, judge, spec
from ldc_bench.drive import Job, Lane
from ldc_bench.metrics import _program
from ldc_bench.run import run_cell
from ldc_bench.tests.conftest import PKG, ROOT, make_copy
from ldc_bench.tests.test_bench_faults import unchanged_step

NEW = ["tiny-vmg.solve", "tiny-fmg.solve", "tiny-newton.solve"]


def run(root, cell):
    return run_cell(cell, 20261019, 0.5, False, device="cpu", root=root)


def harness_code(pkg):
    return sorted(p.relative_to(pkg) for p in pkg.rglob("*.py")
                  if "tests" not in p.relative_to(pkg).parts)


@pytest.mark.parametrize("cell", NEW)
def test_a_solver_added_as_files_runs_correct(tiny_root, cell):
    out = run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    # no chunk runner marched: VMG smooths by sweeps and Newton takes PTC
    # steps; FMG's coarsest level takes the plain step here (on a card it
    # runs the SG chunk kernel, which counts: frozen_steps keys on the
    # solver, not on the counter)
    assert _program.counter("STEPS") == 0
    copy = tiny_root / "ldc_bench"
    assert harness_code(copy) == harness_code(PKG)
    for rel in harness_code(PKG):
        assert (copy / rel).read_bytes() == (PKG / rel).read_bytes(), rel


def test_a_broken_vmg_path_is_not_correct(tiny_root, monkeypatch):
    # every smoothing sweep's step returns its state unchanged (the fault
    # test_bench_faults.py plants in the FSG cell): the cycles stop at once
    unchanged_step(monkeypatch)
    out = run(tiny_root, "tiny-vmg.solve")
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


def test_the_solver_table_covers_every_gpu_target():
    targets = {re.search(r"^_target_:\s*(\S+)", p.read_text(), re.M)[1]
               for p in (ROOT / "conf/solver/gpu").glob("*.yaml")}
    solvers = drive.program()["solvers"]
    assert {drive.class_path(cls) for cls, _ in solvers.values()} == targets
    for name, (_, params) in solvers.items():
        assert params is (FVParameters if name == "fv"
                          else SpectralParameters)


def add_cell(root, name, config, mix, limits):
    """Register a new solve cell ``<name>.solve`` of the configuration
    ``config`` in the copy at ``root``, as files and entries only."""
    pkg, cell = root / "ldc_bench", f"{name}.solve"
    (pkg / f"configs/{name}.json").write_text(json.dumps(config))
    (pkg / f"limits/{cell}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"ldc_bench/configs/{name}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": name, "traffic": mix,
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "solve_s":
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


def test_a_reference_added_as_a_file_is_found_and_used(tmp_path):
    root = make_copy(tmp_path / "copy")
    pkg = root / "ldc_bench"
    (pkg / "reference/spectral_probe.py").write_text(
        "from . import spectral\n\n"
        "lane_evaluator = spectral.lane_evaluator\n\n\n"
        "def lane_numbers(params, n, state):\n"
        "    return dict(spectral.lane_numbers(params, n, state),\n"
        "                probe=float(n))\n")
    config = json.loads((pkg / "configs/tiny-newton.json").read_text())
    config["reference"] = "spectral_probe"
    limits = json.loads((pkg / "limits/tiny-newton.solve.json").read_text())
    cell = add_cell(root, "probe", config, "t-n16", dict(limits, probe=16))
    out = run(root, cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["probe"] == {"value": 16.0, "limit": 16}


def test_an_unknown_solver_or_reference_raises(tiny_root):
    prog = drive.program()
    with pytest.raises(spec.SpecError, match=r"'lbm'.*'fmg'.*'newton'"):
        drive.make_solver(prog, {"solver": "lbm"}, {}, "cpu")
    lane = Lane(params={}, n=16, state=(), converged=True, iterations=1,
                levels=[(16, 1)], validation={})
    with pytest.raises(spec.SpecError, match=r"nowhere\.py"):
        judge.lane_numbers(tiny_root, {"reference": "nowhere"}, lane)
    # run_batched batches SG, FSG and FV lanes only: a VMG round is
    # refused before anything is built
    with pytest.raises(spec.SpecError, match="'vmg'"):
        drive.run_job(prog, {"solver": "vmg"}, "round", [{}, {}], "cpu",
                      tiny_root)


@pytest.mark.parametrize("solver, counts", [
    ("vmg", True), ("fmg", False), ("newton", True), ("sg", True)])
def test_readers_of_steps_follow_the_solver(solver, counts):
    lanes = [Lane(params={}, n=48, state=(), converged=True, iterations=300,
                  levels=[(24, 100), (48, 200)], validation={})]
    job = Job(kind="solve", lanes=lanes, build_s=0.01, step_s=2.0,
              validate_s=0.1, wall_s=2.11)
    tr = {"job": job, "busy_s": 1.0, "window_s": 3.0, "idle_gaps": [],
          "span_busy_s": {"solve": 0.5}}
    ctx = {"kind": "solve", "jobs": [job], "window_s": 10.0, "setup_s": 1.0,
           "launches": 600, "trace": tr,
           "config": {"solver": solver, "params": {"dtype": "float32"}}}
    read = lambda name: spec.reader(name)(ctx, name)
    # a V-cycle, a PTC step and FMG's mixed levels are no RK4 steps
    assert (read("kernel_roofline.solve") is not None) == (solver == "sg")
    if solver != "sg":
        assert read("frozen_steps.solve") is None
    for name in ("iterations.solve", "steps_per_s.solve",
                 "launches_per_step.solve"):
        assert (read(name) is not None) == counts, name
    assert read("iterations.solve") in (None, 300)
