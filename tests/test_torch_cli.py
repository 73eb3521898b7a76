"""The port's CLI (``python -m anap3_tpu_torch``, anap3_tpu_torch/main.py)
on the CPU, against the root driver (``main.py``) on the same overrides.

Small solves only: SG at N <= 12 in float64 (``solver.device=cpu``), <= 300
iterations, ``plots=false``.

- One solve through both drivers: the same iterations, every logged
  metric within 1e-12 relative (wall-time and timing metrics excepted; the
  L2 validation errors among them), the same Botella table.
- A 2-lane ``-m`` sweep runs as one batch (``parallel/batched.run_batched``,
  "batched group: 2 lanes"); each lane takes the iterations and the bits
  of its one-lane ``SGSolver.solve()``.
- A 3-trial optimization at N=10 writes ``optuna_trials.json`` with 3
  trials on the parent run.
- In a subprocess where ``jax``, ``anap3_tpu``, ``yaml``, ``pandas`` and
  ``matplotlib`` cannot be imported (a ``sys.meta_path`` finder refuses
  them), ``python -m anap3_tpu_torch`` (``__main__.py``, by runpy) runs a
  single solve and ``main.main`` the 2-lane sweep.
- ``+machine.mesh_axes=[x]`` at 2 gloo ranks (``launch_local_ranks``)
  runs the x-sharded solve; its state is within 1e-11 of the unsharded
  solve's, and rank 0's store holds the run once.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from anap3_tpu_torch import main as cli
from anap3_tpu_torch.parallel import batched as TB
from anap3_tpu_torch.parallel import distributed as D
from anap3_tpu_torch.utils import config as C
from anap3_tpu_torch.utils import tracking as TT

import torch_ranks as R

torch.set_num_threads(1)

SMALL = ["solver.device=cpu", "solver.dtype=float64", "plots=false"]
# N=12 SG at Re=100/400 converges at 126 / 251 iterations at this tolerance
SWEEP = ["solver=gpu/sg", "N=12", "tolerance=5e-3", "max_iterations=300"]
# metrics that time the run, not its numbers
TIMED = ("wall_time_seconds", "timesteps_per_sec", "first_chunk_seconds")


def rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-300)


def runs_of(store, experiment):
    TT.set_tracking_uri(store)
    return TT.search_runs(experiment, status="FINISHED")


class Kept:
    """The solvers the port's driver solves: run_solver's and the
    batches'."""

    def __init__(self, monkeypatch):
        self.solvers = []
        run_solver, run_batched = cli.run_solver, TB.run_batched

        def solver_kept(*a, **kw):
            out = run_solver(*a, **kw)
            self.solvers.append(out[2])
            return out

        def batch_kept(solvers, *a, **kw):
            self.solvers.extend(solvers)
            return run_batched(solvers, *a, **kw)

        monkeypatch.setattr(cli, "run_solver", solver_kept)
        monkeypatch.setattr(TB, "run_batched", batch_kept)


def test_single_solve_matches_the_root_driver(tmp_path, monkeypatch):
    import main as root_main

    monkeypatch.chdir(tmp_path)
    over = ["solver=gpu/sg", "N=12", "Re=100", "tolerance=1e-3",
            "max_iterations=300", "experiment_name=CLI"] + SMALL
    root_obj = root_main.main(over + [f"mlflow.tracking_uri={tmp_path}/root"])
    port_obj = cli.main(over + [f"mlflow.tracking_uri={tmp_path}/port"])
    (root,), (port,) = runs_of(tmp_path / "root", "CLI"), \
        runs_of(tmp_path / "port", "CLI")
    assert port["run_name"] == root["run_name"] == "spectral_N13"
    assert port["tags"]["solver"] == root["tags"]["solver"]
    assert port["params"] == root["params"]
    assert port["metrics"]["iterations"] == root["metrics"]["iterations"] \
        == 300
    assert sorted(port["metrics"]) == sorted(root["metrics"])
    for key, want in root["metrics"].items():
        if key in TIMED or key.startswith("time_"):
            continue
        assert rel(port["metrics"][key], want) <= 1e-12, key
    for key in ("u_L2_error", "v_L2_error"):
        assert key in port["metrics"]
    assert rel(port_obj, root_obj) <= 1e-12
    tables = [json.loads((Path(r["path"]) / "artifacts" /
                          "validation_metrics.json").read_text())
              for r in (root, port)]
    assert tables[0] == tables[1]


def test_sweep_runs_as_one_batch(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    kept = Kept(monkeypatch)
    caplog.set_level(logging.INFO, logger="main")
    objectives = cli.main(["-m", *SWEEP, "Re=100,400", "experiment_name=S",
                           "sweep_name=s",
                           f"mlflow.tracking_uri={tmp_path}/mlruns"] + SMALL)
    assert len(objectives) == 2 and all(np.isfinite(objectives))
    assert "=== batched group: 2 lanes ===" in caplog.text
    children = [r for r in runs_of(tmp_path / "mlruns", "S")
                if r["tags"].get("sweep") == "child"]
    assert sorted(float(r["params"]["Re"]) for r in children) == [100.0,
                                                                   400.0]
    assert all(r["tags"]["wall_time_scope"] == "batch" for r in children)
    assert len(kept.solvers) == 2
    for lane, re in zip(kept.solvers, (100, 400)):
        cfg = C.compose(cli.CONF_DIR, SWEEP + [f"Re={re}"] + SMALL)
        one = C.instantiate(cfg["solver"])
        one.solve()
        assert one.metrics.converged and lane.metrics.converged
        assert one.metrics.iterations == lane.metrics.iterations < 300
        for a, b in zip(one.state, lane.state):
            assert torch.equal(a, b)


def test_optimization_writes_its_trials(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    best = cli.main([
        "-m", "solver=gpu/sg", "N=10", "Re=100", "tolerance=1e-3",
        "max_iterations=300", "solver.corner_smoothing=interval(0.05,0.3)",
        "+optuna.objective=fv_l2_error", "+optuna.n_trials=3",
        "+optuna.n_startup_trials=2", "+optuna.seed=0",
        "experiment_name=O", "sweep_name=o",
        f"mlflow.tracking_uri={tmp_path}/mlruns"] + SMALL)
    assert np.isfinite(best)
    TT.set_tracking_uri(tmp_path / "mlruns")
    runs = TT.search_runs("O")
    (parent,) = [r for r in runs if r["tags"].get("is_parent") == "true"]
    trials = json.loads((Path(parent["path"]) / "artifacts" /
                         "optuna_trials.json").read_text())
    assert trials["columns"] == ["trial", "solver.corner_smoothing",
                                 "objective"]
    assert len(trials["data"]) == 3
    assert parent["metrics"]["best_objective"] == best
    assert len([r for r in runs if r["tags"].get("sweep") == "child"]) == 3


_BLOCKED_CLI = r"""
import sys

BLOCKED = ("jax", "jaxlib", "anap3_tpu", "yaml", "pandas", "matplotlib")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is not installed")
        return None

sys.meta_path.insert(0, Refuse())
import runpy

store, small, sweep = sys.argv[1], sys.argv[2].split(), sys.argv[3].split()
# python -m anap3_tpu_torch <overrides>, then the sweep
sys.argv = ["anap3_tpu_torch"] + sweep + [
    "Re=100", "experiment_name=one", f"mlflow.tracking_uri={store}"] + small
runpy.run_module("anap3_tpu_torch", run_name="__main__", alter_sys=True)
from anap3_tpu_torch.main import main

main(["-m"] + sweep + ["Re=100,400", "experiment_name=two",
                       f"mlflow.tracking_uri={store}"] + small)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("CLI OK")
"""


def test_cli_runs_without_jax_yaml_pandas_matplotlib(tmp_path, repo_root):
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CLI, str(tmp_path / "mlruns"),
         " ".join(SMALL), " ".join(SWEEP)],
        cwd=tmp_path, capture_output=True, text=True, timeout=240,
        env=dict({k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR")
                  if k in os.environ}, PYTHONPATH=str(repo_root),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CLI OK" in proc.stdout
    assert "=== batched group: 2 lanes ===" in proc.stderr
    TT.set_tracking_uri(tmp_path / "mlruns")
    assert len(TT.search_runs("one", status="FINISHED")) == 1
    assert len([r for r in TT.search_runs("two", status="FINISHED")
                if r["tags"].get("sweep") == "child"]) == 2


def test_x_sharded_solve_at_two_ranks(tmp_path):
    over = ["solver=gpu/sg", "N=11", "Re=100", "tolerance=0",
            "max_iterations=200", "solver.chunk_size=100",
            "experiment_name=X",
            f"mlflow.tracking_uri={tmp_path}/mlruns"] + SMALL
    out = D.launch_local_ranks(2, R.cli_sharded_job,
                               {"out_dir": str(tmp_path), "overrides": over},
                               device="cpu", timeout=180)
    assert [o["sharded"] for o in out] == [True, True]
    assert [o["iterations"] for o in out] == [200, 200]
    assert out[0]["runs"] == 1
    one = C.instantiate(C.compose(cli.CONF_DIR, over)["solver"])
    one.solve()
    got = np.load(tmp_path / "cli_sharded.npz")
    for key, want in zip(("u", "v", "p"), one.state):
        want = want.numpy()
        err = np.max(np.abs(got[key] - want)) / np.max(np.abs(want))
        assert err <= 1e-11, (key, err)
