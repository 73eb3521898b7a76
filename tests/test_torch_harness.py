"""The port's experiment harness against the JAX package's, on the CPU:
``anap3_tpu_torch/utils/{yaml_subset,config,tracking,optimize}.py`` and the
validation tables of ``analysis/validation.py``.

- Every file under ``conf/`` reads as ``yaml.safe_load`` reads it, and the
  port's YAML writer reads back as the data through ``yaml.safe_load``.
- ``compose`` and ``expand_multirun`` give the JAX package's configs on the
  override sets of ``tests/test_harness.py::TestConfig`` and on every
  experiment file. The port reads the solver groups ``fv`` and
  ``spectral/<name>`` as ``gpu/fv`` and ``gpu/<name>``, so the JAX side
  composes a copy of ``conf/`` whose solver selections (root defaults,
  ``override /solver:`` lines, sweeper params) and overrides are written
  as ``gpu/*``. Both refuse the same malformed overrides; the port's
  ``instantiate`` refuses a target outside the port.
- ``TPESampler`` asks the same parameters over 3 rounds for the same seed
  and tells.
- A tracking store written by either package reads the same through the
  other: runs, params, metrics (last values and step histories), tags, the
  ``search_runs`` filters, the YAML and table artifacts.
- The Botella and Saad rows and both objectives equal the JAX package's.
"""

import json
import math
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import yaml

from anap3_tpu.analysis import validation as JV
from anap3_tpu.utils import config as JC
from anap3_tpu.utils import optimize as JO
from anap3_tpu.utils import tracking as JT
from anap3_tpu_torch.analysis import validation as PV
from anap3_tpu_torch.utils import config as PC
from anap3_tpu_torch.utils import optimize as PO
from anap3_tpu_torch.utils import tracking as PT
from anap3_tpu_torch.utils import yaml_subset

ROOT = Path(__file__).resolve().parent.parent
CONF = ROOT / "conf"
CONF_FILES = sorted(str(p.relative_to(CONF)) for p in CONF.rglob("*.yaml"))
EXPERIMENTS = sorted(
    str(p.relative_to(CONF / "experiment").with_suffix(""))
    for p in (CONF / "experiment").rglob("*.yaml"))


@pytest.mark.parametrize("name", CONF_FILES)
def test_conf_file_reads_as_safe_load(name):
    text = (CONF / name).read_text()
    want = yaml.safe_load(text)
    got = yaml_subset.load(text)
    assert got == want and repr(got) == repr(want)


@pytest.mark.parametrize("text,want", [
    ("1.0e-6", 1e-6), ("1e-6", "1e-6"), ("3e3", "3e3"), ("on", True),
    ("017", 15), ("0x1F", 31), ("1:30", 90), ("~", None), ("[x]", ["x"]),
    ("{a: 1, b: [2, 3]}", {"a": 1, "b": [2, 3]}), ("'it''s'", "it's"),
    ("a: 1 # c\nb:\n- x\n- y: 2\n  z: null\n",
     {"a": 1, "b": ["x", {"y": 2, "z": None}]}),
])
def test_scalars_and_blocks_read_as_safe_load(text, want):
    assert yaml.safe_load(text) == want
    assert yaml_subset.load(text) == want


def test_writer_reads_back_through_safe_load():
    data = {"artifact_uri": "/a b/artifacts", "end_time": None,
            "entry_point_name": "", "experiment_id": "1", "run_id": "0123",
            "status": 3, "x": 1e-05, "w": "1e-9", "v": "yes", "u": "a: b",
            "t": "-x", "s": "#x", "r": [], "q": {}, "n": 3.0,
            "p": ["a", {"k": 1, "j": [1, 2]}, [1, [2]]], "o": "hé\nx",
            "solver": {"mesh_axes": ["x"], "tolerance": 1e-06}}
    text = yaml_subset.dump(data)
    assert yaml.safe_load(text) == data
    assert yaml_subset.load(text) == data
    assert yaml_subset.load(yaml.safe_dump(data)) == data


# ---------------------------------------------------------------- config

_SELECTION = re.compile(r"^(\s*-?\s*(?:override /)?solver:\s*)(.+)$")


def _gpu(name: str) -> str:
    return ", ".join(PC.port_solver_group(n) for n in name.split(","))


@pytest.fixture(scope="module")
def gpu_conf(tmp_path_factory):
    """conf/ with every solver selection written as the port's group."""
    dst = tmp_path_factory.mktemp("conf") / "conf"
    shutil.copytree(CONF, dst)
    for path in dst.rglob("*.yaml"):
        if "solver" in path.relative_to(dst).parts[:1]:
            continue  # group files: their defaults are includes
        lines = []
        for line in path.read_text().splitlines():
            m = _SELECTION.match(line)
            if m and m.group(2).strip():
                line = m.group(1) + _gpu(m.group(2))
            lines.append(line)
        path.write_text("\n".join(lines) + "\n")
    return dst


def _gpu_override(ov: str) -> str:
    key, eq, val = ov.partition("=")
    return f"{key}={_gpu(val)}" if eq and key == "solver" else ov


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_plain(v) for v in node]
    if isinstance(node, (JC.Interval, PC.Interval)):
        return ("interval", node.lo, node.hi)
    return node


COMPOSE_SETS = [
    [], ["solver=spectral/sg", "N=48", "Re=400"], ["solver=spectral/fsg"],
    ["solver=spectral/sg", "solver.corner_smoothing=0.25"],
    ["solver=spectral/sg", "+new_knob=3"],
    ["solver=spectral/sg", "+solver.extra=a"],
    ["+experiment/validation/ghia=spectral"],
    ["solver=spectral/sg", "solver.corner_smoothing=interval(0.02,0.35)"],
    ["tolerance=1e-5"], ["solver=fv", "N=8", "max_iterations=10"],
    ["mlflow=remote"], ["+machine.mesh_axes=[sweep,x]"],
    ["+experiment/optimization=corner_smoothing"],
    ["+experiment/validation/ghia=spectral", "solver=fv"],
    ["solver=spectral/newton", "solver.newton_dt_max=1e3", "~plot_only"],
]
MULTIRUN_SETS = [
    ["solver=spectral/sg", "N=16,32", "Re=100,400"],
    ["+experiment/validation/ghia=spectral"],
    ["+experiment/validation/high_re=spectral"],
    ["+experiment/validation/saad=spectral", "N=16"],
    ["+experiment/validation/ghia=spectral", "N=16,20"],
    ["solver=spectral/sg", "N=12", "Re=100,400"],
    ["solver=fv,spectral/sg", "N=10", "Re=100,150"],
]


def _experiment(e: str) -> str:
    group, _, name = e.rpartition("/")
    return f"+experiment/{group}={name}"


@pytest.mark.parametrize("overrides", COMPOSE_SETS + [
    [_experiment(e)] for e in EXPERIMENTS], ids=str)
def test_compose_matches_jax(gpu_conf, overrides, monkeypatch):
    monkeypatch.setenv("MLFLOW_TRACKING_URI", "remote-store")
    got = PC.compose(CONF, overrides)
    want = JC.compose(gpu_conf, [_gpu_override(o) for o in overrides])
    assert _plain(got) == _plain(want)
    assert got["solver"]["_target_"].startswith("anap3_tpu_torch.")


@pytest.mark.parametrize("overrides", MULTIRUN_SETS + [
    [_experiment(e)] for e in EXPERIMENTS], ids=str)
def test_expand_multirun_matches_jax(gpu_conf, overrides):
    got = PC.expand_multirun(CONF, overrides)
    want = JC.expand_multirun(gpu_conf, [_gpu_override(o) for o in overrides])
    assert [_plain(j) for j in got] == [_plain(j) for j in want]


@pytest.mark.parametrize("overrides", [
    ["solver=spectral/sg", "convergence_metric=energy"],
    ["solver=spectral/sg", "solvr.CFL=1.0"], ["Re=100,400"], ["N"],
    ["solver=spectral/nope"]])
def test_both_refuse_the_same_overrides(overrides):
    with pytest.raises(JC.ConfigError):
        JC.compose(CONF, overrides)
    with pytest.raises(PC.ConfigError):
        PC.compose(CONF, overrides)


def test_instantiate_builds_only_the_port():
    cfg = PC.compose(CONF, ["solver=fv", "N=8", "max_iterations=10",
                            "solver.device=cpu"])
    solver = PC.instantiate(cfg["solver"])
    assert type(solver).__module__ == "anap3_tpu_torch.models.fv"
    with pytest.raises(PC.ConfigError, match="not a class of the port"):
        PC.instantiate(dict(cfg["solver"],
                            _target_="anap3_tpu.models.fv.FVSolver"))


# ---------------------------------------------------------------- TPE


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_asks_the_same_over_three_rounds(seed):
    def space(mod):
        return {"solver.corner_smoothing": mod.Interval(0.01, 0.10),
                "N": [30, 40, 50]}

    def objective(p):
        return (p["solver.corner_smoothing"] - 0.04) ** 2 + (
            math.inf if p["N"] == 30 else p["N"] * 1e-4)

    samplers = [mod.TPESampler(space(cfg), n_startup_trials=5, seed=seed)
                for mod, cfg in ((JO, JC), (PO, PC))]
    for _ in range(3):
        asks = [s.ask_batch(4) for s in samplers]
        assert asks[0] == asks[1]
        for s in samplers:
            for p in asks[0]:
                s.tell(p, objective(p))
    assert samplers[0].best == samplers[1].best


# ---------------------------------------------------------------- tracking


def _write_store(T, root):
    """A parent, two children (params, metrics with steps, tags, YAML and
    table artifacts) and a failed run, through tracking module T."""
    T.set_tracking_uri(root)
    T.set_experiment("Exp")
    parent = T.create_detached_run(run_name="sweep",
                                   tags={"is_parent": "true"})
    for re_, n in ((100, 12), (400, 16)):
        with T.start_run(run_name=f"spectral_N{n + 1}",
                         tags={"solver": "spectral",
                               "mlflow.parentRunId": parent.run_id,
                               "sweep": "child"}) as run:
            T.log_params({"Re": float(re_), "nx": n, "name": "spectral"})
            T.log_metrics({"u_L2_error": 0.125 * re_, "converged": 1})
            T.log_metric("rel_iter_residual", 0.5, step=0)
            T.log_batch(run.run_id, [("energy", 0.1, 0), ("energy", 0.2, 1),
                                     ("energy", 0.25, 7)])
            T.log_dict({"N": n, "tolerance": 1e-6, "solver": {
                "mesh_axes": ["x"], "corner_smoothing": "interval(0.1, 0.2)"}},
                "config.yaml")
            T.log_table([{"trial": 0, "x": 0.5, "objective": 0.25},
                         {"trial": 1, "x": 0.75, "objective": math.inf}],
                        "optuna_trials.json")
    with pytest.raises(ValueError):
        with T.start_run(run_name="broken"):
            raise ValueError("a failed run")
    with T.attach_run(parent.run_id):
        T.log_metrics({"best_objective": 0.25})
    return parent.run_id


def _queries(T, root, parent):
    T.set_tracking_uri(root)
    out = {}
    for key, kw in {
            "all": {}, "finished": {"status": "FINISHED"},
            "failed": {"status": "FAILED"},
            "Re": {"params": {"Re": 400.0, "nx": 16}},
            "parent": {"tags": {"is_parent": "true",
                                "mlflow.runName": "sweep"}},
            "children": {"parent_run_id": parent}}.items():
        runs = T.search_runs("Exp", **kw)
        out[key] = sorted(
            (r["run_id"], r["run_name"], r["status"], r["experiment_id"],
             r["params"], r["tags"], r["metrics"]) for r in runs)
        for r in runs:
            out[(key, r["run_id"], "energy")] = T.get_metric_history(
                r["run_id"], "energy")
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_reads_the_same_through_either_package(tmp_path, writer):
    root = tmp_path / "mlruns"
    parent = _write_store(JT if writer == "jax" else PT, root)
    jq, pq = _queries(JT, root, parent), _queries(PT, root, parent)
    assert jq == pq
    assert len(pq["children"]) == 2 and len(pq["failed"]) == 1
    assert pq[("Re", pq["Re"][0][0], "energy")] == [(0, 0.1), (1, 0.2),
                                                    (7, 0.25)]
    for run_dir in root.glob("*/*/artifacts"):
        cfg = run_dir / "config.yaml"
        if cfg.exists():
            assert yaml_subset.load(cfg.read_text()) == yaml.safe_load(
                cfg.read_text())
    for meta in root.rglob("meta.yaml"):
        assert yaml_subset.load(meta.read_text()) == yaml.safe_load(
            meta.read_text())


def test_both_packages_write_the_same_artifacts(tmp_path):
    roots = {name: tmp_path / name for name in ("jax", "port")}
    _write_store(JT, roots["jax"])
    _write_store(PT, roots["port"])
    files = {name: sorted(
        (p.name, p.read_text()) for p in root.glob("*/*/artifacts/*")
        if p.name in ("config.yaml", "optuna_trials.json"))
        for name, root in roots.items()}
    assert files["jax"] == files["port"] and len(files["port"]) == 4


# ---------------------------------------------------------------- tables


def _metrics(**kw):
    base = dict(psi_min=-0.118, omega_center=2.06, psi_min_x=0.47,
                psi_min_y=0.56, psi_BL=2.1e-4, omega_BL=1.1, psi_BL_x=0.13,
                psi_BL_y=0.11, psi_BR=1.7e-3, omega_BR=1.12, psi_BR_x=0.86,
                psi_BR_y=0.11, final_energy=0.0223,
                final_enstrophy=4.79, final_palinstrophy=8.1e3)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("re_", [100.0, 400.0, 1000.0, 3200.0])
def test_botella_rows_and_objectives_match_jax(re_):
    m = _metrics()
    assert PV.botella_validation_rows(m, re_, base_dir=ROOT) == \
        JV.botella_validation_rows(m, re_, base_dir=ROOT)
    assert PV.botella_vortex_objective(m, re_, base_dir=ROOT) == \
        JV.botella_vortex_objective(m, re_, base_dir=ROOT)
    errs = {"u_L2_error": 0.03, "v_L2_error": 0.04}
    assert PV.fv_l2_objective(errs) == JV.fv_l2_objective(errs)


@pytest.mark.parametrize("re_", [1000.0, 100.0])
def test_saad_rows_match_jax(re_):
    m = _metrics()
    got = PV.saad_quantities_rows(m, re_, "40x40", base_dir=ROOT)
    assert got == JV.saad_quantities_rows(m, re_, "40x40", base_dir=ROOT)
    assert (got is None) == (re_ != 1000.0)


def test_tables_log_as_pandas_lays_them_out():
    import pandas as pd

    m = _metrics()
    for rows in (JV.botella_validation_rows(m, 1000.0, base_dir=ROOT),
                 JV.saad_quantities_rows(m, 1000.0, "40x40", base_dir=ROOT),
                 [{"trial": 0, "N": 30, "objective": 0.5},
                  {"trial": 1, "N": 40, "objective": math.inf}],
                 [{"trial": 0, "N": 30}, {"trial": 1, "N": 40}],
                 [{"a": "x", "b": 1}, {"a": "y"}]):
        df = pd.DataFrame(rows)
        want = {"columns": list(df.columns), "data": df.values.tolist()}
        assert json.dumps(PT.table_payload(rows)) == json.dumps(want)
