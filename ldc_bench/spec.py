"""Find what belongs to a cell by its name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic mix (``traffic/<name>.json``), the
limits of its correctness check (``limits/<cell>.json``), the plain
reference its configuration names (``reference/<name>.py``) and the reader
of each metric (``metrics/<metric>.py``, else ``metrics/<stem>.py`` with
the metric's last dotted part taken off). A later cell, mix, reference or
metric is a new file; nothing here names one."""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(__file__).resolve().parent.name


class SpecError(ValueError):
    """A cell, a file or a reader that the benchmark cannot find."""


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def _data(root: Path, folder: str, name: str) -> dict:
    path = Path(root) / PACKAGE / folder / f"{name}.json"
    if not path.exists():
        raise SpecError(f"no file {path}")
    return json.loads(path.read_text())


def traffic(name: str, root: Path = ROOT) -> dict:
    return _data(root, "traffic", name)


def limits(cell_name: str, root: Path = ROOT) -> dict:
    return _data(root, "limits", cell_name)


def metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: end-to-end with ``trace``
    off, per-layer with it on; a metric with ``workloads`` only in those
    cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def _exec(path: Path, name: str):
    """The module of the file ``path``, executed anew under ``name`` (its
    package imported first, so that its relative imports resolve)."""
    importlib.import_module(name.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of a metric's reader file."""
    folder = Path(root) / PACKAGE / "metrics"
    for stem in (name, name.rsplit(".", 1)[0]):
        path = folder / f"{stem}.py"
        if path.exists():
            return _exec(path, f"{PACKAGE}.metrics.{stem.replace('.', '_')}"
                         ).read
    raise SpecError(f"no reader for metric {name!r} in {folder}")


_exec_once = functools.lru_cache(maxsize=None)(_exec)


def reference(name: str, root: Path = ROOT):
    """The plain reference module ``reference/<name>.py``, loaded once a
    process. It exposes ``lane_numbers(params, n, state)``, the judged
    numbers of a lane's final state, and ``lane_evaluator(params, n,
    state)``, a function ``(x, y) -> (u, v)`` at points for the
    validation worked out again (``reference/validation.l2_errors``)."""
    path = (Path(root) / PACKAGE / "reference" / f"{name}.py").resolve()
    if not path.exists():
        raise SpecError(f"no reference {name!r}: no file {path}")
    return _exec_once(path, f"{PACKAGE}.reference.{name.replace('.', '_')}")
