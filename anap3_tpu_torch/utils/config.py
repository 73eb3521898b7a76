"""Hydra-style config composition for the port's driver.

The port's own copy of ``anap3_tpu/utils/config.py``, with the same
semantics over the same ``conf/`` tree:

- a root ``config.yaml`` with a ``defaults`` list of config groups
  (``problem``, ``solver``, ``validation``, ``mlflow``, ``machine``) plus
  ``_self_`` ordering;
- ``# @package <target>`` directives in group files (``_global_`` or a
  dotted path; default = the group path);
- group files with their own ``defaults`` (``solver/spectral/fsg.yaml``
  extends ``/solver/spectral/sg``) and ``override /group: name`` entries in
  experiment overlays;
- CLI overrides: ``key=value`` (dotted), ``group=name`` re-selection,
  ``+experiment/...=name`` overlays, ``~key`` deletion;
- ``${path}`` interpolation against the root and ``${oc.env:VAR,default}``;
- multirun expansion: comma-separated values in CLI overrides and
  ``hydra.sweeper.params``; ``interval(lo,hi)`` ranges are passed through
  for the optimizer (``utils/optimize.py``).

Two differences, both for the port's machine and the port's solvers:

- The YAML is read by ``utils/yaml_subset`` (the card's machine has no
  PyYAML); it resolves every scalar of the conf tree as ``yaml.safe_load``
  does.
- Solver groups are read as the port's: ``fv`` as ``gpu/fv`` and
  ``spectral/<name>`` as ``gpu/<name>`` wherever a solver is selected (the
  root defaults, ``override /solver:`` lines of experiments, the command
  line and sweeper params), so every experiment file runs the port's
  solvers. A group file's own defaults (``gpu/sg.yaml`` extends
  ``/solver/spectral/sg``) are includes, not selections, and stay as
  written. ``instantiate`` builds only ``anap3_tpu_torch.`` targets.
"""

from __future__ import annotations

import copy
import importlib
import itertools
import os
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Tuple

from . import yaml_subset

__all__ = ["compose", "expand_multirun", "instantiate", "ConfigError",
           "Interval", "port_solver_group", "sweeper_params"]

_MISSING = object()  # sentinel for strict-override existence checks
# the only package instantiate() builds from
_TARGET_PREFIX = "anap3_tpu_torch."


class ConfigError(Exception):
    pass


class Interval:
    """A continuous search range ``interval(lo, hi)`` for the optimizer."""

    def __init__(self, lo: float, hi: float):
        self.lo, self.hi = float(lo), float(hi)

    def __repr__(self):
        return f"interval({self.lo}, {self.hi})"


def port_solver_group(name: str) -> str:
    """The port's solver group for a selection: ``fv`` -> ``gpu/fv``,
    ``spectral/<name>`` -> ``gpu/<name>``; anything else as given."""
    name = str(name).strip()
    if name == "fv":
        return "gpu/fv"
    if name.startswith("spectral/"):
        return "gpu/" + name[len("spectral/"):]
    return name


def _select(group: str, name):
    """A group selection as the port reads it."""
    if group.strip("/") == "solver" and name is not None:
        return port_solver_group(name)
    return name


# ---------------------------------------------------------------------------
# YAML loading with @package directive
# ---------------------------------------------------------------------------


def _load_yaml(path: Path) -> Tuple[dict, str | None]:
    text = path.read_text()
    package = None
    m = re.search(r"^#\s*@package\s+(\S+)", text, flags=re.MULTILINE)
    if m:
        package = m.group(1)
    try:
        data = yaml_subset.load(text) or {}
    except yaml_subset.YAMLSubsetError as exc:
        raise ConfigError(f"{path}: {exc}") from exc
    if not isinstance(data, dict):
        raise ConfigError(f"{path} must contain a mapping")
    return data, package


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _set_path(cfg: dict, dotted: str, value) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ConfigError(f"Cannot set {dotted}: {k} is not a mapping")
    node[keys[-1]] = value


def _get_path(cfg: dict, dotted: str, default=...):
    node = cfg
    for k in dotted.split("."):
        if not isinstance(node, dict) or k not in node:
            if default is ...:
                raise ConfigError(f"Missing config key: {dotted}")
            return default
        node = node[k]
    return node


def _del_path(cfg: dict, dotted: str) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.get(k, {})
    node.pop(keys[-1], None)


def _place_at_package(cfg: dict, body: dict, package: str | None,
                      group_path: str) -> None:
    if package in (None, ""):
        package = group_path.replace("/", ".")
    if package == "_global_":
        _deep_merge(cfg, body)
    else:
        target = _get_path(cfg, package, default=None)
        if not isinstance(target, dict):
            _set_path(cfg, package, {})
            target = _get_path(cfg, package)
        _deep_merge(target, body)


# ---------------------------------------------------------------------------
# Group composition
# ---------------------------------------------------------------------------


def _compose_group(conf_dir: Path, group: str, name: str, cfg: dict,
                   replace_package: str | None = None,
                   clear_package: bool = False) -> None:
    """Load conf/<group>/<name>.yaml (recursively resolving its defaults)
    and merge it into cfg at its package target.

    ``clear_package`` implements Hydra's group RE-SELECTION semantics: the
    previous selection's subtree is dropped first, so switching e.g.
    solver=gpu/fv -> solver=gpu/fsg does not leak fv-only keys into the
    spectral parameters."""
    path = conf_dir / group / f"{name}.yaml"
    if not path.exists():
        available = sorted(p.stem for p in (conf_dir / group).glob("*.yaml")) \
            if (conf_dir / group).exists() else []
        raise ConfigError(
            f"Config not found: {group}/{name} (available: {available})")
    body, package = _load_yaml(path)
    if clear_package:
        target = replace_package or package or group.replace("/", ".")
        if target != "_global_":
            _del_path(cfg, target)
    defaults = body.pop("defaults", [])
    # nested defaults inside a group file (e.g. spectral/fsg extends sg)
    for entry in defaults:
        if isinstance(entry, str):
            if entry == "_self_":
                continue
            ref = entry
        elif isinstance(entry, dict):
            ((k, v),) = entry.items()
            if k == "_self_":
                continue
            ref = f"{k}/{v}" if v else k
        else:
            continue
        ref = ref.lstrip("/")
        ref_group, _, ref_name = ref.rpartition("/")
        _compose_group(conf_dir, ref_group, ref_name, cfg,
                       replace_package=replace_package or package
                       or group.replace("/", "."))
    _place_at_package(cfg, body, replace_package or package, group)


def compose(conf_dir, overrides: Iterable[str] = (),
            config_name: str = "config") -> dict:
    """Compose the full config from the tree + CLI-style overrides."""
    conf_dir = Path(conf_dir)
    root_body, _ = _load_yaml(conf_dir / f"{config_name}.yaml")
    defaults: List = root_body.pop("defaults", [])

    overrides = list(overrides)
    group_over: Dict[str, str] = {}
    experiments: List[Tuple[str, str]] = []
    kv_over: List[Tuple[str, Any, bool]] = []
    deletions: List[str] = []
    for ov in overrides:
        if ov.startswith("~"):
            deletions.append(ov[1:])
            continue
        if "=" not in ov:
            raise ConfigError(f"Malformed override: {ov!r}")
        key, val = ov.split("=", 1)
        add = key.startswith("+")
        key = key.lstrip("+")
        if key.startswith("experiment/") or key == "experiment":
            experiments.append((key, val))
        elif (conf_dir / key).is_dir() and not add:
            group_over[key] = _select(key, val)
        else:
            kv_over.append((key, _parse_value(val), add))

    cfg: dict = {}
    self_done = False
    for entry in defaults:
        if entry == "_self_" or (isinstance(entry, dict) and "_self_" in entry):
            _deep_merge(cfg, root_body)
            self_done = True
            continue
        ((group, name),) = entry.items() if isinstance(entry, dict) \
            else ((entry, None),)
        name = group_over.get(group, _select(group, name))
        if name is None:
            continue
        _compose_group(conf_dir, group, str(name), cfg)
    if not self_done:
        _deep_merge(cfg, root_body)

    # experiment overlays (always @package _global_; may carry group
    # overrides)
    for key, val in experiments:
        path = conf_dir / key / f"{val}.yaml"
        body, _pkg = _load_yaml(path)
        for entry in body.pop("defaults", []):
            if isinstance(entry, dict):
                ((k, v),) = entry.items()
                if k == "_self_":
                    continue
                group = k.replace("override ", "").strip().lstrip("/")
                _compose_group(conf_dir, group, str(_select(group, v)), cfg,
                               clear_package=True)
        _deep_merge(cfg, body)

    # CLI group re-selections outrank experiment defaults (Hydra
    # precedence), so re-apply them after the overlays (with replace
    # semantics).
    for group, name in group_over.items():
        _compose_group(conf_dir, group, name, cfg, clear_package=True)

    for key, val, add in kv_over:
        # Hydra parity: a plain key=value override must target an EXISTING
        # key of the composed config (a typo must not look accepted);
        # ``+key=value`` appends a new key, exactly like Hydra.
        if not add and _get_path(cfg, key, default=_MISSING) is _MISSING:
            raise ConfigError(
                f"Could not override {key!r}: no such key in the composed "
                f"config. To append a new key, use +{key}=...")
        _set_path(cfg, key, val)
    for key in deletions:
        _del_path(cfg, key)
    sweep = sweeper_params(cfg)
    if isinstance(sweep.get("solver"), str):  # a sweep over solver groups
        sweep["solver"] = ", ".join(
            _select("solver", name) for name in sweep["solver"].split(","))

    _resolve_interpolations(cfg)
    return cfg


def _parse_value(text: str, allow_sweep: bool = False):
    """Parse one override value.

    Comma-separated sweep lists (``key=a,b``) are only recognized with
    ``allow_sweep=True`` (i.e. in multirun context) — Hydra rejects sweeps
    outside multirun, and silently turning ``a,b`` into a list in a single
    run would change the value type. Bracketed YAML lists (``[a,b]``) are
    always plain list VALUES, never sweeps."""
    text = text.strip()
    m = re.fullmatch(r"interval\(\s*([^,]+)\s*,\s*([^)]+)\s*\)", text)
    if m:
        return Interval(float(m.group(1)), float(m.group(2)))
    if "," in text and not text.startswith(("[", "{")):
        if not allow_sweep:
            raise ConfigError(
                f"Sweep-style value {text!r} is only valid in multirun (-m); "
                f"use a bracketed list [a,b] for a literal list value")
        return [_parse_value(t) for t in text.split(",")]
    try:
        val = yaml_subset.load(text)
    except yaml_subset.YAMLSubsetError:
        return text
    if isinstance(val, str):
        # YAML 1.1 does not resolve "1e-5"-style scientific notation
        try:
            return float(val)
        except ValueError:
            return val
    return val


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


def _resolve_interpolations(cfg: dict, max_passes: int = 10) -> None:
    def resolve_value(val):
        if isinstance(val, str):
            full = _INTERP_RE.fullmatch(val.strip())
            if full:
                return lookup(full.group(1))
            return _INTERP_RE.sub(lambda m: str(lookup(m.group(1))), val)
        return val

    def lookup(expr: str):
        expr = expr.strip()
        if expr.startswith("oc.env:"):
            spec = expr[len("oc.env:"):]
            var, _, default = spec.partition(",")
            return os.environ.get(var.strip(), default.strip() or None)
        return _get_path(cfg, expr)

    def walk(node):
        changed = False
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in list(items):
            if isinstance(v, (dict, list)):
                changed |= walk(v)
            else:
                new = resolve_value(v)
                if new is not v:
                    node[k] = new
                    changed = True
        return changed

    for _ in range(max_passes):
        if not walk(cfg):
            return


# ---------------------------------------------------------------------------
# Multirun expansion & instantiation
# ---------------------------------------------------------------------------


def sweeper_params(cfg: dict) -> dict:
    """``hydra.sweeper.params`` of a composed config ({} when absent)."""
    params = _get_path(cfg, "hydra.sweeper.params", default=None)
    return params if isinstance(params, dict) else {}


def expand_multirun(conf_dir, overrides: Iterable[str] = (),
                    config_name: str = "config") -> List[dict]:
    """Expand sweep parameters into the list of per-job configs.

    Sweeps come from (a) comma-separated CLI overrides, (b) the
    experiment's ``hydra.sweeper.params`` mapping. Group sweeps (e.g.
    ``solver: spectral/sg,spectral/fsg``) recompose the group per job.
    ``Interval`` values are NOT expanded here (the optimizer consumes
    them)."""
    # split comma-valued CLI overrides out BEFORE composing the base config
    # (a sweep like solver=fv,spectral/sg is not a valid single selection)
    sweep: Dict[str, list] = {}
    cli_final: List[str] = []
    cli_keys = set()
    for ov in overrides:
        if "=" in ov and not ov.startswith("~"):
            key, val = ov.split("=", 1)
            cli_keys.add(key.lstrip("+"))
            parsed = _parse_value(val, allow_sweep=True)
            if isinstance(parsed, list) and \
                    not val.strip().startswith(("[", "{")):
                sweep[key.lstrip("+")] = parsed
                continue
        cli_final.append(ov)

    base = compose(conf_dir, cli_final, config_name)

    for k, v in sweeper_params(base).items():
        if k in cli_keys:
            continue  # ANY CLI override of the key outranks the sweeper
        vals = (_parse_value(str(v), allow_sweep=True)
                if not isinstance(v, (list, Interval)) else v)
        if isinstance(vals, Interval):
            continue
        sweep[k] = vals if isinstance(vals, list) else [vals]

    if not sweep:
        return [base]

    keys = list(sweep)
    jobs = []
    for combo in itertools.product(*(sweep[k] for k in keys)):
        job_over = list(cli_final) + [f"{k}={v}" for k, v in zip(keys, combo)]
        jobs.append(compose(conf_dir, job_over, config_name))
    return jobs


def instantiate(node: dict, **extra):
    """Hydra-style ``_target_`` instantiation, of the port's classes only."""
    if "_target_" not in node:
        raise ConfigError("instantiate() requires a _target_ key")
    node = dict(node)
    target = str(node.pop("_target_"))
    if not target.startswith(_TARGET_PREFIX):
        raise ConfigError(
            f"_target_ {target!r} is not a class of the port: instantiate() "
            f"builds only {_TARGET_PREFIX}* targets")
    node.pop("_convert_", None)
    module_name, _, attr = target.rpartition(".")
    cls = getattr(importlib.import_module(module_name), attr)
    node.update(extra)
    return cls(**node)
