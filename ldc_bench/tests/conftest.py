"""A small copy of the benchmark for the CPU tests: the real
``BENCHMARK.json`` and data files of ``ldc_bench``, with four small cells
added as files (one of each configuration and job kind), and the
repository's ``data`` linked in. The cells run the program's plain path
on the CPU in a few seconds each."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "ldc_bench"
PERTURB = {"key": "lid_velocity", "ulps": 8}
# Re=100 and small orders keep the plain CPU solves to seconds (the FV
# cells in float64, the port's CPU precision: in float32 the Re=400 lane
# at 16 x 16 stalls at its rounding floor short of the tolerance); the
# limits are set from the CPU readings at tolerance 1e-6 (uv_step ~5.0e-7,
# p_step ~5.7e-6, wall ~5e-9, l2_gap ~1e-17; FV mom ~5.7e-6, flux
# ~6.6e-7), between them and the faults (uv_step ~9.5e-6 and mom ~5.1e-4
# for one value moved by 1e-3, the bfloat16 state ~1.7e-3 and ~1.9e-3;
# FV flux 3.1e-3 for the bfloat16 state, 4.6e-2 for face fluxes without
# the Rhie-Chow correction); the numbers compared are the real cells'.
TINY = {
    "tiny-fsg": ("fsg-re1000", dict(Re=100.0, tolerance=1e-6,
                                    max_iterations=40000, chunk_size=1000)),
    "tiny-fv": ("fv-simple", dict(tolerance=1e-6, max_iterations=5000,
                                  chunk_size=200, dtype="float64")),
}
CELLS = {
    "tiny-fsg.solve": ("tiny-fsg", "t-solve", {
        "kind": "solve", "N": 24, "params": {}, "lanes": [{}],
        "perturb": PERTURB, "trace_steps": 1000}),
    "tiny-fsg.round": ("tiny-fsg", "t-round", {
        "kind": "round", "N": 24, "params": {},
        "lanes": [{"corner_smoothing": 0.1}, {"corner_smoothing": 0.15}],
        "perturb": PERTURB, "permute": True, "trace_steps": 1000}),
    "tiny-fv.solve": ("tiny-fv", "t-fv", {
        "kind": "solve", "N": 16, "params": {}, "lanes": [{}],
        "perturb": PERTURB, "trace_steps": 200}),
    "tiny-fv.round": ("tiny-fv", "t-fvr", {
        "kind": "round", "N": 16, "params": {},
        "lanes": [{"Re": 100.0}, {"Re": 400.0}], "perturb": PERTURB,
        "permute": True, "trace_steps": 200}),
}
LIMITS = {
    "tiny-fsg": {"uv_step": 2e-6, "p_step": 2e-5, "wall": 1e-6,
                 "l2_gap": 1e-9, "unconverged": 0},
    "tiny-fv": {"mom": 5e-5, "flux": 1e-5, "l2_gap": 1e-9, "unconverged": 0},
}


def make_copy(dest: Path) -> Path:
    """The copy described above, at ``dest``."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(PKG, dest / "ldc_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "data").symlink_to(ROOT / "data")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (base, params) in TINY.items():
        cfg = json.loads((PKG / "configs" / f"{base}.json").read_text())
        cfg["params"].update(params)
        (dest / "ldc_bench/configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "small CPU copy",
                                 "file": f"ldc_bench/configs/{name}.json",
                                 "reduced": [], "why": "CPU tests"})
    for cell, (config, mix, body) in CELLS.items():
        (dest / "ldc_bench/traffic" / f"{mix}.json").write_text(
            json.dumps(body))
        (dest / "ldc_bench/limits" / f"{cell}.json").write_text(
            json.dumps(LIMITS[config]))
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU tests"})
        kind = body["kind"]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and m["name"].startswith(
                    ("solve_s", "round_s")) and m["name"] == f"{kind}_s":
                m["workloads"].append(cell)
            elif "workloads" in m and m["name"].endswith(f".{kind}"):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_copy(tmp_path_factory.mktemp("bench"))
