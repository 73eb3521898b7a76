"""A small copy of the benchmark for the CPU tests: the real
``BENCHMARK.json`` and data files of ``ldc_bench``, with small cells added
as files (one of each configuration and job kind, and a solve of each of
the VMG, FMG and Newton solvers, which no cell of the benchmark runs), and
the repository's ``data`` linked in. The cells run the program's plain
path on the CPU in seconds each."""

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
#
# The VMG and FMG cells run at N=48, the least order with two levels at
# Re=100 (the FAS floor is ceil(2.4 sqrt(Re)) = 24), to a per-cycle
# tolerance of 1e-3 (264 V-cycles, ~10 s); the Newton cell is a cold
# start at N=16 (8 PTC steps, ~2 s). Their limits lie between the CPU
# readings of seeds 1-4 (VMG / FMG: uv_step 7.10e-6 / 3.13e-6, p_step
# 9.34e-5 / 4.87e-5, wall <= 2.9e-8, l2_gap <= 1.2e-16; Newton: 3.4e-9,
# 2.1e-9, 0, 7e-17) and the bfloat16 state's (uv_step and wall 1.74e-3,
# Newton 1.38e-3; p_step 1.38e-4 / 1.43e-4, Newton 6.7e-4; l2_gap
# 1.0e-4-3.3e-4). At this loose tolerance VMG's p_step lies within 1.5x
# of the bfloat16 state's: its limit only guards against a pressure gone
# wrong, and uv_step, wall and l2_gap refuse the bfloat16 state.
TINY = {
    "tiny-fsg": ("fsg-re1000", "fsg", dict(
        Re=100.0, tolerance=1e-6, max_iterations=40000, chunk_size=1000)),
    "tiny-fv": ("fv-simple", "fv", dict(
        tolerance=1e-6, max_iterations=5000, chunk_size=200,
        dtype="float64")),
    "tiny-vmg": ("fsg-re1000", "vmg", dict(
        name="spectral_vmg", multigrid="vmg", n_levels=3, Re=100.0,
        tolerance=1e-3, max_iterations=40000)),
    "tiny-fmg": ("fsg-re1000", "fmg", dict(
        name="spectral_fmg", multigrid="fmg", n_levels=3,
        coarse_tolerance_factor=10.0, Re=100.0, tolerance=1e-3,
        max_iterations=40000)),
    "tiny-newton": ("fsg-re1000", "newton", dict(
        name="spectral_newton", multigrid="none", Re=100.0, tolerance=1e-6,
        dtype="float64", newton_max_steps=50, gmres_vectors=60,
        newton_dt0=0.05, newton_dt_max=3e3, newton_schur_iters=40,
        newton_prelude=0, initial_state_path="")),
}
SOLVE = {"kind": "solve", "params": {}, "lanes": [{}], "perturb": PERTURB}
CELLS = {
    "tiny-fsg.solve": ("tiny-fsg", "t-solve", dict(
        SOLVE, N=24, trace_steps=1000)),
    "tiny-fsg.round": ("tiny-fsg", "t-round", {
        "kind": "round", "N": 24, "params": {},
        "lanes": [{"corner_smoothing": 0.1}, {"corner_smoothing": 0.15}],
        "perturb": PERTURB, "permute": True, "trace_steps": 1000}),
    "tiny-fv.solve": ("tiny-fv", "t-fv", dict(
        SOLVE, N=16, trace_steps=200)),
    "tiny-fv.round": ("tiny-fv", "t-fvr", {
        "kind": "round", "N": 16, "params": {},
        "lanes": [{"Re": 100.0}, {"Re": 400.0}], "perturb": PERTURB,
        "permute": True, "trace_steps": 200}),
    "tiny-vmg.solve": ("tiny-vmg", "t-n48", dict(
        SOLVE, N=48, trace_steps=400)),
    "tiny-fmg.solve": ("tiny-fmg", "t-n48", dict(
        SOLVE, N=48, trace_steps=400)),
    "tiny-newton.solve": ("tiny-newton", "t-n16", dict(
        SOLVE, N=16, trace_steps=400)),
}
LIMITS = {
    "tiny-fsg": {"uv_step": 2e-6, "p_step": 2e-5, "wall": 1e-6,
                 "l2_gap": 1e-9, "unconverged": 0},
    "tiny-fv": {"mom": 5e-5, "flux": 1e-5, "l2_gap": 1e-9, "unconverged": 0},
    "tiny-vmg": {"uv_step": 5e-5, "p_step": 3e-4, "wall": 1e-6,
                 "l2_gap": 1e-9, "unconverged": 0},
    "tiny-fmg": {"uv_step": 5e-5, "p_step": 3e-4, "wall": 1e-6,
                 "l2_gap": 1e-9, "unconverged": 0},
    "tiny-newton": {"uv_step": 1e-6, "p_step": 1e-5, "wall": 1e-6,
                    "l2_gap": 1e-9, "unconverged": 0},
}


def make_copy(dest: Path) -> Path:
    """The copy described above, at ``dest``."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(PKG, dest / "ldc_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "data").symlink_to(ROOT / "data")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (base, solver, params) in TINY.items():
        cfg = json.loads((PKG / "configs" / f"{base}.json").read_text())
        cfg["solver"] = solver
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
