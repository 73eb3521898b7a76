"""A configuration, a traffic mix and a metric added as new files are
found by name, with no file of the harness edited: in a copy of the
benchmark, a new cell of a new configuration and a new mix, with a new
end-to-end metric read by a new reader, runs end to end on the CPU."""

import json
from pathlib import Path

from ldc_bench import spec
from ldc_bench.run import run_cell
from ldc_bench.tests.conftest import make_copy


def test_new_files_are_found_by_name(tmp_path):
    root = make_copy(tmp_path / "copy")
    pkg = root / "ldc_bench"
    cfg = json.loads((pkg / "configs/fv-simple.json").read_text())
    cfg["params"].update(Re=400.0, tolerance=1e-4, max_iterations=4000)
    (pkg / "configs/fv-re400.json").write_text(json.dumps(cfg))
    (pkg / "traffic/n12-pair.json").write_text(json.dumps({
        "kind": "round", "N": 12, "params": {},
        "lanes": [{"alpha_uv": 0.4}, {"alpha_uv": 0.4}],
        "perturb": {"key": "lid_velocity", "ulps": 4}}))
    (pkg / "limits/fv-re400.n12-pair.json").write_text(json.dumps(
        {"mom": 1e-2, "l2_gap": 1e-9, "unconverged": 0}))
    (pkg / "metrics/lanes_per_round.py").write_text(
        "def read(ctx, name):\n"
        "    return sum(len(j.lanes) for j in ctx['jobs']) "
        "/ len(ctx['jobs'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "fv-re400", "source": "test",
                             "file": "ldc_bench/configs/fv-re400.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "fv-re400.n12-pair",
                               "config": "fv-re400", "traffic": "n12-pair",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "lanes_per_round", "unit": "lanes",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["fv-re400.n12-pair"]})
    for m in bench["end_to_end"]:
        if m["name"] == "round_s":
            m["workloads"].append("fv-re400.n12-pair")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    b = spec.benchmark(root)
    assert spec.config(b, "fv-re400", root)["params"]["Re"] == 400.0
    assert spec.traffic("n12-pair", root)["N"] == 12
    names = [m["name"] for m in spec.metrics(b, "fv-re400.n12-pair", False)]
    assert names == ["setup_s", "round_s", "lanes_per_round"]
    out = run_cell("fv-re400.n12-pair", 99, 0.5, False, device="cpu",
                   root=Path(root))
    assert out["correct"], out["checks"]
    assert out["metrics"]["lanes_per_round"] == {"value": 2.0,
                                                 "unit": "lanes"}
    assert set(out["metrics"]) == {"setup_s", "round_s", "lanes_per_round"}
    assert list(out)[-1] == "checks"
