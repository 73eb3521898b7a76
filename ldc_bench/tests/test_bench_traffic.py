"""The traffic generator: a seed gives the same jobs every time, other
seeds other draws; perturbations stay on the float32 grid within their
bound; the corner round holds one width in each eighth of 0.01-0.10."""

import numpy as np
import pytest

from ldc_bench import spec, traffic as gen

CELLS = ["fsg-re1000.n96-solve", "fv-simple.n128-re100-solve",
         "fsg-re1000.n40-round8", "fv-simple.n128-truth3"]


def cell_files(name):
    bench = spec.benchmark()
    cell = spec.cell(bench, name)
    return spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12345, 2 ** 40 + 3, -5])
def test_same_seed_same_jobs(name, seed):
    cfg, mix = cell_files(name)
    for k in (0, 1, 5):
        assert gen.job(cfg, mix, seed, k) == gen.job(cfg, mix, seed, k)


@pytest.mark.parametrize("name", CELLS)
def test_jobs_differ_across_seeds_and_jobs(name):
    cfg, mix = cell_files(name)
    seen = {repr(gen.job(cfg, mix, s, k)) for s in range(6) for k in range(3)}
    assert len(seen) > 9


@pytest.mark.parametrize("name", CELLS)
def test_perturbation_on_the_float32_grid(name):
    cfg, mix = cell_files(name)
    key, ulps = mix["perturb"]["key"], mix["perturb"]["ulps"]
    base = np.float32(cfg["params"][key])
    steps = set()
    for s in range(40):
        for lane in gen.job(cfg, mix, s, 0):
            v = lane[key]
            assert np.float32(v) == v
            j = round((v - float(base)) / float(np.spacing(base)))
            assert abs(j) <= ulps
            assert v == float(base + np.float32(j) * np.spacing(base))
            steps.add(j)
    assert len(steps) > ulps


def test_round8_widths_one_in_each_eighth():
    cfg, mix = cell_files("fsg-re1000.n40-round8")
    edges = np.linspace(0.01, 0.10, 9)
    for s in (1, 2, 3):
        lanes = gen.job(cfg, mix, s, 0)
        widths = sorted(lane["corner_smoothing"] for lane in lanes)
        assert len(widths) == 8
        for w, lo, hi in zip(widths, edges[:-1], edges[1:]):
            assert lo <= w <= hi
        assert all(lane["nx"] == lane["ny"] == 40 for lane in lanes)
        assert all(lane["max_iterations"] == 500000 for lane in lanes)


def test_every_seed_gets_the_same_set_of_lanes():
    cfg, mix = cell_files("fv-simple.n128-truth3")
    for s in range(5):
        res = sorted(lane["Re"] for lane in gen.job(cfg, mix, s, 0))
        assert res == [100.0, 400.0, 1000.0]
