"""The frozen work models against the bound column of PERF.md's kernel
table (chip_smoke.py's ``steps_bound`` and ``fv_work``, from which they
were copied): ms a chunk step of one SG lane at N = 48, 96, 128 in
float32 (a quadrature pass every 16 steps), and ms a float32 FV-SIMPLE
iteration at 128 x 128."""

import pytest

from ldc_bench import work


@pytest.mark.parametrize("n, ms", [(48, 0.00017), (96, 0.00130),
                                   (128, 0.00307)])
def test_sg_step_bound(n, ms):
    seconds, what = work.steps_bound(n + 1, "float32", 16, 1)
    assert round(seconds / 16 * 1e3, 5) == ms
    assert what == "operations"


def test_fv_iteration_bound():
    seconds, what = work.fv_iterations_bound(128, 128, "float32", 1, 1)
    assert round(seconds * 1e3, 5) == 0.00085
    assert what == "operations"


def test_bounds_grow_with_the_work():
    one = work.steps_bound(49, "float32", 100, 6)[0]
    assert work.steps_bound(49, "float32", 200, 12)[0] == pytest.approx(
        2 * one, rel=1e-12)
    assert work.fv_iterations_bound(128, 128, "float32", 1, 10)[0] == \
        pytest.approx(10 * work.fv_iterations_bound(
            128, 128, "float32", 1, 1)[0])
