"""The controls come out not correct. On the CPU, at the small cells'
size: the bfloat16 answer of every small cell is refused where the
program's own answer passes. On a card (``gpu``), at each cell's own
size: the same for the bfloat16 answer, and the flagship's x1 path (the
program's own bfloat16 products) is refused too."""

import pytest
import torch

from ldc_bench import control, judge, spec

CELLS = ["fsg-re1000.n96-solve", "fv-simple.n128-re100-solve",
         "fsg-re1000.n40-round8", "fv-simple.n128-truth3"]


def split(rows, root, cell):
    lim = spec.limits(cell, root)
    verdict = {}
    for r in rows:
        verdict.setdefault(r["what"], []).append(judge.over(r["numbers"],
                                                            lim))
    return verdict


@pytest.mark.parametrize("cell", ["tiny-fsg.solve", "tiny-fv.solve",
                                  "tiny-fsg.round", "tiny-fv.round"])
def test_bf16_control_is_refused_on_the_cpu(tiny_root, cell):
    rows = control.readings(cell, [5], False, 0, "cpu", root=tiny_root,
                            emit=lambda s: None)
    v = split(rows, tiny_root, cell)
    assert not any(v["program"])
    assert all(v["bf16"])


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_is_refused_on_the_card(cell):
    card()
    rows = control.readings(cell, [11], False, 0, "cuda",
                            emit=lambda s: None)
    v = split(rows, spec.ROOT, cell)
    assert not any(v["program"])
    assert all(v["bf16"])


@pytest.mark.gpu
def test_x1_control_is_refused_on_the_card():
    card()
    cell = "fsg-re1000.n96-solve"
    rows = control.readings(cell, [12], True, 400_000, "cuda",
                            emit=lambda s: None)
    assert all(split(rows, spec.ROOT, cell)["x1"])
