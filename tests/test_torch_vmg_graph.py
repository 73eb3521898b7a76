"""The V-cycle replayed from a CUDA graph (``models/spectral_vmg.py``
``CapturedCycle``) against the eager cycle.

- On the CPU ``make_v_cycle`` runs the cycle eagerly, and a
  ``CapturedCycle``'s first call is its step's, bit for bit.
- On the card (``gpu``), at the benchmark's VMG configuration in float32
  (N=48, ladder [48, 24], the smoothers' kernels): five captured cycles
  from a state a few eager cycles from rest equal five eager cycles (the
  ``CapturedCycle``'s own ``step``) bit for bit, state and metrics, each
  returned state survives the next call, and the SG kernels' launch and
  smoother step counters read the same.
"""

import pytest
import torch

from anap3_tpu_torch.models import spectral_sg as core
from anap3_tpu_torch.models import spectral_vmg as TV
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.ops import sg_kernels as sgk

CYCLES = 5


def params(device, dtype):
    """The benchmark's VMG configuration (ldc_bench/configs/vmg-re100.json)."""
    return SpectralParameters(
        name="spectral_vmg", basis_type="chebyshev", Re=100.0, nx=48, ny=48,
        n_levels=3, CFL=1.5, beta_squared=5.0, corner_treatment="smoothing",
        corner_smoothing=0.15, tolerance=1e-6, multigrid="vmg",
        coarse_tolerance_factor=1.0, dtype=dtype, chunk_size=5000,
        device=device)


def test_on_the_cpu_the_cycle_runs_eagerly():
    levels = TV.build_vmg_levels(params("cpu", "float64"))
    step = TV.make_v_cycle(levels)
    assert not isinstance(step, TV.CapturedCycle)
    state = core.initial_state(levels[0].ops)
    for _ in range(3):
        state, _ = step(state)
    a, ma = step(state)
    b, mb = TV.CapturedCycle(step)(state)  # a first call: eager
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def counters():
    return [dict(t) for t in (sgk.LAUNCHES, sgk.PART_LAUNCHES,
                              sgk.PLAIN_CALLS, sgk.STEPS, sgk.SMOOTH_STEPS)]


def cycles(levels, state, captured):
    """CYCLES cycles from ``state``, captured or by the eager step: the
    states and metrics on the host, as each call returned them, read after
    the last call, and the counters."""
    smoothers = {i: sgk.make_sg_smoother(lv.ops) for i, lv in enumerate(levels)}
    step = TV.make_v_cycle(levels, smoothers=smoothers)
    assert isinstance(step, TV.CapturedCycle)
    if not captured:
        step = step.step
    sgk.reset_counts()
    out = []
    for _ in range(CYCLES):
        state, metrics = step(state)
        out.append((state, metrics))
    torch.cuda.synchronize()
    host = [(tuple(t.cpu() for t in s), {k: v.cpu() for k, v in m.items()})
            for s, m in out]
    return host, counters()


@pytest.mark.gpu
def test_captured_cycles_equal_eager_cycles_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the smoothers' kernels and the CUDA "
                    "graph have no CPU mode")
    levels = TV.build_vmg_levels(params("cuda", "float32"))
    assert [lv.n for lv in levels] == [48, 24]
    smoothers = {i: sgk.make_sg_smoother(lv.ops) for i, lv in enumerate(levels)}
    warm = TV.make_v_cycle(levels, smoothers=smoothers).step
    state = core.initial_state(levels[0].ops)
    for _ in range(3):
        state, _ = warm(state)
    eager, eager_counts = cycles(levels, state, False)
    graphed, graphed_counts = cycles(levels, state, True)
    assert graphed_counts == eager_counts
    assert eager_counts[-1] == {48: 4 * CYCLES, 24: 30 * CYCLES}
    for (se, me), (sg, mg) in zip(eager, graphed):
        assert all(torch.equal(a, b) for a, b in zip(se, sg))
        assert me.keys() == mg.keys()
        assert all(torch.equal(me[k], mg[k]) for k in me)
    # the cycles moved the state: a replay did not return its input
    assert not torch.equal(graphed[0][0][0], graphed[-1][0][0])
