"""Tracing hooks of anap3_tpu_torch (utils/profiling.py) against
anap3_tpu.utils.profiling, on the CPU.

- ``PhaseTimer`` gives the JAX package's metric keys for the same phases.
- ``device_trace`` writes a Chrome trace of CPU activity when given a
  directory, and does nothing without one.
- ``trace_device`` refuses a trace that holds no device activity (the
  card's measurement helpers fail the run on it), and ``device_breakdown``
  reads the window, busy time, idle share and kernel shares of a trace's
  device events: over the caller's host window where given, else from
  the first activity to the last.
"""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from anap3_tpu.utils import profiling as JP
from anap3_tpu_torch.utils import profiling as TP


def _phases(timer):
    with timer.phase("setup"):
        time.sleep(0.001)
    with timer.phase("solve"):
        with timer.phase("chunk"):
            pass
    with timer.phase("setup"):
        pass
    return timer


@pytest.mark.parametrize("prefix", ["time_", "wall_"])
def test_phase_timer_keys_equal_jax(prefix):
    t, j = _phases(TP.PhaseTimer()), _phases(JP.PhaseTimer())
    assert list(t.as_metrics(prefix)) == list(j.as_metrics(prefix))
    assert list(t.as_metrics()) == ["time_setup_seconds",
                                    "time_chunk_seconds",
                                    "time_solve_seconds"]
    assert t.phases["setup"] >= 0.001
    assert all(isinstance(v, float) for v in t.as_metrics().values())


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    out = tmp_path / "trace"
    with TP.device_trace(str(out)):
        a = torch.ones((64, 64))
        (a @ a).sum()
    files = list(out.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)


def test_device_trace_without_a_directory_does_nothing(tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    for empty in (None, ""):
        with TP.device_trace(empty):
            torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_trace_device_refuses_a_trace_without_device_activity():
    with pytest.raises(TP.NoDeviceActivity, match="no device activity"):
        TP.trace_device(lambda: torch.ones(8).sum(), "host work")


def _event(name, start, end):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start))


def test_device_breakdown_reads_a_trace():
    dev = [_event("void stage_kernel<float, 16>(Params)", 0.0, 30.0),
           _event("void stage_kernel<float, 16>(Params)", 50.0, 80.0),
           _event("control_kernel(int*)", 90.0, 100.0),
           _event("Memcpy DtoH (Device -> Pinned)", 100.0, 100.0)]
    text = TP.device_breakdown(dev)
    assert text.startswith("window 0.100 ms, device time 0.070 ms, idle "
                           "share 0.300, 4 device activities")
    assert "stage_kernel 0.060 ms (86%)" in text
    assert "control_kernel 0.010 ms (14%)" in text


def test_device_breakdown_takes_the_idle_share_over_a_window():
    # the same activities inside a 200 µs host window: the host time
    # before the first kernel counts as idle, and an activity is clipped
    # to the window
    dev = [_event("void stage_kernel<float, 16>(Params)", 0.0, 30.0),
           _event("void stage_kernel<float, 16>(Params)", 50.0, 80.0),
           _event("control_kernel(int*)", 90.0, 100.0)]
    text = TP.device_breakdown(dev, window=(-100.0, 100.0))
    assert text.startswith("window 0.200 ms, device time 0.070 ms, idle "
                           "share 0.650, 3 device activities")
    clipped = TP.device_breakdown(dev, window=(10.0, 95.0))
    assert clipped.startswith("window 0.085 ms, device time 0.055 ms, "
                              "idle share 0.353")
