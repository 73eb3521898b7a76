"""Tracing and profiling hooks of the port.

The counterpart of ``anap3_tpu/utils/profiling.py``:

- ``PhaseTimer``: nestable named phase timing collected into a dict of
  metrics (a copy of the JAX package's, with the same ``as_metrics`` keys);
- ``device_trace(trace_dir)``: a context manager around ``torch.profiler``
  that writes a Chrome trace into ``trace_dir`` (CPU activity, plus CUDA
  activity when the card is used) and does nothing when ``trace_dir`` is
  falsy.

And the card's measurement helpers (``chip_smoke.py`` imports them):

- ``trace_device(fn, what)``: the device activities of one call under
  ``torch.profiler``; "not measured" when the profiler cannot start, and
  ``NoDeviceActivity`` when the trace holds none;
- ``device_breakdown(dev)``: the window, device time, idle share and the
  leading kernels of a trace, as one line's text;
- ``profile_chunk(run, what)``: one warm-up call, the unprofiled wall of
  a second, then the profiled third. The profiler inflates eager dispatch
  (~27 µs a launch under it against 16-17 µs without, on an H100 host), so
  every profiled idle share is printed beside the unprofiled wall of the
  same work.

``main.py`` wraps every solve in the JAX package's tracer and may not
change, so this tracer is reached only from the port's own entry points.
"""

from __future__ import annotations

import contextlib
import logging
import os
import re
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

log = logging.getLogger(__name__)

__all__ = ["PhaseTimer", "device_trace", "trace_device", "device_breakdown",
           "profile_chunk", "NoDeviceActivity"]


class NoDeviceActivity(RuntimeError):
    """A trace of work meant for the card holds no device activity."""


class PhaseTimer:
    """Collects named wall-time phases; ``as_metrics()`` for tracking."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t0

    def as_metrics(self, prefix: str = "time_") -> Dict[str, float]:
        return {f"{prefix}{k}_seconds": round(v, 4)
                for k, v in self.phases.items()}


def _activities(cuda: bool):
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace when a directory is given; no-op otherwise.

    Records CPU activity, plus CUDA activity when a card is available, and
    writes ``trace_<pid>.json`` (Chrome trace format) into ``trace_dir``.
    As in the JAX package, a profiler that cannot start logs a warning and
    the traced work runs untraced."""
    if not trace_dir:
        yield
        return
    from torch.profiler import profile

    cuda = torch.cuda.is_available()
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=_activities(cuda))
    try:
        prof.start()
        started = True
    except RuntimeError as exc:
        log.warning("Device tracing failed to start: %s", exc)
        started = False
    try:
        yield
    finally:
        if started:
            if cuda:
                torch.cuda.synchronize()
            prof.stop()
            path = out / f"trace_{os.getpid()}.json"
            prof.export_chrome_trace(str(path))
            log.info("Wrote device trace to %s", path)


def trace_device(fn, what):
    """The device activities of ``fn()`` under torch.profiler, and the host
    seconds it took; None, with a line saying so, when the profiler cannot
    start tracing. A trace without device activity raises
    ``NoDeviceActivity``."""
    from torch.profiler import profile

    cuda = torch.cuda.is_available()
    prof = profile(activities=_activities(cuda))
    try:
        prof.start()
    except RuntimeError as exc:
        print(f"[{what}] not measured: the profiler did not start: {exc}",
              flush=True)
        return None
    try:
        t0 = time.time()
        fn()
        if cuda:
            torch.cuda.synchronize()
        host = time.time() - t0
    finally:
        prof.stop()
    dev = [e for e in prof.events()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not dev:
        raise NoDeviceActivity(f"{what}: no device activity in the trace")
    return dev, host


def device_breakdown(dev, top=10) -> str:
    """The window, device time, idle share and the ``top`` kernels by
    device time of a trace's device activities, as one line's text."""
    start = min(e.time_range.start for e in dev)
    end = max(e.time_range.end for e in dev)
    busy = sum(e.time_range.elapsed_us() for e in dev)
    by_name = {}
    for e in dev:
        # the function's name: the identifier before its template
        # arguments and parameter list
        named = re.search(r"(\w+)(?:<[^()]*>)?\(", e.name)
        key = named.group(1) if named else e.name[:32]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / busy:.0%})" for k, v in
                      sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    return (f"window {(end - start) / 1e3:.3f} ms, device time "
            f"{busy / 1e3:.3f} ms, idle share {1 - busy / (end - start):.3f}, "
            f"{len(dev)} device activities; top: {parts}")


def profile_chunk(run, what):
    """``run()`` once to warm up, once unprofiled (its wall, synchronized)
    and once under torch.profiler: prints the unprofiled wall beside the
    profiled host time and the device breakdown of its window. Returns
    ``(dev, host, wall)``, or None when the profiler did not start."""
    run()
    torch.cuda.synchronize()
    t0 = time.time()
    run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    traced = trace_device(run, what)
    if traced is None:
        return None
    dev, host = traced
    print(f"[{what}] unprofiled wall {wall:.4f}s; profiled host "
          f"{host:.4f}s, {device_breakdown(dev)}", flush=True)
    return dev, host, wall
