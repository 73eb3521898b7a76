"""Tracing and profiling hooks of the port.

The counterpart of ``anap3_tpu/utils/profiling.py``:

- ``span(name)``: the program's own label ``anap3.<name>`` on the
  profiler's clock, opened only while ``torch.profiler`` records (see
  below);
- ``PhaseTimer``: nestable named phase timing collected into a dict of
  metrics (a copy of the JAX package's, with the same ``as_metrics`` keys);
  each phase is also the span ``cli.<phase>``;
- ``device_trace(trace_dir)``: a context manager around ``torch.profiler``
  that writes a Chrome trace into ``trace_dir`` (CPU activity, plus CUDA
  activity when the card is used) and does nothing when ``trace_dir`` is
  falsy.

And the card's measurement helpers (``chip_smoke.py`` imports them):

- ``trace_device(fn, what)``: the device activities of one call under
  ``torch.profiler`` and its host window on the trace's clock; "not
  measured" when the profiler cannot start, and ``NoDeviceActivity`` when
  the trace holds none;
- ``device_breakdown(dev, window=...)``: the window, device time, idle
  share over the window and the leading kernels of a trace, as one line's
  text;
- ``profile_chunk(run, what)``: one warm-up call, the unprofiled wall of
  a second, then the profiled third. The profiler inflates eager dispatch
  (~27 µs a launch under it against 16-17 µs without, on an H100 host), so
  every profiled idle share is printed beside the unprofiled wall of the
  same work.

``main.py`` wraps every solve in the JAX package's tracer and may not
change, so this tracer is reached only from the port's own entry points.

Spans. The solvers open a span at each boundary of their host loop, never
per step or per launch; with ``ANAP3_TRACE_DIR`` (or any profiler) on they
name what the host was doing in every idle gap of the device timeline:

- ``chunk.dispatch``: a chunk's call into its runner and the bundled
  device-to-host copy (``models/runner.py``, ``parallel/sweep.py``);
- ``chunk.wait``: the wait for that copy;
- ``chunk.control``: the host work on a chunk's rows and flags (history,
  plateau and stall gates, logging, checkpoints);
- ``level.setup``: a level's operators, initial state, stacked lanes and
  chunk runners; ``level.prolong``: the prolongation to the next order;
- ``solve.finish``: the closing residuals, quadratures, final fields and
  vortex metrics;
- ``validate``, with ``validate.load`` (the stored truths) and
  ``validate.evaluate`` (the solution at their points);
- ``cli.<phase>`` (``PhaseTimer``), ``cli.vts`` and ``cli.track`` in the
  port's CLI.

A trace reader names a gap by the innermost span around it and looks
back a bounded number of the profiler's events for it (``ldc_bench``:
256), so work that makes many events (a batch's operator comparisons,
the closing analysis) opens a span a part, and a span may hold spans of
its own name.

A span is a ``_RecordFunctionFast`` of torch's profiler, not a
``torch.profiler.record_function``: the latter is a user annotation, which
the profiler mirrors on the device timeline as an event of its own
covering the kernels launched under it, so a reader of device activity
would take the span for device work. Without a profiler recording,
``span`` costs one flag check (~0.2 µs on an H100 host) and returns a
shared no-op context.
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

__all__ = ["span", "PhaseTimer", "device_trace", "trace_device",
           "device_breakdown", "profile_chunk", "NoDeviceActivity", "PREFIX"]

# every span's name starts with it
PREFIX = "anap3."
_NO_SPAN = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """The profiler's label ``anap3.<name>`` around a block while a
    profiler records, else a shared no-op context. ``name`` is a static
    string: the trace readers add up time by name."""
    if not _recording():
        return _NO_SPAN
    return _record(PREFIX + name)


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
            with span("cli." + name):
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
    """The device activities of ``fn()`` under torch.profiler, the host
    seconds it took and its host window ``(start, end)`` in the trace's
    microseconds (the call and the device's finishing it); None, with a
    line saying so, when the profiler cannot start tracing. A trace without
    device activity raises ``NoDeviceActivity``."""
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
        with span("window"):
            t0 = time.time()
            fn()
            if cuda:
                torch.cuda.synchronize()
            host = time.time() - t0
    finally:
        prof.stop()
    events = prof.events()
    window = next(((e.time_range.start, e.time_range.end) for e in events
                  if e.name == PREFIX + "window"), None)
    dev = [e for e in events
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not dev:
        raise NoDeviceActivity(f"{what}: no device activity in the trace")
    return dev, host, window


def device_breakdown(dev, top=10, window=None) -> str:
    """The window, device time, idle share and the ``top`` kernels by
    device time of a trace's device activities, as one line's text. The
    idle share is taken over ``window`` (``(start, end)``, µs of the
    trace, as ``trace_device`` gives it), so that host time with the
    device idle counts; without one, from the first activity to the
    last."""
    if window is None:
        window = (min(e.time_range.start for e in dev),
                  max(e.time_range.end for e in dev))
    start, end = window
    busy = sum(max(0.0, min(e.time_range.end, end)
                   - max(e.time_range.start, start)) for e in dev)
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
    dev, host, window = traced
    print(f"[{what}] unprofiled wall {wall:.4f}s; profiled host "
          f"{host:.4f}s, {device_breakdown(dev, window=window)}", flush=True)
    return dev, host, wall
