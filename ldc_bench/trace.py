"""One job under ``torch.profiler``, read without the profiler's Python
post-processing: the device's busy time inside the traced window and
inside each of the job's phases, the device operations by name, and the
idle gaps by what the host was doing.

The window is the whole job, opened and closed on the benchmark's own
spans: from the start of its build to the end of its validation, once the
device has finished all the work dispatched. The run keeps it short by
capping every level of the traced job (``trace_steps`` of the traffic
mix), so it holds each phase of a job: the build, every level's stepping
and the validation. Time the host spends with the device idle counts as
idle: the share is taken over the window, not over the span from the
first device activity to the last. The device activities are the
kernels, copies and fills the trace puts on the device (the profiler also
mirrors host labels there: those are left out).
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict

LABEL = "ldc_bench"


def op_name(name: str) -> str:
    """A kernel's function name: the identifier before its template
    arguments and parameter list."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return m.group(1) if m else name[:48]


def _innermost(host, starts, t, reach: int = 256):
    """The name of the latest-starting host span that covers ``t`` (the
    innermost, spans being nested), looking back at most ``reach``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return None


def read(events, w0: int, w1: int, spans=(), top: int = 10) -> dict:
    """busy_s, window_s, device_ops and idle_gaps of the window [w0, w1]
    (ns, the trace's clock) from the profiler's events
    (``kineto_results.events()``); ``spans`` are the benchmark's own
    (name, start, end) around the job's phases, which name a gap that no
    host operation of the trace covers; ``span_busy_s`` is the busy time
    inside each of them."""
    on_device = {}
    dev, host = [], []
    for e in events:
        kind = e.device_type()
        cuda = on_device.get(kind)
        if cuda is None:
            cuda = on_device[kind] = str(kind).endswith("CUDA")
        name = e.name()
        if name.startswith(LABEL):
            continue  # the labels, and the profiler's mirror of them
        if cuda:
            s = e.start_ns()
            s0, e0 = max(s, w0), min(s + e.duration_ns(), w1)
            if e0 > s0:
                dev.append((s0, e0, name))
        elif not name.startswith("cu"):  # CUDA runtime and driver calls
            s = e.start_ns()
            host.append((s, s + e.duration_ns(), name))
    dev.sort()
    busy, ops, names = [], defaultdict(float), {}
    for s, e, name in dev:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
        key = names.get(name)
        if key is None:
            key = names[name] = op_name(name)
        ops[key] += (e - s) / 1e9
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    host.sort()
    starts = [h[0] for h in host]
    by_host = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        name = _innermost(host, starts, mid) or next(
            (f"{LABEL}.{n}" for n, a, b in spans if a <= mid <= b),
            "host outside any span")
        by_host[name] += (e - s) / 1e9
    rank = lambda d: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    span_busy = defaultdict(float)
    for n, a, b in spans:
        span_busy[n] += sum(max(0, min(e, b) - max(s, a))
                            for s, e in busy) / 1e9
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (w1 - w0) / 1e9, "span_busy_s": dict(span_busy),
            "device_ops": rank(ops), "idle_gaps": rank(by_host)}


def traced(run):
    """Run ``run(span)`` under the profiler, traced whole; ``span(name)``
    labels a phase. Returns (run's result, read(...) of the window, with
    ``read_s``, the seconds the reading took)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    spans = []

    @contextlib.contextmanager
    def span(name):
        t0 = time.time_ns()
        try:
            with record_function(f"{LABEL}.{name}"):
                yield
        finally:
            spans.append((name, t0, time.time_ns()))

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        w0 = time.time_ns()
        out = run(span)
        torch.cuda.synchronize()
        w1 = time.time_ns()
    finally:
        prof.stop()
    t0 = time.perf_counter()
    got = read(prof.profiler.kineto_results.events(), w0, w1, spans)
    got["read_s"] = time.perf_counter() - t0
    return out, got
