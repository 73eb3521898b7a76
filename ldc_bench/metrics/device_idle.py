"""device_idle.<kind>: percent of the traced window (one job, capped at
the mix's ``trace_steps`` a level and traced whole: build, stepping,
validation; ``trace.py``) in which no operation ran on the device
(torch.profiler)."""

from ._common import applies


def read(ctx, name):
    tr = ctx["trace"]
    if not applies(ctx, name) or tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
