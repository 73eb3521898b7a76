"""steps_per_s.<kind>: the steps every lane needed (its reported
iterations), over the window's time inside ``solve()`` or
``run_batched`` (the benchmark's own host spans). A step is one iteration
of the configuration's solver (``_common.ONE_KIND``); None for FMG."""

from ._common import counts_iterations


def read(ctx, name):
    if not counts_iterations(ctx, name):
        return None
    jobs = ctx["jobs"]
    return sum(j.lane_steps for j in jobs) / sum(j.step_s for j in jobs)
