"""kernel_roofline.<kind>: percent: the least time the stepping of the
traced job could take on one H100, over the device time inside its
``solve`` span (torch.profiler). The traced job runs every level to its
``trace_steps`` cap, whole, so its work is its own: every lane's
reported steps at each order, or its SIMPLE iterations, counted by
operations and bytes against the data-sheet peaks (``work.py``). The
figure so does not depend on which kernels do the work.

``work.py`` models an RK4 step of the SG and FSG solvers and a SIMPLE
iteration of the FV solver; for any other solver (a V-cycle, a PTC step)
this reads None."""

from .. import work
from ._common import applies

SG_STEPS, SIMPLE = ("sg", "fsg"), ("fv",)


def least_seconds(config: dict, job):
    """The least seconds of the job's steps, or None where ``work.py`` does
    not model the configuration's solver."""
    solver = config.get("solver")
    if solver not in SG_STEPS + SIMPLE:
        return None
    dtype = str(config["params"]["dtype"])
    flops = nbytes = 0.0
    for lane in job.lanes:
        for n, steps in lane.levels:
            if solver in SG_STEPS:
                f, b = work.steps_work(n + 1, dtype, steps,
                                       steps // work.QUAD_EVERY)
            else:
                refine = 1 if dtype == "float32" else 0
                halves = work.fv_work(n, n, dtype, refine).values()
                f = steps * sum(x for x, _ in halves)
                b = steps * sum(y for _, y in halves)
            flops, nbytes = flops + f, nbytes + b
    return work.bound(flops, nbytes, dtype)[0]


def read(ctx, name):
    tr = ctx["trace"]
    if not applies(ctx, name) or tr is None:
        return None
    busy = tr["span_busy_s"].get("solve", 0.0)
    least = least_seconds(ctx["config"], tr["job"])
    if busy <= 0 or least is None:
        return None
    return 100.0 * least / busy
