"""kernel_roofline.<kind>: percent: the least time the stepping of the
traced job could take on one H100, over the device time inside its
``solve`` span (torch.profiler). The traced job runs every level to its
``trace_steps`` cap, whole, so its work is its own: every lane's
reported steps at each order, or its SIMPLE iterations, counted by
operations and bytes against the data-sheet peaks (``work.py``). The
figure so does not depend on which kernels do the work."""

from .. import work
from ._common import applies


def least_seconds(config: dict, job) -> float:
    dtype = str(config["params"]["dtype"])
    flops = nbytes = 0.0
    for lane in job.lanes:
        for n, steps in lane.levels:
            if config["reference"] == "spectral":
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
    if busy <= 0:
        return None
    return 100.0 * least_seconds(ctx["config"], tr["job"]) / busy
