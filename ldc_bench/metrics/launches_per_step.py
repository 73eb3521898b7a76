"""launches_per_step.<kind>: the kernel launches the program's counters
record over the window, over the steps the window's jobs marched (the
slowest lane's at each level in a round). A step is one iteration of the
configuration's solver (``_common.ONE_KIND``); None for FMG."""

from ._common import counts_iterations


def read(ctx, name):
    if not counts_iterations(ctx, name):
        return None
    steps = sum(j.batch_steps for j in ctx["jobs"])
    return ctx["launches"] / steps if steps else None
