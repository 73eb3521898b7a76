"""launches_per_step.<kind>: the kernel launches the program's counters
record over the window, over the steps the window's jobs marched (the
slowest lane's at each level in a round)."""

from ._common import applies


def read(ctx, name):
    if not applies(ctx, name):
        return None
    steps = sum(j.batch_steps for j in ctx["jobs"])
    return ctx["launches"] / steps if steps else None
