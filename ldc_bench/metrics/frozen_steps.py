"""frozen_steps.<kind>: percent of the steps the chunk runners were asked
to march that no lane needed: the rest of the chunk a job converged in,
and the speculated chunk that the host loop dispatches ahead of its read
and drops. ``100 (1 - needed / marched)``, with ``marched`` the program's
``STEPS`` counters (zeroed with the launch counters when the window opens,
so they hold the window's jobs and the traced job) and ``needed`` the
steps those jobs reported (level by level, the slowest lane's). Every
iteration of the SG, FSG and FV solvers is a step of their chunk runners;
VMG's smoothing sweeps and Newton's PTC steps are not (the counters read 0
there), and FMG marches its coarsest level by the SG chunk and the rest by
V-cycles, so this reads None for those solvers."""

from . import _program
from ._common import applies

CHUNKED = ("sg", "fsg", "fv")


def read(ctx, name):
    tr = ctx["trace"]
    if not applies(ctx, name) or tr is None or \
            ctx["config"].get("solver") not in CHUNKED:
        return None
    marched = _program.counter("STEPS")
    if not marched:
        return None
    needed = sum(j.batch_steps for j in ctx["jobs"]) + tr["job"].batch_steps
    return 100.0 * (1.0 - needed / marched)
