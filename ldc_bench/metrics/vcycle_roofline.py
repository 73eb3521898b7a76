"""vcycle_roofline.<kind>: percent: the least time of the traced job's
V-cycles on one H100, over the device time inside its ``solve`` span
(torch.profiler); VMG only.

The work is ``work_vmg.py``'s: the smoothing steps at each order and, a
cycle, the two defects and the injection, restriction and prolongation
products of each pair of orders. The steps come from the program's
smoother counter (``SMOOTH_STEPS``, by order), which holds the window's
and the traced job's sweeps: the traced job's share at each order is its
V-cycles (the count it reports) over the cycles the counter's finest
order records, (NU1 + NU2) steps each. The traced job runs its
``trace_steps`` // 4 cycles whole, so its work is its own."""

from .. import work_vmg
from . import _vmg


def read(ctx, name):
    if not _vmg.traced_vmg(ctx, name):
        return None
    tr = ctx["trace"]
    steps = _vmg.smooth_steps()
    busy = tr["span_busy_s"].get("solve", 0.0)
    cycles = sum(lane.iterations for lane in tr["job"].lanes)
    if not steps or busy <= 0 or cycles <= 0:
        return None
    marched = steps[max(steps)] / (work_vmg.NU1 + work_vmg.NU2)
    traced = {n: s * cycles / marched for n, s in steps.items()}
    dtype = str(ctx["config"]["params"]["dtype"])
    return 100.0 * work_vmg.vcycle_bound(traced, cycles, dtype)[0] / busy
