"""What the per-layer readers take from the program itself: its counters,
from its kernel modules as the run imported them (looked up in
``sys.modules``, never imported anew), and the idle time that its own
spans (``anap3.<name>``, ``anap3_tpu_torch/utils/profiling.py:span``) name
in the traced job's breakdown. A program without the counter or the spans
gives nothing to read, and the readers then return None."""

from __future__ import annotations

import sys

KERNEL_MODULES = tuple(f"anap3_tpu_torch.ops.{m}" for m in (
    "sg_kernels", "fv_kernels", "sg_lane_kernels", "fv_lane_kernels"))
TRACER = "anap3_tpu_torch.utils.profiling"
SPAN = "anap3."


def counter(table: str):
    """The sum of the counter table ``table`` (a dict of counts) over the
    program's kernel modules, or None where none of them has it."""
    found = [getattr(sys.modules.get(m), table, None) for m in KERNEL_MODULES]
    found = [t for t in found if isinstance(t, dict)]
    if not found:
        return None
    return sum(sum(t.values()) for t in found)


def idle_share(tr, names) -> float:
    """Percent of the traced job's solve phase (``job.step_s``) in which
    the device idled while the host was inside one of ``names``, as the
    trace's breakdown names its gaps. The breakdown keeps its ten largest
    names only: a name not among them counts 0, so the reading can fall
    short by at most the tenth name's time for each name it misses."""
    step_s = tr["job"].step_s
    if step_s <= 0:
        return None
    gaps = dict(tr["idle_gaps"])
    return 100.0 * sum(gaps.get(n, 0.0) for n in names) / step_s


def has_spans() -> bool:
    """Whether the program opens its own spans (its tracer has ``span``)."""
    tracer = sys.modules.get(TRACER)
    return callable(getattr(tracer, "span", None))
