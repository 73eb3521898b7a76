"""What the V-cycle readers share: the program's V-cycle spans and its
smoother steps counter, looked up in the modules the run imported (never
imported anew). A program without them (one that declares no ``SPANS`` in
``models/spectral_vmg.py`` or keeps no ``SMOOTH_STEPS`` in
``ops/sg_kernels.py``) gives nothing to read, and the readers then return
None."""

from __future__ import annotations

import sys

from . import _program
from ._common import applies

SOLVER = "vmg"
CYCLE_MODULE = "anap3_tpu_torch.models.spectral_vmg"
SMOOTHER_MODULE = "anap3_tpu_torch.ops.sg_kernels"


def traced_vmg(ctx, name) -> bool:
    """Whether the run is a traced VMG run of the metric's kind."""
    return (applies(ctx, name) and ctx["trace"] is not None
            and ctx["config"].get("solver") == SOLVER)


def spans(*phases) -> tuple:
    """The full names (``anap3.vmg.<phase>``) of those of ``phases`` that
    the program's V-cycle declares it opens."""
    declared = getattr(sys.modules.get(CYCLE_MODULE), "SPANS", ())
    return tuple(_program.SPAN + s for s in declared
                 if s.rsplit(".", 1)[-1] in phases)


def smooth_steps():
    """The smoother steps by order N (window and traced job), or None."""
    table = getattr(sys.modules.get(SMOOTHER_MODULE), "SMOOTH_STEPS", None)
    if not isinstance(table, dict) or not any(table.values()):
        return None
    return {int(n): int(s) for n, s in table.items() if s}
