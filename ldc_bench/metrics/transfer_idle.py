"""transfer_idle.<kind>: percent of the traced job's solve phase
(``job.step_s``) in which the device idled while the host was restricting
to a coarser level (the defect, the state injection with its BCs, the
coarse defect and tau_H) or prolongating the correction (with its BCs and
the finite check): the gaps the breakdown names with the program's spans
``anap3.vmg.restrict`` and ``anap3.vmg.prolong`` (VMG only). A gap inside
one of PyTorch's operations (an ``aten::`` event, such as the transfers'
``aten::mm``) keeps that operation's name in ``trace.py``'s breakdown and
is not counted here. Only the breakdown's ten largest names are seen
(``_program.idle_share``). A cycle replayed from a CUDA graph runs no host
code of its transfers, so on the card it reads the gaps of the solve's
first two cycles (the eager one and the capture) alone."""

from . import _program, _vmg


def read(ctx, name):
    names = _vmg.spans("restrict", "prolong")
    if not _vmg.traced_vmg(ctx, name) or not names:
        return None
    return _program.idle_share(ctx["trace"], names)
