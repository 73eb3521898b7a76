"""smooth_idle.<kind>: percent of the traced job's solve phase
(``job.step_s``) in which the device idled while the host was inside a
V-cycle's smoothing sweep: the gaps the breakdown names with the program's
span ``anap3.vmg.smooth`` (VMG only). ``trace.py`` names a gap by the
innermost host event over its middle, so a gap inside one of PyTorch's
operations (an ``aten::`` event) keeps that operation's name and is not
counted here. Only the breakdown's ten largest names are seen
(``_program.idle_share``). A cycle replayed from a CUDA graph runs no host
code of its sweeps, so on the card it reads the gaps of the solve's first
two cycles (the eager one and the capture) alone."""

from . import _program, _vmg


def read(ctx, name):
    names = _vmg.spans("smooth")
    if not _vmg.traced_vmg(ctx, name) or not names:
        return None
    return _program.idle_share(ctx["trace"], names)
