"""launch_idle.<kind>: percent of the traced job's solve phase in which
the device idled while the host was enqueueing a chunk: the gaps the
breakdown names ``anap3.chunk.dispatch`` (the program's span around a
chunk's call into its runner) and ``Command Buffer Full`` (the profiler's
event for a launch that waits for room in the CUDA launch queue, which lies
inside a dispatch). The profiler slows eager dispatch, so this is an upper
reading of the untraced runs' share. Only the breakdown's ten largest
names are seen (``_program.idle_share``), and a gap with more than 256
of the profiler's host events between it and its dispatch's start (the
reader's look-back; a long SG chunk enqueues thousands of "Command Buffer
Full" events) is named ``ldc_bench.solve`` and left out."""

from . import _program
from ._common import applies

NAMES = (_program.SPAN + "chunk.dispatch", "Command Buffer Full")


def read(ctx, name):
    tr = ctx["trace"]
    if not applies(ctx, name) or tr is None or not _program.has_spans():
        return None
    return _program.idle_share(tr, NAMES)
