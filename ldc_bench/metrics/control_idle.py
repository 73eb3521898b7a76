"""control_idle.<kind>: percent of the traced job's solve phase in which
the device idled while the host waited for a chunk's flags, worked on its
rows, set a level up, prolongated a state or closed the solve: the gaps
the breakdown names with the program's spans ``anap3.chunk.wait``,
``.chunk.control``, ``.level.setup``, ``.level.prolong`` and
``.solve.finish``. Only the breakdown's ten largest names are seen
(``_program.idle_share``)."""

from . import _program
from ._common import applies

NAMES = tuple(_program.SPAN + n for n in (
    "chunk.wait", "chunk.control", "level.setup", "level.prolong",
    "solve.finish"))


def read(ctx, name):
    tr = ctx["trace"]
    if not applies(ctx, name) or tr is None or not _program.has_spans():
        return None
    return _program.idle_share(tr, NAMES)
