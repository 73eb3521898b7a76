"""Helpers the metric readers share. A reader is ``read(ctx, name)``: the
metric's value, or None where the run has nothing to read for it (a
metric named ``<stem>.solve`` reads solve cells, ``<stem>.round`` round
cells)."""


def applies(ctx, name: str) -> bool:
    return name.rsplit(".", 1)[-1] == ctx["kind"]
