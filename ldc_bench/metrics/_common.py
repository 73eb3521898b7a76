"""Helpers the metric readers share. A reader is ``read(ctx, name)``: the
metric's value, or None where the run has nothing to read for it (a
metric named ``<stem>.solve`` reads solve cells, ``<stem>.round`` round
cells)."""

# The solvers whose iterations are of one kind at every level (drive.py:
# an RK4 step for sg and fsg, a V-cycle for vmg, a PTC step for newton, a
# SIMPLE iteration for fv). FMG's levels count RK4 steps (its coarsest)
# and V-cycles, so a reader of iterations reads None there.
ONE_KIND = ("sg", "fsg", "vmg", "newton", "fv")


def applies(ctx, name: str) -> bool:
    return name.rsplit(".", 1)[-1] == ctx["kind"]


def counts_iterations(ctx, name: str) -> bool:
    """Whether a reader of a job's iterations reads this run: a cell of
    the metric's kind whose solver's iterations are of one kind."""
    return applies(ctx, name) and ctx["config"].get("solver") in ONE_KIND
