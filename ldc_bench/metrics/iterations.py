"""iterations.<kind>: steps a job marched, summed over the ladder's
levels, the slowest lane's at each level in a round (``IterationResult``
counts, as the solvers report them); the mean over the window's jobs. A
step is one iteration of the configuration's solver
(``_common.ONE_KIND``: an RK4 step, a V-cycle, a PTC step, a SIMPLE
iteration); None for FMG, whose levels count two kinds."""

from ._common import counts_iterations


def read(ctx, name):
    if not counts_iterations(ctx, name):
        return None
    jobs = ctx["jobs"]
    return sum(j.batch_steps for j in jobs) / len(jobs)
