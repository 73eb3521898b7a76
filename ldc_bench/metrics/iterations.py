"""iterations.<kind>: steps a job marched, summed over the ladder's
levels, the slowest lane's at each level in a round (``IterationResult``
counts, as the solvers report them); the mean over the window's jobs."""

from ._common import applies


def read(ctx, name):
    if not applies(ctx, name):
        return None
    jobs = ctx["jobs"]
    return sum(j.batch_steps for j in jobs) / len(jobs)
