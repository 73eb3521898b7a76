"""validate_ms.<kind>: milliseconds a job spends in the program's
validation (``compute_validation_errors`` of every lane), by the
benchmark's host span around the calls; the mean over the window."""

from ._common import applies


def read(ctx, name):
    if not applies(ctx, name):
        return None
    jobs = ctx["jobs"]
    return 1e3 * sum(j.validate_s for j in jobs) / len(jobs)
