"""setup_s: process start to the first timed job (host clock)."""


def read(ctx, name):
    return ctx["setup_s"]
