"""solve_s: the window's wall over the solves in it (host clock); each
solve is built from the configuration, solved from rest and validated."""


def read(ctx, name):
    if ctx["kind"] != "solve":
        return None
    return ctx["window_s"] / len(ctx["jobs"])
