"""round_s: the window's wall over the rounds in it (host clock); a round
ends when every lane is converged and validated."""


def read(ctx, name):
    if ctx["kind"] != "round":
        return None
    return ctx["window_s"] / len(ctx["jobs"])
