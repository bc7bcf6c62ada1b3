"""fit_s: wall seconds of one whole training job (setup, the iterations,
the open): the window's wall time over the jobs it completed."""


def read(ctx):
    return ctx.record["e2e"].get("fit_s")
