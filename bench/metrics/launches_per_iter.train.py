"""launches_per_iter.train: CUDA kernels launched inside the benchmark's
`copml.iteration` ranges of the traced job, over the iterations it
traced: the step's draws and sharing (core.random, core.shamir,
core.truncation) launched from the host, and its field kernels."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ranges.get("copml.iteration"):
        return None
    kernels = tr.ops_launched_in("copml.iteration")
    if not kernels:
        return None
    return len(kernels) / len(tr.ranges["copml.iteration"])
