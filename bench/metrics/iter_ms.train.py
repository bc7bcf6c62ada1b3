"""iter_ms.train: milliseconds of one `Copml.iteration` (model encode, the
fused step's draws and kernel, the open kept for the history), from the
program's own `timings["iters_s"]` over its iterations, mean over the
window's jobs that the profiler did not record."""

from yardstick import readings


def read(ctx):
    jobs = readings.untraced_jobs(ctx)
    if not jobs:
        return None
    return 1e3 * sum(j["timings"]["iters_s"] for j in jobs) / (
        ctx.cfg["iters"] * len(jobs))
