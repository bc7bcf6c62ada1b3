"""protocol_setup_ms.train: milliseconds of `Copml.setup` a job (quantize,
Shamir share, LCC encode, X^T y), from the program's own
`timings["setup_s"]` (a host clock ended by a synchronise), mean over the
window's jobs that the profiler did not record."""

from yardstick import readings


def read(ctx):
    jobs = readings.untraced_jobs(ctx)
    if not jobs:
        return None
    return 1e3 * sum(j["timings"]["setup_s"] for j in jobs) / len(jobs)
