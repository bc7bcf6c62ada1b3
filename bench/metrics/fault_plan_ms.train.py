"""fault_plan_ms.train: host milliseconds a job spends compiling its fault
plan (the `setup.faults` span around Copml._fault_xs: an exact Lagrange
decode row for each distinct subset, the plan's index and row tensors
copied to the card), from the program's `timings["spans"]` (an
obs.Recorder: perf_counter, no synchronise), mean over the window's jobs
that the profiler did not record.  None where a job has no such span (a
fault-free job, or a program without the span)."""

from yardstick import readings

PATH = "setup.faults"


def read(ctx):
    jobs = readings.untraced_jobs(ctx)
    spans = [j["timings"].get("spans") or {} for j in jobs]
    if not jobs or not all(PATH in s for s in spans):
        return None
    return 1e3 * sum(s[PATH][1] for s in spans) / len(spans)
