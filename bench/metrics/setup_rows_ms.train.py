"""setup_rows_ms.train: host milliseconds a job of Copml.setup's rows (the
`setup.rows` span: the clients' rows concatenated, quantized and copied to
the card), from the program's `timings["spans"]` (an obs.Recorder:
perf_counter, no synchronise), mean over the window's jobs that the
profiler did not record.  None where the program keeps no spans."""

from yardstick import readings

PATH = "setup.rows"


def read(ctx):
    jobs = readings.untraced_jobs(ctx)
    spans = [j["timings"].get("spans") or {} for j in jobs]
    if not jobs or not all(PATH in s for s in spans):
        return None
    return 1e3 * sum(s[PATH][1] for s in spans) / len(spans)
