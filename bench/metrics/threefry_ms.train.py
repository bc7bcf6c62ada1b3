"""threefry_ms.train: host milliseconds a step spends in the threefry draws
(the `random.threefry` spans of core.random's bulk draws: the model
encode's random_field and shamir.share, the masks' mix, TruncPr's r, [r]
and [r0]) inside `train.step`, from the program's `timings["spans"]` (an
obs.Recorder: perf_counter, no synchronise, so the time to launch the
draws' kernels), over the job's steps, mean over the window's jobs that
the profiler did not record.  None where the program keeps no spans."""

from yardstick import readings


def read(ctx):
    jobs = readings.untraced_jobs(ctx)
    spans = [j["timings"].get("spans") for j in jobs]
    if not jobs or not all(s and "train.step" in s for s in spans):
        return None
    draw_s = sum(sec for s in spans for path, (_, sec) in s.items()
                 if path.startswith("train.step/")
                 and path.endswith("/random.threefry"))
    steps = sum(s["train.step"][0] for s in spans)
    return 1e3 * draw_s / steps
