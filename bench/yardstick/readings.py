"""What several per-layer readers share: the device's idle share over the
traced stretch, a kernel layer's share of its roofline inside one of the
benchmark's ranges, and the training jobs that the profiler did not
record.  Each reader in `bench/metrics/` stays a file of its own and calls
one of these."""

from __future__ import annotations


def idle_pct(ctx):
    """1 - union of device operations over the traced stretch (the
    `bench.window` range), in percent; None without a trace."""
    tr = ctx.trace
    win = None if tr is None else tr.window("bench.window")
    if win is None or win[1] <= win[0]:
        return None
    return 100.0 * (1.0 - tr.busy_ns(*win) / (win[1] - win[0]))


def range_roofline(ctx, span: str, work: tuple):
    """The least time of `work` (operations, bytes) for one call of the
    range `span`, times its calls, over the device time of the kernels
    launched inside those calls, in percent; None where the trace has no
    such range or no kernel in it."""
    tr = ctx.trace
    if tr is None or not tr.ranges.get(span):
        return None
    device_s = sum(e - s for s, e, *_ in tr.ops_launched_in(span)) * 1e-9
    if device_s <= 0:
        return None
    least, _ = ctx.roofline.bound_s(*work)
    return 100.0 * least * len(tr.ranges[span]) / device_s


def untraced_jobs(ctx) -> list:
    """The window's training jobs, which run before the profiler starts;
    the traced ones only where a run has no other."""
    jobs = ctx.record.get("jobs", ())
    return [j for j in jobs if not j["traced"]] or list(jobs)
