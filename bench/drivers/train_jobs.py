"""Training jobs back to back for the whole window.

A mix of this kind names `iters`-step jobs of the configuration: one user
who submits the next job when the last one returns (a closed loop of one).
Each job gets its own program key from the seed and the job's index; all
jobs train on the same rows, made once in set-up from the seed.  The window
runs jobs until `seconds` have passed and ends with the last job, so every
job it counts is whole; fit_s is the window's wall time over its jobs.

Mix parameters: `warm_jobs` (jobs run in set-up, the first of which builds
the kernels in a fresh checkout) and `trace_jobs` (the jobs a traced run
records, after its window: the profiler's first start leaves the host's
launches slower for the rest of the process, so the window's jobs, from
which the program-span metrics are read, run before it).
"""

from __future__ import annotations

import time

from yardstick import data, trace

WARM_INDEX = 1 << 20          # job indices of set-up's jobs


def run(h) -> dict:
    cfg, mix = h.cfg, h.mix
    sysm = h.system.System(cfg, h.device)
    h.mark("program")
    sysm.build_kernels()
    h.mark("kernels")
    x, y = data.planted_rows(cfg["m"], cfg["d"], cfg["data"]["margin"],
                             h.seed, h.device)
    h.mark("data")
    cx, cy = sysm.split(x, y)
    for j in range(int(mix["warm_jobs"])):
        sysm.job(data.program_key(h.seed, WARM_INDEX + j), cx, cy)
    h.mark("warm_jobs")
    h.before_window()

    jobs = []
    t0 = time.perf_counter()
    while True:
        jobs.append(_job(sysm, h.seed, len(jobs), cx, cy, traced=False))
        if jobs[-1]["end"] - t0 >= h.seconds:
            break
    window_s = jobs[-1]["end"] - t0
    h.after_window()
    in_window = list(jobs)
    dtrace = None
    if h.trace:
        trace.warm_profiler()
        with trace.Spans(sysm.span_targets()):
            dtrace = trace.DeviceTrace().start()
            with trace.span("bench.window"):
                for _ in range(int(mix["trace_jobs"])):
                    jobs.append(_job(sysm, h.seed, len(jobs), cx, cy,
                                     traced=True))
            dtrace.stop()
    del sysm
    starts = [t0] + [j["end"] for j in jobs[:-1]]
    return dict(jobs=jobs, window_s=window_s, trace=dtrace, x=x, y=y,
                e2e=dict(fit_s=window_s / len(in_window)),
                attempted=len(jobs), failed=0,
                notes=dict(job_s=[round(j["end"] - s, 4)
                                  for j, s in zip(jobs, starts)],
                           iters_s=[round(j["timings"]["iters_s"], 4)
                                    for j in jobs]))


def _job(sysm, seed: int, i: int, cx, cy, traced: bool) -> dict:
    out = sysm.job(data.program_key(seed, i), cx, cy)
    out.pop("state")
    out["end"] = time.perf_counter()
    out["traced"] = traced
    return out


def judge(h, record: dict) -> dict:
    ref = h.reference.Reference(h.cfg, record["x"], record["y"], h.device)
    got = h.reference.judge_jobs(ref, record["jobs"])
    return {k: got[k] for k in ("step_gap", "drift_z")}
