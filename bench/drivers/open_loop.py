"""Independent users scoring queries against the served model: an open loop
at a fixed rate.

A mix of this kind gives `rate_qps`, the server's `batch_size` and
`window_ms`, and the query `pool` size.  Set-up trains the model (one job
of the training path, kept whole for the check), builds the server with
`api.serve` over its share state, makes the pool of queries from the seed
and warms the window's one shape.  The window then offers
round(rate_qps * seconds) queries: the gaps between arrivals are the
exponential distribution's quantiles at (i + 1/2) / n, the same set for
every seed, in an order the seed draws, and each query is a pool row the
seed draws.  The loop submits each query when it is due into the program's
`MicroBatchQueue`, flushes a window when the queue says it is ready (full,
or its oldest query has waited `window_ms`), and scores it as
`SecureServer` does (quantize, the packed score GEMM, open, dequantize,
decide).  A query's latency runs from its due time to its decision.

A traced run records the last `trace_seconds` of arrivals and the drain.
The profiler starts TRACE_LEAD_S before that stretch, so that the stall of
its start falls outside it; its first start in the process, and the slower
launches it leaves behind for the rest of the process, would otherwise
hold the server past the knee for the rest of the window.  The device
readings (idle share, the score GEMM's roofline) come from the traced
stretch; the host-clock readings of the windows (queue wait, window wall,
window MFU) come from the windows of the same run that ended before the
profiler started (`untraced_windows`), since the profiler slows the host.
"""

from __future__ import annotations

import time

import numpy as np

from yardstick import data, trace

MODEL_JOB, SERVE_KEY = 0, 1
SLEEP_MARGIN_S = 5e-4
TRACE_LEAD_S = 1.0


def schedule(rate: float, seconds: float, seed: int, pool: int) -> tuple:
    """(due offsets in seconds, pool row of each query)."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng = np.random.default_rng(data.subseed(seed, "schedule"))
    due = np.cumsum(rng.permutation(gaps))
    return due, rng.integers(0, pool, n)


def setup(h) -> dict:
    cfg, mix = h.cfg, h.mix
    sysm = h.system.System(cfg, h.device)
    h.mark("program")
    sysm.build_kernels()
    h.mark("kernels")
    x, y = data.planted_rows(cfg["m"], cfg["d"], cfg["data"]["margin"],
                             h.seed, h.device)
    h.mark("data")
    model = sysm.job(data.program_key(h.seed, MODEL_JOB), *sysm.split(x, y))
    h.mark("model_job")
    srv = sysm.server(model, data.program_key(h.seed, SERVE_KEY),
                      int(mix["batch_size"]), float(mix["window_ms"]))
    model.pop("state")
    h.mark("model_encode")
    pool = data.queries(int(mix["pool"]), cfg["d"], h.seed, h.device)
    bs = int(mix["batch_size"])
    for i in range(int(mix["warm_windows"])):      # full and ragged windows
        rows = pool[i * bs % len(pool):][:max(1, bs - i % 2)]
        q = sysm.queue(bs, float(mix["window_ms"]), time.perf_counter)
        for row in rows:
            q.submit(row)
        _, batch, nv = q.drain()
        srv._decide(srv.logits(batch)[:nv])
    h.mark("queries_and_warm_windows")
    return dict(sysm=sysm, srv=srv, model=model, pool=pool, x=x, y=y)


def serve_loop(sysm, srv, pool, due, index, mix, trace_for=None):
    """Offer the queries at their due offsets; returns what each got.

    trace_for: seconds of the last arrivals a traced stretch records, or
    None."""
    bs, wms = int(mix["batch_size"]), float(mix["window_ms"])
    n = len(due)
    clock = time.perf_counter
    q = sysm.queue(bs, wms, clock)
    done = np.full(n, np.nan)
    submit = np.full(n, np.nan)
    logits = np.zeros(n, np.float32)
    decisions = np.zeros(n, np.int32)
    answered = np.zeros(n, bool)
    windows = []                       # (start, end, first ticket, count)
    t0 = clock() + 1e-3
    due_abs = t0 + due
    tracing, profiled_from = None, None
    trace_at = None if trace_for is None else due_abs[-1] - trace_for
    i = 0
    while i < n or len(q):
        now = clock()
        if trace_at is not None:
            if tracing is None and now >= trace_at - TRACE_LEAD_S:
                profiled_from = clock()
                tracing = _Traced(sysm).start()
            if tracing is not None and tracing.window is None \
                    and now >= trace_at:
                tracing.open_window()
        while i < n and due_abs[i] <= now:
            q.submit(pool[index[i]])
            submit[i] = now
            i += 1
        if len(q) and q.ready(now):
            ws = clock()
            if tracing is not None:
                with trace.span("serve.window"):
                    tickets, lg, dec, nv = _window(srv, q)
            else:
                tickets, lg, dec, nv = _window(srv, q)
            we = clock()
            ids = np.asarray(tickets)
            done[ids], logits[ids], decisions[ids] = we, lg[:nv, 0], dec
            answered[ids] = True
            windows.append((ws, we, int(ids[0]), nv))
        elif not len(q) and i < n:
            wait = due_abs[i] - clock() - SLEEP_MARGIN_S
            if tracing is not None and tracing.window is None:
                wait = min(wait, trace_at - clock())
            if wait > 0:
                time.sleep(wait)
    dtrace = None if tracing is None else tracing.stop()
    return dict(due=due_abs, done=done, submit=submit, logits=logits,
                decisions=decisions, answered=answered, windows=windows,
                trace=dtrace, profiled_from=profiled_from)


def _window(srv, q):
    """One window as SecureServer._flush scores it."""
    tickets, batch, nv = q.drain()
    lg = srv.logits(batch)
    return tickets, lg, srv._decide(lg[:nv]), nv


class _Traced:
    def __init__(self, sysm):
        self.spans = trace.Spans(sysm.span_targets())
        self.dtrace = trace.DeviceTrace()
        self.window = None

    def start(self):
        self.spans.__enter__()
        self.dtrace.start()
        return self

    def open_window(self):
        self.window = trace.span("bench.window").__enter__()

    def stop(self):
        if self.window is None:
            self.open_window()
        self.window.__exit__(None, None, None)
        self.dtrace.stop()
        self.spans.__exit__(None, None, None)
        return self.dtrace


def untraced_windows(loop: dict) -> list:
    """(start, end, first ticket, count) of the windows that ended before
    the profiler started: every window of a run that traced nothing."""
    t = loop.get("profiled_from")
    wins = loop["windows"]
    return wins if t is None else [w for w in wins if w[1] < t]


def latency_stats(loop: dict) -> dict:
    """Latency of every query due in the window, from due time to decision;
    an unanswered query counts as infinitely late (a percentile that lands
    on one is left out, and the run is not correct)."""
    lat = np.where(loop["answered"], loop["done"] - loop["due"], np.inf)
    out = {}
    for name, q in (("query_p50_ms", 50), ("query_p95_ms", 95)):
        v = float(np.percentile(lat, q, method="inverted_cdf")) * 1e3
        if np.isfinite(v):
            out[name] = v
    return out


def run(h) -> dict:
    st = setup(h)
    mix = h.mix
    due, index = schedule(float(mix["rate_qps"]), h.seconds, h.seed,
                          len(st["pool"]))
    if h.trace:
        trace.warm_profiler()
    h.before_window()
    loop = serve_loop(st["sysm"], st["srv"], st["pool"], due, index, mix,
                      float(mix["trace_seconds"]) if h.trace else None)
    h.after_window()
    lateness = loop["submit"] - loop["due"]
    return dict(loop=loop, index=index, pool=st["pool"], model=st["model"],
                x=st["x"], y=st["y"], trace=loop["trace"],
                e2e=latency_stats(loop), attempted=len(due),
                failed=int((~loop["answered"]).sum()),
                notes=dict(windows=len(loop["windows"]),
                           submit_late_p95_ms=float(
                               np.nanpercentile(lateness, 95)) * 1e3))


def judge(h, record: dict) -> dict:
    """The served model's job by its exact step check (the start the
    queries' check follows), then every answered query."""
    ref = h.reference.Reference(h.cfg, record["x"], record["y"], h.device)
    model = record["model"]
    got = dict(step_gap=h.reference.judge_jobs(ref, [model])["step_gap"])
    loop = record["loop"]
    got.update(h.reference.judge_queries(
        ref, model["w"], record["pool"], record["index"], loop["logits"],
        loop["decisions"], loop["answered"]))
    return got
