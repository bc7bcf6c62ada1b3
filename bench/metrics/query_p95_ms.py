"""query_p95_ms: 95th percentile of the latency, due time to decision,
over every query due in the window (an unanswered one counts as
infinitely late)."""


def read(ctx):
    return ctx.record["e2e"].get("query_p95_ms")
