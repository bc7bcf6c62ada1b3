"""query_p50_ms: median latency, due time to decision, over every query
due in the window (an unanswered one counts as infinitely late)."""


def read(ctx):
    return ctx.record["e2e"].get("query_p50_ms")
