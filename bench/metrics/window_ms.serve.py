"""window_ms.serve: mean wall milliseconds of one scoring window (drain,
quantize, the packed score GEMM, open, dequantize, decide; a host clock
around SecureServer's window path), over the windows that ended before
the profiler started (a traced run's only; the profiler slows the host)."""

from drivers.open_loop import untraced_windows


def read(ctx):
    loop = ctx.record.get("loop")
    wins = [] if loop is None else untraced_windows(loop)
    if not wins:
        return None
    return 1e3 * sum(we - ws for ws, we, _, _ in wins) / len(wins)
