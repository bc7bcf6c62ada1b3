"""window_mfu.serve: one scoring window's least time (serve_window_work:
the B queries and the model shares read once, the score GEMM and the open
of B logits from T + 1 shares, the logits written) over its measured wall
time (window_ms.serve's windows: those that ended before the profiler
started), in percent."""

from drivers.open_loop import untraced_windows


def read(ctx):
    loop, cfg, rl = ctx.record.get("loop"), ctx.cfg, ctx.roofline
    wins = [] if loop is None else untraced_windows(loop)
    if not wins:
        return None
    least, _ = rl.bound_s(*rl.serve_window_work(
        int(ctx.mix["batch_size"]), cfg["d"], cfg["n_clients"], cfg["t"], 1))
    return 100.0 * least * len(wins) / sum(we - ws for ws, we, _, _ in wins)
