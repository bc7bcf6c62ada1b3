"""queue_wait_ms.serve: median milliseconds from a query's due time to the
start of the window that scores it (the submit loop and the
MicroBatchQueue's batching), over the queries of the windows that ended
before the profiler started (a traced run's only; the profiler slows the
host)."""

import numpy as np

from drivers.open_loop import untraced_windows


def read(ctx):
    loop = ctx.record.get("loop")
    wins = [] if loop is None else untraced_windows(loop)
    if not wins:
        return None
    waits = [ws - loop["due"][first:first + n] for ws, _, first, n in wins]
    return float(np.median(np.concatenate(waits))) * 1e3
