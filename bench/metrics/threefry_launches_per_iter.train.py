"""threefry_launches_per_iter.train: CUDA kernels whose launching call lies
in a `random.threefry` range (core.random's bulk draws) inside a
`train.step` range, the program's own spans, in the traced job, over the
number of `train.step` ranges: the share of launches_per_iter.train that
the host's threefry draws make.  None where the trace has no such
range."""

import bisect


def read(ctx):
    tr = ctx.trace
    steps = None if tr is None else tr.ranges.get("train.step")
    if not steps or not tr.ranges.get("random.threefry"):
        return None
    n = 0
    for op in tr.ops_launched_in("random.threefry"):
        t = tr.launch_ns[op[3]]
        i = bisect.bisect_right(steps, (t, float("inf"))) - 1
        n += i >= 0 and steps[i][0] <= t <= steps[i][1]
    return n / len(steps) if n else None
