"""step_mfu.train: one iteration's least time over its measured time, in
percent.  The least time is the larger of the paper's useful field
operations (copml_model_ops: model encode, coded gradient, decode) at the
field peak and the least bytes (X~ once, the model and X^T y shares read,
the new model written) at HBM bandwidth; at the paper's shapes the bytes
bound it.  The measured time is iter_ms.train's: the program's
`timings["iters_s"]` over its iterations, on the untraced jobs."""

from yardstick import readings


def read(ctx):
    jobs = readings.untraced_jobs(ctx)
    if not jobs:
        return None
    cfg, rl = ctx.cfg, ctx.roofline
    iter_s = sum(j["timings"]["iters_s"] for j in jobs) / (
        cfg["iters"] * len(jobs))
    n, m, d, k, t = (cfg[x] for x in ("n_clients", "m", "d", "k", "t"))
    r = (2 * cfg["r"] + 1) * (k + t - 1) + 1
    least, _ = rl.bound_s(rl.copml_model_ops(n, m, d, k, t, r),
                          rl.copml_step_bytes(n, m, d, k))
    return 100.0 * least / iter_s
