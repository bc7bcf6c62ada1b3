"""score_roofline.serve: the score GEMM's least time (the yardstick's
gemm_work bound of (B, d) @ (d, N * C')) over the device time of the
kernels launched inside the `serve.score_shares` ranges, per call, in
percent."""

from yardstick import readings


def read(ctx):
    return readings.range_roofline(ctx, "serve.score_shares",
                                   ctx.roofline.gemm_work(
                                       int(ctx.mix["batch_size"]),
                                       ctx.cfg["d"], ctx.cfg["n_clients"]))
