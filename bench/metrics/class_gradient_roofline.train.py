"""class_gradient_roofline.train: the fused step's least time at the
configuration's C = `n_classes` model columns (the yardstick's fused_work
bound at N, ceil(m/K), d, C, degree r) over the device time of the
kernels launched inside the `kernels.fused_step` ranges, per call, in
percent."""

from yardstick import readings


def read(ctx):
    cfg = ctx.cfg
    mk = -(-cfg["m"] // cfg["k"])
    return readings.range_roofline(ctx, "kernels.fused_step",
                                   ctx.roofline.fused_work(
                                       cfg["n_clients"], mk, cfg["d"],
                                       int(cfg.get("n_classes", 1)),
                                       cfg["r"]))
