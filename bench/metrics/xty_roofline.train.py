"""xty_roofline.train: set-up's X^T y (Phase 2d, the program's `setup.xty`
span: every client's secure product of its (d, m) shares of X^T against
its shares of the C' target columns, C' = `n_classes`, else 1) -- N
times the yardstick's gemm_work of a (d, m) @ (m, C') GEMM -- over the
device time of the kernels launched inside the `setup.xty` ranges, per
range, in percent.  None where the program opens no such span."""

from yardstick import readings


def read(ctx):
    cfg = ctx.cfg
    ops, nbytes = ctx.roofline.gemm_work(cfg["d"], cfg["m"],
                                         int(cfg.get("n_classes", 1)))
    n = cfg["n_clients"]
    return readings.range_roofline(ctx, "setup.xty", (n * ops, n * nbytes))
