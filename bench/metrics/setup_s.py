"""setup_s: seconds from process start to the window's start (imports,
the CUDA context, the kernels loaded or built, the rows made from the seed,
the warm-up)."""


def read(ctx):
    return ctx.setup_s
