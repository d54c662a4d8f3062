"""setup_s: seconds from the process's start to the window's opening: the
imports, the kernels' build or load, the weights, the pool, the warm-up
requests and every graph capture (host clock)."""


def read(ctx):
    return ctx.obs.setup_s
