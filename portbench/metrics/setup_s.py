"""setup_s: seconds from the process's start to the window's: imports,
CUDA init, the kernels' build (a checkout's first run) and load, the
twin and its BAL file, and the warm-up solve."""


def read(ctx):
    return ctx.setup_s
