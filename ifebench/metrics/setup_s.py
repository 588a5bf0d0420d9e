"""setup_s (host clock): process start to the first timed scan: imports,
CUDA init, loading (on a checkout's first run, building) the kernel
library, making the pool and the ROIs, and the warm-up scans."""


def read(ctx):
    return ctx.setup_s
