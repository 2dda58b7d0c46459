"""Device time per step or call of the library's convolution and GEMM
kernels in the profiled slice (ms)."""

CLASSES = ("convolution", "matmul")


def read(ctx, suffix):
    s = sum(ctx.trace.class_s.get(c, 0.0) for c in CLASSES)
    return 1e3 * s / ctx.trace.units if ctx.kind == suffix and s > 0 else None
