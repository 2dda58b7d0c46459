"""Device time per step or call of the elementwise, copy, cast, norm and
reduction kernels in the profiled slice (ms)."""

CLASSES = ("elementwise/copy/other", "reduction/norm/softmax")


def read(ctx, suffix):
    s = sum(ctx.trace.class_s.get(c, 0.0) for c in CLASSES)
    return 1e3 * s / ctx.trace.units if ctx.kind == suffix and s > 0 else None
