"""The share of the profiled slice's wall time in which no operation ran on
the device (%)."""


def read(ctx, suffix):
    return 100.0 * ctx.trace.idle_share if ctx.kind == suffix else None
