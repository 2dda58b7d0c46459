"""Host kernel and graph launch calls per step or call of the profiled
slice (the profiler's launch API events; a captured graph counts one)."""


def read(ctx, suffix):
    if ctx.kind != suffix or not ctx.trace.launches:
        return None
    return ctx.trace.launches / ctx.trace.units
