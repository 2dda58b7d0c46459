"""Device-stream time of the G update (`ddgan.step.g_update`: fresh pairs, G
forward, posterior, D forward, G's backward) per train step of the profiled
slice (ms)."""

from ..spans import device_ms


def read(ctx, suffix):
    return device_ms(ctx, "ddgan.step.g_update") if ctx.kind == suffix == "train" else None
