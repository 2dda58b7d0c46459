"""Device-stream time of the EMA of G (`ddgan.ema`) per train step of the
profiled slice (ms)."""

from ..spans import device_ms


def read(ctx, suffix):
    return device_ms(ctx, "ddgan.ema") if ctx.kind == suffix == "train" else None
