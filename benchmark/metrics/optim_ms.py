"""Device-stream time of both optimizer steps (`ddgan.optim`, D's then G's:
zero-fill, rank mean, clip, Adam) per train step of the profiled slice (ms)."""

from ..spans import device_ms


def read(ctx, suffix):
    return device_ms(ctx, "ddgan.optim") if ctx.kind == suffix == "train" else None
