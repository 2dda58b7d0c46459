"""Device-stream time of the sampler's G forwards (every `ddgan.sample.G`)
per sampler call of the profiled slice (ms)."""

from ..spans import device_ms


def read(ctx, suffix):
    return device_ms(ctx, "ddgan.sample.G") if ctx.kind == suffix == "sample" else None
