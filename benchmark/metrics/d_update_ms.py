"""Device-stream time of the D update (`ddgan.step.d_update`: the pairs, G's
no-grad forward, both D forwards, R1 and D's backward) per train step of the
profiled slice, a whole lazy_reg period (ms)."""

from ..spans import device_ms


def read(ctx, suffix):
    return device_ms(ctx, "ddgan.step.d_update") if ctx.kind == suffix == "train" else None
