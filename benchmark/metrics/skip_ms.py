"""Kernel time of G's output and input pyramids (`ddgan.G.skip_out`:
each level's head, up2x and sum; `ddgan.G.skip_in`: each transition's
down2x and combine) per sampler call (ms), from the eager G forward of a
`sample_skip` trace scaled to a call's T forwards."""

from ..mixes.sample_skip import per_call_ms

SPANS = ("ddgan.G.skip_out", "ddgan.G.skip_in")


def read(ctx, suffix):
    return per_call_ms(ctx, SPANS) if ctx.kind == suffix == "sample" else None
