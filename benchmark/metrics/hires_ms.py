"""Kernel time of G's levels at 512x512 and above (the spans
`ddgan.G.down<side>` and `ddgan.G.up<side>`, side >= 512, the pyramid
steps inside them included) per sampler call (ms), from the eager G
forward of a `sample_skip` trace scaled to a call's T forwards."""

import re

from ..mixes.sample_skip import per_call_ms

LEVEL = re.compile(r"ddgan\.G\.(?:down|up)(\d+)")
MIN_SIDE = 512


def read(ctx, suffix):
    if ctx.kind != suffix or suffix != "sample":
        return None
    names = [n for n in ctx.window.get("eager_ms") or {}
             if (m := LEVEL.fullmatch(n)) and int(m.group(1)) >= MIN_SIDE]
    return per_call_ms(ctx, names)
