"""K2's share of its roofline (%): the least time the card could take for
the gated 3x3 convs the slice needs, forward and their K2 input gradients
(`benchmark/work/kernels.py`), over the device time of the pair_conv3x3
kernels in it."""


def read(ctx, suffix):
    t = ctx.trace.class_s.get("pair_conv3x3", 0.0)
    if ctx.kind != suffix or t <= 0 or ctx.work.pair_conv_bound_s <= 0:
        return None
    return 100.0 * ctx.work.pair_conv_bound_s / t
