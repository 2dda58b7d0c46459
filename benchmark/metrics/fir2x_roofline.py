"""K1's share of its roofline (%): the least time the card could take for
the FIR resamples the slice needs (`benchmark/work/kernels.py`), over the
device time of the fir2x kernels in it."""


def read(ctx, suffix):
    t = ctx.trace.class_s.get("fir2x", 0.0)
    if ctx.kind != suffix or t <= 0 or ctx.work.fir_bound_s <= 0:
        return None
    return 100.0 * ctx.work.fir_bound_s / t
