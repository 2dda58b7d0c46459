"""Mean device time of an R1 step of the window, from CUDA events around
each R1 step (ms)."""


def read(ctx, suffix):
    spans = ctx.window.get("r1_ms") if ctx.kind == suffix == "train" else None
    return sum(spans) / len(spans) if spans else None
