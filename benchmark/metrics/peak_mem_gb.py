"""Peak device memory allocated over the window, after a reset at its start
(GB, 1e9 bytes)."""


def read(ctx, suffix):
    if ctx.kind != suffix or "peak_bytes" not in ctx.window:
        return None
    return ctx.window["peak_bytes"] / 1e9
