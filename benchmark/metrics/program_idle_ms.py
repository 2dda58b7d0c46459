"""Idle time of the device per step or call of the profiled slice in gaps
whose covering host event is a span of the port (`ddgan.*`): the host was
in the port's own Python, in no torch call (ms)."""

from ..spans import program_idle_ms


def read(ctx, suffix):
    return program_idle_ms(ctx) if ctx.kind == suffix else None
