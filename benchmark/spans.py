"""The port's own spans (`ddgan_torch.trace`) as the per-layer readers see
them. The port records them only while a profiler records, which in a run
is the traced slice alone, and the readers run after the slice's final
synchronize. Each function returns None where there is nothing to read: a
program without `ddgan_torch.trace`, an empty recorder, no such span, a
span that took no device time, no idle gap under a span of the port."""

from __future__ import annotations

PREFIX = "ddgan."


def recorded() -> dict | None:
    """The port recorder's summary, or None."""
    try:
        from ddgan_torch import trace
    except ImportError:
        return None
    return trace.summary() or None


def device_ms(ctx, *names: str) -> float | None:
    """The device-stream ms of every call of the spans `names`, per step or
    call of the slice."""
    spans = recorded()
    if not spans:
        return None
    ms = [spans[n]["device_ms"] for n in names if n in spans]
    ms = [v for v in ms if v is not None]
    return sum(ms) / ctx.trace.units if ms else None


def program_idle_ms(ctx) -> float | None:
    """The slice's idle ms per step or call in gaps whose covering host
    event is a span of the port: the host was in the port's own code, in no
    torch call."""
    gaps = [s for name, s in ctx.trace.gap_s.items() if name.startswith(PREFIX)]
    return 1e3 * sum(gaps) / ctx.trace.units if gaps else None
