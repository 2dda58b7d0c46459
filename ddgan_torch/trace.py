"""Spans and counters inside `ddgan_torch`, recorded only while a
`torch.profiler` records.

`span(name, device)` is a context manager around one phase of the program
(`ddgan.step.d_update`, `ddgan.optim`, `ddgan.G.down16`, ...); spans nest,
and a span's parent is the innermost span open when it began. While no
profiler records, `span` returns one shared object whose enter and exit do
nothing: no `record_function`, no CUDA event, no clock read, nothing
allocated. The profiler is the one switch: the benchmark's traced slice and
the train loop's `profile_dir` turn the spans on with it. While a profiler
records, a span

  * enters `torch.profiler.record_function(name)`, so it lies on the
    profiler's timeline, on the clock the device's operations are stamped
    with: each idle gap of the device can be put down to the span the host
    was in;
  * takes its host time with `time.perf_counter_ns`;
  * on a CUDA device, records a pair of timing events on the current
    stream: its device-stream interval, from when the stream reaches the
    entry marker to when it has finished the span's last operation, idle
    time inside the span included.

`count(name, n)` adds to a counter of the innermost open span, under the
same switch (the FIR and gated-conv calls by role, `ops/fir2x.py`,
`ops/pair_conv.py`). The stack of open spans is one for the process, not
one a thread: on CUDA autograd runs a backward on its own worker thread
while the calling thread waits in `backward()`, so a count made by a
backward op lands in the span that called `backward`.

The recorder keeps its records in memory and never synchronizes while it
records; `summary()` resolves the events when asked, waiting for the work
they mark, and `reset()` clears the records.
"""

from __future__ import annotations

import threading
import time

import torch
from torch.autograd import profiler as _profiler

# the name that counts made while no span is open are kept under
OUTSIDE = "(no span)"


class _Off:
    """The span of a program that no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Stats:
    __slots__ = ("calls", "host_ns", "parents", "counters", "device_ms", "pending")

    def __init__(self):
        self.calls = 0
        self.host_ns = 0
        self.parents: dict = {}  # parent's name (None at the top) -> calls
        self.counters: dict = {}
        self.device_ms = None  # resolved device-stream ms; None without events
        self.pending: list = []  # (start, end) CUDA events not yet resolved


class _Span:
    __slots__ = ("rec", "name", "device", "parent", "rf", "events", "t0")

    def __init__(self, rec: "Recorder", name: str, device):
        self.rec, self.name, self.device = rec, name, device

    def __enter__(self):
        rec = self.rec
        with rec.lock:
            self.parent = rec.stack[-1].name if rec.stack else None
            rec.stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        dev = self.device
        if dev is not None and torch.device(dev).type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        else:
            self.events = None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        host_ns = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record()
        self.rf.__exit__(*exc)
        rec = self.rec
        with rec.lock:
            rec.stack.remove(self)
            s = rec._stats(self.name)
            s.calls += 1
            s.host_ns += host_ns
            s.parents[self.parent] = s.parents.get(self.parent, 0) + 1
            if self.events is not None:
                s.pending.append(self.events)
        return False


class Recorder:
    """The spans and counters of one process (`RECORDER`); see the module's
    docstring."""

    def __init__(self):
        self.lock = threading.Lock()
        self.stack: list = []  # open spans, innermost last
        self.records: dict = {}  # name -> _Stats

    def _stats(self, name: str) -> _Stats:
        s = self.records.get(name)
        if s is None:
            s = self.records[name] = _Stats()
        return s

    def span(self, name: str, device: torch.device | str | None = None):
        """A context manager around one phase; `device` is where its work
        runs (device-stream time is taken on a CUDA device only). Does
        nothing while no profiler records."""
        if not _profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name, device)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name` of the innermost open span (of
        `OUTSIDE` when none is open), while a profiler records."""
        if not _profiler._is_profiler_enabled:
            return
        with self.lock:
            c = self._stats(self.stack[-1].name if self.stack else OUTSIDE).counters
            c[name] = c.get(name, 0) + n

    def summary(self) -> dict:
        """{span name: {"calls", "host_ms", "device_ms", "parents",
        "counters"}}: totals since the last reset. `device_ms` is the sum of
        the spans' device-stream intervals, None for spans that took none
        (on the CPU); resolving them waits for the work they mark."""
        with self.lock:
            out = {}
            for name, s in self.records.items():
                for start, end in s.pending:
                    end.synchronize()
                    s.device_ms = (s.device_ms or 0.0) + start.elapsed_time(end)
                s.pending = []
                out[name] = {"calls": s.calls, "host_ms": s.host_ns * 1e-6,
                             "device_ms": s.device_ms, "parents": dict(s.parents),
                             "counters": dict(s.counters)}
            return out

    def reset(self) -> None:
        """Clear the records (spans still open are kept on the stack)."""
        with self.lock:
            self.records = {}

    def lines(self, units: int, unit: str = "step") -> list[str]:
        """One line per span name, by name: calls, host ms and device-stream
        ms per `unit` over `units` of them, the parents, and the counters
        per `unit`."""
        per = 1.0 / max(units, 1)
        out = []
        for name, s in sorted(self.summary().items()):
            dev = "-" if s["device_ms"] is None else f"{s['device_ms'] * per:.3f}"
            parents = ", ".join(sorted(p or "-" for p in s["parents"])) or "-"
            line = (f"span {name}: {s['calls'] * per:.2f} calls, host {s['host_ms'] * per:.3f} "
                    f"ms, device {dev} ms a {unit} (in {parents})")
            if s["counters"]:
                line += "; " + ", ".join(f"{k} {v * per:g}"
                                         for k, v in sorted(s["counters"].items()))
            out.append(line)
        return out


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
summary = RECORDER.summary
reset = RECORDER.reset
lines = RECORDER.lines
