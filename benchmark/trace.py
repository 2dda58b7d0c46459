"""The reader of one `torch.profiler` slice: device time by kernel class,
the device's busy time (the union of its kernel and copy intervals), the
host's launch calls, and the `breakdown` of the result line (the device
operations that took most time, and the idle gaps by what the host was
doing while the device waited).

`profile(fn, units)` runs `fn` under the profiler and reads its events;
`summarize` does the reading on plain `Ev` records, so it can be tested on
a made-up event list.
"""

from __future__ import annotations

import dataclasses
import heapq
import time

# host calls that put work on the device: kernel and graph launches
LAUNCH_APIS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                         "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
                         "cuGraphLaunch"})
TOP = 10


def kernel_class(name: str) -> str:
    """The class of a device operation by its name; a copy of
    `chip_smoke.py:_kernel_class`, with copies and fills named apart."""
    low = name.lower()
    if "fir2x" in low or "down2x_kernel" in low or "up2x_kernel" in low:
        return "fir2x"
    if "pair_conv3x3" in low:
        return "pair_conv3x3"
    if any(s in low for s in ("conv", "cudnn", "xmma", "implicit", "winograd", "fft")):
        return "convolution"
    if any(s in low for s in ("gemm", "cutlass", "cublas", "sm90_")):
        return "matmul"
    if "reduce" in low or "norm" in low or "softmax" in low:
        return "reduction/norm/softmax"
    return "elementwise/copy/other"


@dataclasses.dataclass(frozen=True)
class Ev:
    name: str
    device: bool  # an operation on the device (kernel, copy, fill)
    start_us: float
    end_us: float


@dataclasses.dataclass
class TraceSummary:
    units: int  # steps or calls in the slice
    window_s: float  # the slice's wall time
    busy_s: float  # union of the device's operation intervals
    class_s: dict  # seconds by kernel class
    class_n: dict  # operations by kernel class
    op_s: dict  # seconds by device operation name
    launches: int  # host launch calls
    gap_s: dict  # idle seconds by what the host was doing

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(self.op_s), "idle_gaps": top(self.gap_s)}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _gap_names(gaps, host):
    """For each gap (start, end), the innermost host operation (the latest
    started) that covers its midpoint, or "none"."""
    host = sorted(host, key=lambda e: e.start_us)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    names, active, j = [None] * len(gaps), [], 0
    for i in order:
        mid = (gaps[i][0] + gaps[i][1]) / 2.0
        while j < len(host) and host[j].start_us <= mid:
            heapq.heappush(active, (-host[j].start_us, host[j].end_us, host[j].name))
            j += 1
        # the latest started first; one that ended before this midpoint
        # ended before every later one too
        while active and active[0][1] < mid:
            heapq.heappop(active)
        names[i] = active[0][2] if active else "none"
    return names


def summarize(events, window_s: float, units: int) -> TraceSummary:
    dev = [e for e in events if e.device]
    host = [e for e in events if not e.device]
    class_s: dict = {}
    class_n: dict = {}
    op_s: dict = {}
    for e in dev:
        d = (e.end_us - e.start_us) * 1e-6
        cls = kernel_class(e.name)
        class_s[cls] = class_s.get(cls, 0.0) + d
        class_n[cls] = class_n.get(cls, 0) + 1
        op_s[e.name] = op_s.get(e.name, 0.0) + d
    merged = _merge([(e.start_us, e.end_us) for e in dev])
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps = []
    if host and merged:
        first = min(e.start_us for e in host)
        if merged[0][0] > first:
            gaps.append((first, merged[0][0]))
    gaps += [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    gap_s: dict = {}
    for (s, e), name in zip(gaps, _gap_names(gaps, host)):
        gap_s[name] = gap_s.get(name, 0.0) + (e - s) * 1e-6
    launches = sum(e.name in LAUNCH_APIS for e in host)
    return TraceSummary(units=units, window_s=window_s, busy_s=busy, class_s=class_s,
                        class_n=class_n, op_s=op_s, launches=launches, gap_s=gap_s)


def check_launches(cls: str, launched: int, summary: TraceSummary) -> None:
    """Say on standard error when the trace holds another number of `cls`
    kernels than the program counted launches of (a ctypes launch that the
    profiler does not see)."""
    import sys

    traced = summary.class_n.get(cls, 0)
    if traced != launched:
        print(f"trace: {traced} {cls} kernels traced, {launched} launched", file=sys.stderr)


def events_of(prof) -> list[Ev]:
    """The profiler's events as `Ev`s; the device-side copies of host
    annotations are not device operations and are left out."""
    out = []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) and str(e.device_type).endswith("CUDA"):
            continue
        out.append(Ev(e.name, str(e.device_type).endswith("CUDA"), float(e.time_range.start),
                      float(e.time_range.end)))
    return out


def profile(fn, units: int) -> TraceSummary:
    """Run `fn` (which does `units` steps or calls) under the profiler,
    between two synchronizes, and read the slice."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return summarize(events_of(prof), window_s, units)
