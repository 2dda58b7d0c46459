"""The readers of the port's own spans (`benchmark/spans.py` and the
metrics `d_update_ms`, `g_update_ms`, `optim_ms`, `ema_ms`, `g_forward_ms`,
`program_idle_ms`): on a recorder filled on the CPU (CUDA's timing events
made up), on a made-up `TraceSummary`, and the cases with nothing to read,
a `ddgan_torch` without `trace.py` among them."""

import json
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.metrics import (d_update_ms, ema_ms, g_forward_ms, g_update_ms, optim_ms,
                               program_idle_ms)
from benchmark.mixes import Reading
from benchmark.trace import Ev, summarize
from conftest import ROOT
from ddgan_torch import trace

DEVICE_READERS = {d_update_ms: "train", g_update_ms: "train", optim_ms: "train",
                  ema_ms: "train", g_forward_ms: "sample"}


class FakeEvent:
    """A CUDA timing event on a made-up stream whose every record is 1 ms
    after the one before."""

    tick = 0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        FakeEvent.tick += 1
        self.at = FakeEvent.tick

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


def reading(kind: str, units: int = 2, events=()) -> Reading:
    return Reading(kind=kind, trace=summarize(list(events), 1e-3, units), rate=1.0, window={},
                   work=None, flops_per_item=0.0)


@pytest.fixture
def recorder(monkeypatch):
    """Two train steps' phases and two sampler calls' G forwards, recorded
    on a made-up CUDA device: each span 1 ms of device stream."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    trace.reset()
    cuda = torch.device("cuda")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            for name in ("ddgan.step.d_update", "ddgan.step.g_update", "ddgan.optim",
                         "ddgan.optim", "ddgan.ema"):
                with trace.span(name, cuda):
                    torch.zeros(1)
            for _ in range(3):
                with trace.span("ddgan.sample.G", cuda):
                    torch.zeros(1)
    yield trace
    trace.reset()


def test_device_readers_take_the_spans_device_ms_per_unit(recorder):
    assert d_update_ms.read(reading("train"), "train") == 1.0
    assert g_update_ms.read(reading("train"), "train") == 1.0
    assert optim_ms.read(reading("train"), "train") == 2.0  # D's and G's a step
    assert ema_ms.read(reading("train", units=4), "train") == 0.5
    assert g_forward_ms.read(reading("sample"), "sample") == 3.0
    for reader, kind in DEVICE_READERS.items():
        other = "sample" if kind == "train" else "train"
        assert reader.read(reading(other), other) is None
        assert reader.read(reading(kind), other) is None


def test_device_readers_read_nothing_without_device_time_or_spans():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("ddgan.step.d_update", torch.device("cpu")):  # no events on the CPU
            torch.zeros(1)
    assert trace.summary()["ddgan.step.d_update"]["device_ms"] is None
    assert d_update_ms.read(reading("train"), "train") is None
    trace.reset()
    for reader, kind in DEVICE_READERS.items():
        assert reader.read(reading(kind), kind) is None


def test_program_idle_counts_gaps_under_the_ports_spans_only():
    events = [
        Ev("bench.train_step", False, 0, 100),
        Ev("ddgan.step", False, 0, 100),
        Ev("ddgan.step.d_update", False, 0, 50),
        Ev("aten::add", False, 60, 80),
        # device: gaps [10, 30] (midpoint 20, in the D update: the port's
        # own Python) and [55, 90] (midpoint 72.5, in a torch call)
        Ev("k1", True, 0, 10), Ev("k2", True, 30, 55), Ev("k3", True, 90, 100),
    ]
    ctx = reading("train", units=2, events=events)
    assert ctx.trace.gap_s == {"ddgan.step.d_update": pytest.approx(20e-6),
                               "aten::add": pytest.approx(35e-6)}
    assert program_idle_ms.read(ctx, "train") == pytest.approx(1e3 * 20e-6 / 2)
    assert program_idle_ms.read(ctx, "sample") is None
    # the parent's spans: the benchmark's own, no gap under the port's
    parent = [Ev("bench.sample_call", False, 0, 100), Ev("k1", True, 0, 10),
              Ev("k2", True, 30, 100)]
    assert program_idle_ms.read(reading("sample", events=parent), "sample") is None


READ_WITHOUT_TRACE = """
import json, sys
sys.path.insert(0, {pkg!r}); sys.path.insert(1, {root!r})
import ddgan_torch
assert not hasattr(ddgan_torch, "trace") and ddgan_torch.__file__.startswith({pkg!r})
from benchmark.mixes import Reading
from benchmark.trace import TraceSummary
from benchmark.metrics import (d_update_ms, ema_ms, g_forward_ms, g_update_ms, optim_ms,
                               program_idle_ms)
out = []
for kind in ("train", "sample"):
    ts = TraceSummary(units=2, window_s=1.0, busy_s=0.5, class_s={{}}, class_n={{}}, op_s={{}},
                      launches=0, gap_s={{"bench.train_step": 0.1, "aten::mm": 0.2}})
    ctx = Reading(kind=kind, trace=ts, rate=1.0, window={{}}, work=None, flops_per_item=0.0)
    out += [m.read(ctx, kind) for m in (d_update_ms, g_update_ms, optim_ms, ema_ms,
                                        g_forward_ms, program_idle_ms)]
print(json.dumps(out))
"""


def test_a_port_without_the_recorder_reads_nothing_and_raises_nothing(tmp_path):
    (tmp_path / "ddgan_torch").mkdir()
    (tmp_path / "ddgan_torch" / "__init__.py").write_text("")
    code = READ_WITHOUT_TRACE.format(pkg=str(tmp_path), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [None] * 12
