"""The port's spans and counters (`ddgan_torch.trace`) on the CPU, at a tiny
size: off (one shared no-op, nothing recorded, nothing read or allocated)
while no profiler records; on under `torch.profiler`, every span of the
train step, the optimizers, the EMA, the sampler, G's levels and D with its
parents and call counts, on the profiler's timeline around its own ops; the
FIR and gated-conv counters by span adding up to the ops' global `CALLS`;
and the outputs bit for bit the same either way."""

import bisect
import json
import threading
import time
import tracemalloc
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ddgan_torch import models, trace
from ddgan_torch.cli import test_cli
from ddgan_torch.config import Config
from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients
from ddgan_torch.ops import fir2x, pair_conv
from ddgan_torch.train import ClippedAdam, create_train_state, make_train_step

T = 2
CFG = Config.from_dict(dict(
    image_size=16, num_channels=3, num_channels_dae=8, ch_mult=[1, 2], num_res_blocks=1,
    attn_resolutions=[8], nz=4, z_emb_dim=8, n_mlp=1, t_emb_dim=8, ngf=4, num_timesteps=T,
    batch_size=4, dropout=0.1, lazy_reg=2))
LEVELS = ("ddgan.G.embed", "ddgan.G.down16", "ddgan.G.down8", "ddgan.G.mid", "ddgan.G.up8",
          "ddgan.G.up16", "ddgan.G.out")


@pytest.fixture(autouse=True)
def clean_recorder():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    yield
    trace.reset()
    torch.set_num_threads(n)


def _boom(*a, **k):
    raise AssertionError("the off span touched the profiler, a clock or an event")


def _run(traced: Path | None):
    """Two train steps (an R1 step, then one without) and a sampler call
    from fixed seeds, under a CPU profiler when `traced` names a file: then
    (outputs, the events of the trace the profiler exports there, as the
    train loop's `profile_dir` has it); else (outputs, None)."""
    g = torch.Generator().manual_seed(0)
    gen = models.NCSNpp.from_config(CFG, generator=g)
    disc = models.build_discriminator(CFG, g)
    state = create_train_state(gen, disc, ClippedAdam(gen.parameters(), 0.5, 0.9),
                               ClippedAdam(disc.parameters(), 0.5, 0.9), use_ema=True)
    step = make_train_step(
        DiffusionCoefficients.create(T, 0.1, 20.0, device="cpu"),
        PosteriorCoefficients.create(T, 0.1, 20.0, device="cpu"), num_timesteps=T, nz=CFG.nz,
        r1_gamma=0.02, lazy_reg=2, ema_decay=0.99, use_ema=True)
    rng = torch.Generator().manual_seed(1)
    real = torch.rand((4, 3, 16, 16), generator=torch.Generator().manual_seed(5)) * 2 - 1
    sample = test_cli.make_sampler(CFG, gen, 4, torch.device("cpu"), rng)

    def work():
        ms = [step(state, real, rng, 1e-3, 1e-3) for _ in range(2)]
        gen.eval()
        return ms, sample()

    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ms, images = work()
        prof.export_chrome_trace(str(traced))
        events = json.loads(traced.read_text())["traceEvents"]
    else:
        events, (ms, images) = None, work()
    out = {"losses": [torch.stack(list(m)) for m in ms], "images": [images],
           "G": [p.detach().clone() for p in gen.parameters()],
           "D": [p.detach().clone() for p in disc.parameters()],
           "ema": [v.clone() for v in state.ema_G.values()]}
    return out, events


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tiny run off (with the profiler's range, the CUDA event and the
    clock made to raise, and what it left in the recorder) and on (its
    summary, events and the FIR calls it made)."""
    torch.set_num_threads(1)
    trace.reset()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.profiler, "record_function", _boom)
        m.setattr(torch.cuda, "Event", _boom)
        m.setattr(time, "perf_counter_ns", _boom)
        off, _ = _run(None)
    left = trace.summary()
    fir2x.reset_launch_counts()
    on, events = _run(tmp_path_factory.mktemp("trace") / "trace.json")
    calls = {p: dict(roles) for p, roles in fir2x.CALLS.items()}
    return {"off": off, "left": left, "on": on, "events": events, "summary": trace.summary(),
            "calls": calls}


def test_off_a_span_is_one_shared_noop_that_reads_and_records_nothing(runs, monkeypatch):
    assert runs["left"] == {}
    assert trace.span("a") is trace.span("b", torch.device("cuda"))
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(torch.cuda, "Event", _boom)
    monkeypatch.setattr(time, "perf_counter_ns", _boom)
    span, dev = trace.span, torch.device("cuda")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with span("ddgan.x", dev):
                trace.count("c")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__ and d.size_diff > 0]
    assert not grown, grown
    assert trace.summary() == {}


def test_a_traced_step_and_sampler_call_give_every_span_with_its_parents(runs):
    s = runs["summary"]
    d, g, r1 = "ddgan.step.d_update", "ddgan.step.g_update", "ddgan.step.r1"
    want = {
        "ddgan.step": {None: 2}, "ddgan.step.draws": {"ddgan.step": 2}, d: {"ddgan.step": 2},
        r1: {d: 1}, g: {"ddgan.step": 2}, "ddgan.optim": {"ddgan.step": 4},
        "ddgan.ema": {"ddgan.step": 2}, "ddgan.sample": {None: 1},
        "ddgan.sample.G": {"ddgan.sample": T}, "ddgan.sample.posterior": {"ddgan.sample": T},
        # D: fake and real in each D update, R1's own forward below 256², G's update
        "ddgan.D": {d: 4, r1: 1, g: 2},
        # attention at 8², in each of G's 4 + T forwards: after the down
        # level's resblock, in the middle, up
        "ddgan.G.attn": {"ddgan.G.down8": 4 + T, "ddgan.G.mid": 4 + T, "ddgan.G.up8": 4 + T},
    }
    for name in LEVELS:  # G twice a step, T times in the sampler
        want[name] = {d: 2, g: 2, "ddgan.sample.G": T}
    assert {k: v["parents"] for k, v in s.items()} == want
    for name, v in s.items():
        assert v["calls"] == sum(want[name].values()) and v["host_ms"] > 0, name
        assert v["device_ms"] is None, name  # no CUDA device, no events
    # each span on the profiler's timeline, around aten ops of its own
    events = [e for e in runs["events"] if e.get("ph") == "X"]
    aten = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e["name"].startswith("aten::"))
    for name, v in s.items():
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == name]
        assert len(spans) == v["calls"], name
        for a, b in spans:
            i = bisect.bisect_left(aten, (a,))
            assert i < len(aten) and aten[i][1] <= b, name


def test_counters_add_up_span_by_span_to_the_global_calls(runs):
    s = runs["summary"]
    total: dict = {}
    for v in s.values():
        for k, n in v["counters"].items():
            total[k] = total.get(k, 0) + n
    calls = runs["calls"]
    # and the sampler's G calls by path: on the CPU every one is eager
    assert total == {**{f"fir2x.{p}.{r}": n for p, roles in calls.items()
                        for r, n in roles.items() if n}, "sampler.graph.eager": T}
    assert s["ddgan.sample.G"]["counters"]["sampler.graph.eager"] == T
    # R1's first order in its own span; its second order in D's backward,
    # which the D update calls
    second = calls["down2x"]["second_order"]
    assert second > 0 and s["ddgan.step.r1"]["counters"] == {"fir2x.up2x.backward": second}
    assert s["ddgan.step.d_update"]["counters"]["fir2x.down2x.second_order"] == second
    assert "fir2x.down2x.forward" in s["ddgan.D"]["counters"]


def test_gated_conv_counters_follow_the_innermost_span():
    pair_conv.reset_launch_counts()
    x = torch.randn(1, 2, 128, 128).to(torch.bfloat16).requires_grad_(True)
    w, b = torch.randn(64, 2, 3, 3), torch.zeros(64)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("ddgan.k2"):
            y = pair_conv.pair_conv3x3(x, w, b)
        y.float().sum().backward()  # the library dx: outside any span
    s = trace.summary()
    assert pair_conv.CALLS == {"forward": 1, "dx": 0, "dx_library": 1}
    assert s["ddgan.k2"]["counters"] == {"pair_conv3x3.forward": 1}
    assert s[trace.OUTSIDE]["counters"] == {"pair_conv3x3.dx_library": 1}


def test_a_count_from_another_thread_lands_in_the_span_open_in_the_process():
    """As a backward op's count on autograd's worker thread lands in the
    span whose thread waits in `backward()`."""
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("ddgan.outer"):
            with trace.span("ddgan.inner"):
                t = threading.Thread(target=trace.count, args=("c", 3))
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
    s = trace.summary()
    assert s["ddgan.inner"]["counters"] == {"c": 3} and s["ddgan.outer"]["counters"] == {}
    assert s["ddgan.inner"]["parents"] == {"ddgan.outer": 1}


def test_outputs_are_the_same_bit_for_bit_with_tracing_on_and_off(runs):
    assert runs["summary"]
    off, on = runs["off"], runs["on"]
    for key in off:
        assert len(off[key]) == len(on[key]), key
        assert all(torch.equal(a, b) for a, b in zip(off[key], on[key])), key


def test_lines_give_calls_and_times_per_unit_and_reset_clears():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            with trace.span("ddgan.a"):
                trace.count("n", 2)
    (line,) = trace.lines(2)
    assert line.startswith("span ddgan.a: 2.00 calls, host ") and "device - ms a step" in line
    assert line.endswith("(in -); n 4")
    trace.reset()
    assert trace.summary() == {} and trace.lines(2) == []


# --------------------------------------------------------------------------
# G's output and input pyramids: their spans and counters
def _skip_net():
    """A tiny NCSN++ with both skip pyramids (three levels: 16², 8², 4²) and
    non-trivial weights, in eval mode."""
    from ddgan_torch.models import ncsnpp
    from ddgan_torch.utils import randomize_parameters_

    cfg = Config.from_dict(dict(
        image_size=16, num_channels=3, num_channels_dae=8, ch_mult=[1, 2, 2],
        num_res_blocks=1, attn_resolutions=[8], nz=4, z_emb_dim=8, n_mlp=1, dropout=0.0,
        progressive="output_skip", progressive_input="input_skip", progressive_combine="sum"))
    net = randomize_parameters_(models.NCSNpp.from_config(cfg), 2).eval()
    g = torch.Generator().manual_seed(3)
    inputs = (torch.randn(2, 3, 16, 16, generator=g), torch.tensor([0, 1]),
              torch.randn(2, 4, generator=g))
    ncsnpp.reset_skip_counts()
    return net, inputs


class _FakeGraph:
    """Stands in for `torch.cuda.CUDAGraph` on the CPU: its capture runs the
    forward eagerly, its replay runs nothing."""

    def replay(self):
        pass


def test_pyramid_outputs_spans_and_counters_with_tracing_on_and_off():
    from ddgan_torch.models import ncsnpp

    net, inputs = _skip_net()
    with torch.no_grad():
        off = net(*inputs)
        assert trace.summary() == {} and ncsnpp.SKIP_STEPS == {"skip_out": 3, "skip_in": 2}
        with profile(activities=[ProfilerActivity.CPU]):
            on = net(*inputs)
    assert float(off.std()) > 0.05 and torch.equal(off, on)
    assert ncsnpp.SKIP_STEPS == {"skip_out": 6, "skip_in": 4}
    s = trace.summary()
    # a step of the output pyramid at each level's way up, of the input
    # pyramid at each transition on the way down
    assert s["ddgan.G.skip_out"]["parents"] == {"ddgan.G.up16": 1, "ddgan.G.up8": 1,
                                                "ddgan.G.up4": 1}
    assert s["ddgan.G.skip_in"]["parents"] == {"ddgan.G.down16": 1, "ddgan.G.down8": 1}
    assert s["ddgan.G.skip_out"]["counters"] == {"ncsnpp.skip_out": 3,
                                                 "fir2x.up2x.forward": 2}
    assert s["ddgan.G.skip_in"]["counters"] == {"ncsnpp.skip_in": 2,
                                                "fir2x.down2x.forward": 2}


def test_pyramid_counters_are_taken_out_of_a_capture_and_added_at_each_replay(monkeypatch):
    import contextlib

    from ddgan_torch.diffusion import graphed
    from ddgan_torch.models import ncsnpp

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    net, inputs = _skip_net()
    g = graphed.GraphedForward(net)
    with torch.no_grad():
        captured = g._capture(*inputs)
        assert ncsnpp.SKIP_STEPS == {"skip_out": 0, "skip_in": 0}
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                with trace.span("ddgan.sample.G"):
                    g._replay(captured, *inputs)
    assert ncsnpp.SKIP_STEPS == {"skip_out": 6, "skip_in": 4}
    s = trace.summary()
    assert {k: v for k, v in s["ddgan.sample.G"]["counters"].items()
            if k.startswith("ncsnpp.")} == {"ncsnpp.skip_out": 6, "ncsnpp.skip_in": 4}
    assert "ddgan.G.skip_out" not in s  # a replay runs no Python of G


def test_registered_tallies_are_taken_out_of_a_capture_and_added_at_each_replay(monkeypatch):
    """A tally that a module hands in by `register_tallies` is counted as
    the hand kernels' are: nothing at the capture, each forward's steps
    and span counter at every replay."""
    import contextlib

    from ddgan_torch.diffusion import graphed

    steps = {"step": 0}

    class Counting(torch.nn.Module):
        def forward(self, x, t, z):
            steps["step"] += 2
            trace.count("test.step", 2)
            return x + 1

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(graphed, "_SOURCES", list(graphed._SOURCES))
    graphed.register_tallies(lambda: [(steps, "step", "test.step")])
    g = graphed.GraphedForward(Counting().eval())
    inputs = (torch.zeros(2, 3), torch.tensor([0, 1]), torch.zeros(2, 4))
    with torch.no_grad():
        captured = g._capture(*inputs)
        assert captured.tallies == ((len(graphed._tallies()) - 1, 2),) and steps["step"] == 0
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("ddgan.sample.G"):
                for _ in range(3):
                    g._replay(captured, *inputs)
    assert steps["step"] == 6
    assert trace.summary()["ddgan.sample.G"]["counters"]["test.step"] == 6


def test_graphed_forward_imports_no_model():
    """The sampler's graph wrapper takes any `GeneratorFn`: models hand it
    their tallies, it imports none of them."""
    import subprocess
    import sys

    code = ("import sys, ddgan_torch.diffusion.graphed; "
            "print(sorted(m for m in sys.modules if m.startswith('ddgan_torch.models')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=Path(__file__).resolve().parent.parent)
    assert out.stdout.strip() == "[]"


def test_generators_without_skip_pyramids_record_no_pyramid_spans():
    from ddgan_torch.models import ncsnpp

    residual = Config.from_dict({**CFG.to_dict(), "progressive": "residual"})
    for cfg in (CFG, residual):
        net = models.NCSNpp.from_config(cfg).eval()
        ncsnpp.reset_skip_counts()
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
            net(torch.randn(2, 3, 16, 16), torch.tensor([0, 1]), torch.randn(2, CFG.nz))
        s = trace.summary()
        assert not {"ddgan.G.skip_out", "ddgan.G.skip_in"} & set(s)
        assert ncsnpp.SKIP_STEPS == {"skip_out": 0, "skip_in": 0}
        trace.reset()
