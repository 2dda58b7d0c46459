"""The `sample_skip` mix and its readers: the work of a 1024² sampler call
counted on the meta device from `reference/nets_skip.py`; a run, the faults
and the float8 control at a tiny size on the CPU; the readings of a program
without a window (`calibrate.py`'s); and `skip_ms` / `hires_ms` on made-up
profiler events of an eager forward."""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.metrics import hires_ms, skip_ms
from benchmark.mixes import Reading
from benchmark.trace import summarize
from conftest import ROOT, tiny_cell
from test_bench_faults import SEEDS

CELL = "ffhq1024.sample"
SEED = 2**31 + 123


def _cfg():
    return json.loads((ROOT / "benchmark" / "configs" / "ffhq1024.json").read_text())["config"]


def test_work_of_a_1024_call():
    from benchmark.mixes import sample_skip

    cfg = _cfg()
    work = sample_skip.call_work(cfg, 8)
    T = cfg["num_timesteps"]
    assert work.flops > 0 and work.fir_bound_s > 0 and work.pair_conv_bound_s > 0
    # a forward: 7 down and 7 up BigGAN resblocks resample h and the skip
    # (28), and each pyramid one step a transition (7 + 7)
    none = {"backward": 0, "second_order": 0}
    assert work.fir_roles == {"down2x": {"forward": 21 * T, **none},
                              "up2x": {"forward": 21 * T, **none}}
    assert work.pair_conv_roles == {"forward": 9 * T, "dx": 0, "dx_library": 0}


def test_gated_convs_of_a_1024_forward_lie_at_512_256_and_128():
    from benchmark.reference import nets_skip
    from benchmark.reference.ops import Ops
    from benchmark.work.kernels import WorkRecorder, gated

    cfg = _cfg()
    rec = WorkRecorder()
    meta = torch.device("meta")
    with meta:
        G = nets_skip.Generator(cfg).eval()
    x = torch.empty(2, 3, 1024, 1024, device=meta)
    G(Ops(recorder=rec), x, torch.zeros(2, dtype=torch.int64, device=meta),
      torch.empty(2, cfg["nz"], device=meta))
    sides: dict = {}
    for x_shape, w_shape, _ in rec.conv_calls:
        if gated(x_shape, w_shape):
            sides[(x_shape[2], x_shape[1])] = sides.get((x_shape[2], x_shape[1]), 0) + 1
    # (side, C_in): 64 -> 64 at 512² in the up block from 256²; at 256² the
    # level's first conv (C_in 32), the up path's last concat (96) and three
    # at 64; two at 128² with C_in 64
    assert sides == {(512, 64): 2, (256, 32): 1, (256, 96): 1, (256, 64): 3, (128, 64): 2}


def _run(cell, fault=None):
    from benchmark import harness

    if fault is None:
        return harness.run(cell, SEED, 0.3, False, "cpu", time.perf_counter())
    with fault():
        return harness.run(cell, SEED, 0.3, False, "cpu", time.perf_counter())


def test_a_float32_run_agrees_with_the_reference():
    from benchmark import harness

    out = _run(tiny_cell(CELL, compute_dtype="float32"))
    assert out["attempted"] > 0 and harness.verdict(out["checks"])
    assert out["checks"]["image"]["value"] < 1e-4, out["checks"]


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_a_fault_comes_out_not_correct(fault):
    from benchmark import faults, harness

    out = _run(tiny_cell(CELL, compute_dtype="float32"), faults.SAMPLE[fault])
    assert not harness.verdict(out["checks"]), out["checks"]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_the_cell(seed):
    """As `test_bench_faults.py`'s control tests, on their seeds, over a
    check's calls: the reference in float8 as the program's images reads
    1, above the limit; each call's float8 gap is far above float32's."""
    from benchmark.mixes import sample_skip
    from benchmark.weights import generator

    cell = tiny_cell(CELL)
    states = [generator(seed, f"call{k}", "cpu").get_state()
              for k in range(cell.traffic["check_calls"])]
    ctl = sample_skip.reference_images(cell, seed, "cpu", states, precision="fp8")
    ref = sample_skip.reference_images(cell, seed, "cpu", states)
    assert min(sample_skip.image_gap([c], [r]) for c, r in zip(ctl, ref)) > 1e-3
    value = sample_skip.check(cell, seed, "cpu", {"calls": list(zip(states, ctl))})["image"]
    assert value["value"] == 1.0 > value["limit"], value


def test_the_control_ratio_takes_the_worst_call():
    from benchmark.mixes import sample_skip

    ref = [torch.ones(2, 3, 4, 4, dtype=torch.float64)] * 2
    ctl = [r * 1.1 for r in ref]  # a gap of 0.1 a call
    prog = [ref[0] * 1.01, ref[1] * 1.04]
    assert sample_skip.control_ratio(prog, ctl, ref) == pytest.approx(0.4)
    assert sample_skip.control_ratio([prog[0], prog[1][:1]], ctl, ref) == float("inf")
    assert sample_skip.control_ratio(prog, ref, ref) == float("inf")


def test_a_program_without_a_window_makes_its_own_check_calls():
    from benchmark import harness

    cell = tiny_cell(CELL, compute_dtype="float32")
    mix = harness.mix_module(cell)
    program = mix.Program(cell, SEED, "cpu")
    readings = program.readings()
    assert len(readings["calls"]) == cell.traffic["check_calls"]
    assert readings["picked"] == list(range(cell.traffic["check_calls"]))
    assert mix.check(cell, SEED, "cpu", readings)["image"]["value"] < 1e-4


def _event(name, device_us, device_type="DeviceType.CPU", is_async=False):
    return SimpleNamespace(name=name, device_time_total=device_us, device_type=device_type,
                           is_async=is_async)


@pytest.fixture
def eager_ms():
    """One eager forward's profiler events, read by `span_kernel_ms`: the
    whole forward 40 ms of kernels; eight pyramid steps out and seven in,
    1 ms each; four levels, 1 ms each; a device-side copy of an annotation
    and an async range, which are not read."""
    from benchmark.mixes import sample_skip

    names = (["ddgan.G.skip_out"] * 8 + ["ddgan.G.skip_in"] * 7
             + ["ddgan.G.down1024", "ddgan.G.up512", "ddgan.G.down256", "ddgan.G.up16"])
    events = [_event(sample_skip.WHOLE, 40e3), *(_event(n, 1e3) for n in names),
              _event("ddgan.G.skip_out", 5e3, device_type="DeviceType.CUDA"),
              _event("ddgan.G.skip_in", 5e3, is_async=True), _event("aten::conv2d", 7e3)]
    out = sample_skip.span_kernel_ms(events)
    assert out == {sample_skip.WHOLE: 40.0, "ddgan.G.skip_out": 8.0, "ddgan.G.skip_in": 7.0,
                   "ddgan.G.down1024": 1.0, "ddgan.G.up512": 1.0, "ddgan.G.down256": 1.0,
                   "ddgan.G.up16": 1.0}
    return out


def _reading(kind="sample", **window):
    return Reading(kind=kind, trace=summarize([], 1e-3, 5), rate=1.0, window=window,
                   work=None, flops_per_item=0.0)


def test_readers_scale_the_eager_forward_to_a_call(eager_ms):
    r = _reading(eager_forwards=1, forwards_per_call=2, eager_ms=eager_ms)
    assert skip_ms.read(r, "sample") == 30.0  # 15 steps of 1 ms, T = 2
    assert hires_ms.read(r, "sample") == 4.0  # down1024 and up512, T = 2
    r = _reading(eager_forwards=2, forwards_per_call=2, eager_ms=eager_ms)
    assert skip_ms.read(r, "sample") == 15.0


def test_readers_find_nothing_outside_a_sample_skip_trace(eager_ms):
    # the `sample` mix's reading has no eager forward; a train reading
    for r, suffix in ((_reading(), "sample"),
                      (_reading("train", eager_forwards=1, forwards_per_call=2,
                                eager_ms=eager_ms), "train")):
        assert skip_ms.read(r, suffix) is None and hires_ms.read(r, suffix) is None
    # a program without the pyramids' spans (the parent of the pyramids'
    # spans): the levels are read, the pyramids are not
    levels = {k: v for k, v in eager_ms.items() if "skip" not in k}
    r = _reading(eager_forwards=1, forwards_per_call=2, eager_ms=levels)
    assert skip_ms.read(r, "sample") is None and hires_ms.read(r, "sample") == 4.0
    r = _reading(eager_forwards=1, forwards_per_call=2, eager_ms={})
    assert skip_ms.read(r, "sample") is None and hires_ms.read(r, "sample") is None
