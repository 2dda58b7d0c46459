"""The `sample` mix: a closed loop of the port's sampler calls.

Set-up builds G (`ddgan_torch.models.NCSNpp`, eval mode, the configuration's
compute dtype) with weights from the seed, and the sampler of
`ddgan_torch.cli.test_cli.make_sampler`, which calls
`ddgan_torch.diffusion.sample_from_model`: x_T, then T steps of G and the
posterior, every draw from the run's generator. One call, which warms up
every shape, ends set-up. In the window one call is in flight at a time;
a call is one request for a batch of `batch` images and ends when its
images are in host memory. Its latency is taken on the host clock from the
call to the end of the copy.

The check draws `check_calls` of the window's calls from the seed and runs
the plain reference from each one's generator state; each image is held
to the reference's by its relative error.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from .. import trace as bench_trace
from ..weights import fill_weights, generator, sub_seed
from . import Reading, build_kernels, port_config


class Program:
    def __init__(self, cell, seed: int, device: str):
        from ddgan_torch.cli import test_cli
        from ddgan_torch.models import NCSNpp

        t0 = time.perf_counter()
        cfg = port_config(cell)
        if torch.device(device).type == "cuda":
            build_kernels(cfg)
        self.setup_parts = {"kernels_s": time.perf_counter() - t0}
        self.cell, self.seed, self.device, self.batch = cell, seed, device, cell.batch
        with torch.device(device):
            net = NCSNpp.from_config(cfg)
        fill_weights(net, seed, "G")
        net.eval()
        self.net = net
        self.rng = generator(seed, "sample", device)
        self.sample = test_cli.make_sampler(cfg, net, self.batch, torch.device(device), self.rng)
        self.setup_parts["build_s"] = time.perf_counter() - t0 - self.setup_parts["kernels_s"]
        t1 = time.perf_counter()
        self.sample().cpu()
        self.setup_parts["first_call_s"] = time.perf_counter() - t1
        self.calls: list = []  # (generator state, host images) of each window call
        self.attempted = 0

    def _call(self):
        state = self.rng.get_state()
        t0 = time.perf_counter()
        images = self.sample().cpu()
        return state, images, time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        cuda = torch.device(self.device).type == "cuda"
        self.setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            state, images, dt = self._call()
            self.calls.append((state, images))
            lat.append(dt)
        elapsed = time.perf_counter() - t0
        self.attempted = len(lat)
        self.rate = len(lat) * self.batch / elapsed
        self.window_info = {"peak_bytes": torch.cuda.max_memory_allocated()} if cuda else {}
        return {"sample_images_per_s": self.rate,
                "sample_ms_p90": 1e3 * p90(lat)}

    def trace(self) -> Reading:
        from ddgan_torch.ops import fir2x

        from ..work import flops

        n = int(self.cell.traffic["traced_calls"])

        def calls():
            for _ in range(n):
                with torch.profiler.record_function("bench.sample_call"):
                    self.sample().cpu()

        before = sum(fir2x.LAUNCHES.values())
        summary = bench_trace.profile(calls, n)
        bench_trace.check_launches("fir2x", sum(fir2x.LAUNCHES.values()) - before, summary)
        one = flops.sample_call_work(self.cell.cfg, self.batch)
        work = flops.UnitWork(n * one.flops, n * one.fir_bound_s, n * one.pair_conv_bound_s,
                              one.fir_roles, one.pair_conv_roles)
        return Reading(kind="sample", trace=summary, rate=self.rate, window=self.window_info,
                       work=work, flops_per_item=one.flops / self.batch)

    def readings(self) -> dict:
        k = min(int(self.cell.traffic["check_calls"]), len(self.calls))
        pick = sorted(random.Random(sub_seed(self.seed, "check")).sample(
            range(len(self.calls)), k))
        return {"calls": [self.calls[i] for i in pick], "picked": pick}

    def peak_bytes(self) -> int:
        return max(self.setup_peak, torch.cuda.max_memory_allocated())

    def close(self) -> None:
        self.net = self.sample = None


def p90(values: list) -> float:
    """The 90th percentile (`statistics.quantiles`, inclusive method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def reference_images(cell, seed: int, device: str, states: list,
                     precision: str | None = None) -> list:
    """The plain reference's images of the calls that began at generator
    states `states`, from the seed's weights."""
    from ..reference import diffusion, nets, ops

    ops.strict_float32()
    c = cell.cfg
    with torch.device(device):
        G = nets.Generator(c)
    fill_weights(G, seed, "G")
    G.eval()
    sched = diffusion.Schedule(c["num_timesteps"], c["beta_min"], c["beta_max"], device)
    shape = (cell.batch, c["num_channels"], c["image_size"], c["image_size"])
    out = []
    for state in states:
        g = torch.Generator(device=device)
        g.set_state(state)
        out.append(diffusion.sample(sched, G, ops.Ops(precision=precision), shape, c["nz"],
                                    g).cpu())
    return out


def image_gap(prog: list, ref: list) -> float:
    """The worst call's ||prog - ref|| / ||ref|| over all its images. (The
    worst single image's gap swings with the tail of ~1,000 images a run
    and does not part the bfloat16 program from the float8 control.)"""
    worst = 0.0
    for p, r in zip(prog, ref, strict=True):
        if p.shape != r.shape:
            return float("inf")
        worst = max(worst, float((p.double() - r.double()).norm() / r.double().norm()))
    return worst


def check(cell, seed: int, device: str, readings: dict) -> dict:
    states = [s for s, _ in readings["calls"]]
    ref = reference_images(cell, seed, device, states)
    value = image_gap([im for _, im in readings["calls"]], ref)
    return {"image": {"value": value, "limit": cell.limits["image"]}}
