"""The `sample_skip` mix: the `sample` mix's closed loop of sampler calls,
for a generator with score_sde's output and input pyramids.

The program and the window are the `sample` mix's (`sample.Program`,
which calls `ddgan_torch.cli.test_cli.make_sampler`, so the faults of
`benchmark/faults.py` apply); the plain reference and the work counts come
from `benchmark/reference/nets_skip.py`, which has the pyramids that
`nets.Generator` refuses.

The check holds each checked call's gap to the float32 reference
(`image_gap`'s ||prog - ref|| / ||ref||) to the gap of the reference
computed in float8 (the control) at the same weights and draws: `image` is
the largest of those ratios over the calls. Weights drawn by the law give
this eight-level generator outputs whose size swings with the seed (an
output pyramid that sums eight heads cancels more on some draws), and the
gap of every precision swings with it, by ~35x over seeds; the ratio of
bfloat16's gap to float8's stays within ~2x. The control reads 1 by
construction.

The traced slice is the `sample` mix's: `traced_calls` calls, whose G
forwards replay a captured graph and so run no Python of G. After it, in a
profile of its own that no reading of the slice includes, one eager G
forward at the cell's batch (no graph, no sampler span around it, inside
the annotation `bench.eager_G`) records G's level and pyramid spans. Each
span is read as the device time of the kernels launched inside it (the
profiler's `device_time_total`), not as its device-stream interval: an
eager forward's stream idles while the host launches, a replay's does not,
so kernel time is what the forward costs in a replay too. `per_call_ms`
scales it to the T forwards of a call, and the whole forward's kernel time
(`bench.eager_G`) is the denominator that a span's share is taken of. The
`Reading` is of kind "sample", so the `sample` mix's readers read it.

`readings()` makes `check_calls` calls of its own where no window ran
(`benchmark/calibrate.py` reads a program without one).
"""

from __future__ import annotations

import time

import torch

from .. import trace as bench_trace
from ..weights import fill_weights, generator
from . import Reading, sample
from .sample import image_gap, p90  # noqa: F401  (what `sample` exposes)

# the eager G forwards of a traced run, in their own profile
EAGER_FORWARDS = 1
# the annotation around them, and the prefix of the port's spans read in them
WHOLE = "bench.eager_G"
PREFIX = "ddgan.G."


def call_work(cfg: dict, batch: int):
    """`flops.sample_call_work` with the pyramids' reference generator."""
    from ..reference import diffusion, nets_skip, ops
    from ..work import flops

    def run(rec):
        dev = torch.device("meta")
        with dev:
            G = nets_skip.Generator(cfg).eval()
        sched = diffusion.Schedule(cfg["num_timesteps"], cfg["beta_min"], cfg["beta_max"], dev)
        shape = (batch, cfg["num_channels"], cfg["image_size"], cfg["image_size"])
        diffusion.sample(sched, G, ops.Ops(recorder=rec), shape, cfg["nz"], None)
        return flops._bf16(cfg)

    return flops._count(run)


class Program(sample.Program):
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
        eager_ms = self._eager_profile()
        one = call_work(self.cell.cfg, self.batch)
        work = flops.UnitWork(n * one.flops, n * one.fir_bound_s, n * one.pair_conv_bound_s,
                              one.fir_roles, one.pair_conv_roles)
        window = {**self.window_info, "eager_forwards": EAGER_FORWARDS,
                  "forwards_per_call": int(self.cell.cfg["num_timesteps"]),
                  "eager_ms": eager_ms}
        return Reading(kind="sample", trace=summary, rate=self.rate, window=window, work=work,
                       flops_per_item=one.flops / self.batch)

    def _eager_profile(self) -> dict:
        """The kernel ms of the eager forwards, by span (`span_kernel_ms`);
        on standard error beside the device's busy time and the wall time,
        which hold the launch-bound idle that the kernel time leaves out."""
        import sys

        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function(WHOLE):
                self._eager_forwards()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        events = prof.events()
        out = span_kernel_ms(events)
        slice_ = bench_trace.summarize(bench_trace.events_of(prof), wall_s, EAGER_FORWARDS)
        print(f"eager G forward: {out.get(WHOLE, 0.0) / EAGER_FORWARDS!r} kernel ms "
              f"({1e3 * sum(slice_.class_s.values()) / EAGER_FORWARDS!r} of every kernel), "
              f"{1e3 * slice_.busy_s / EAGER_FORWARDS!r} busy, "
              f"{1e3 * wall_s / EAGER_FORWARDS!r} wall, a forward", file=sys.stderr)
        return out

    def _eager_forwards(self) -> None:
        """G's forward on the net itself, at the first step's t."""
        c = self.cell.cfg
        g = generator(self.seed, "eager", self.device)
        x = torch.randn((self.batch, c["num_channels"], c["image_size"], c["image_size"]),
                        generator=g, device=self.device)
        t = torch.full((self.batch,), c["num_timesteps"] - 1, dtype=torch.int64,
                       device=self.device)
        z = torch.randn((self.batch, c["nz"]), generator=g, device=self.device)
        with torch.no_grad():
            for _ in range(EAGER_FORWARDS):
                self.net(x, t, z)

    def readings(self) -> dict:
        for _ in range(int(self.cell.traffic["check_calls"]) - len(self.calls)):
            state, images, _ = self._call()
            self.calls.append((state, images))
        return super().readings()


def span_kernel_ms(events) -> dict:
    """{name: ms} of the device kernels launched inside the host ranges of
    `WHOLE` and of the port's `ddgan.G.*` spans, each range's children's
    included (`FunctionEvent.device_time_total`, in us), summed over the
    ranges of a name."""
    out: dict = {}
    for e in events:
        if (e.name == WHOLE or e.name.startswith(PREFIX)) and not e.is_async \
                and str(e.device_type).endswith("CPU"):
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total * 1e-3
    return out


def per_call_ms(ctx, names) -> float | None:
    """The kernel ms of the spans `names` in the eager forwards of a
    `sample_skip` trace, scaled to a sampler call's T forwards; None where
    there is nothing to read."""
    eager = ctx.window.get("eager_ms")
    if not eager:
        return None
    ms = [eager[n] for n in names if n in eager]
    if not ms:
        return None
    return sum(ms) / ctx.window["eager_forwards"] * ctx.window["forwards_per_call"]


def reference_images(cell, seed: int, device: str, states: list,
                     precision: str | None = None) -> list:
    """The plain reference's images of the calls that began at generator
    states `states`, from the seed's weights (`sample.reference_images`
    with `nets_skip.Generator`)."""
    from ..reference import diffusion, nets_skip, ops

    ops.strict_float32()
    c = cell.cfg
    with torch.device(device):
        G = nets_skip.Generator(c)
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


def control_ratio(prog: list, ctl: list, ref: list) -> float:
    """The largest over the calls of the program's gap to the reference
    over the float8 control's gap to it; inf where a call's images have
    another shape than the reference's."""
    worst = 0.0
    for p, c, r in zip(prog, ctl, ref, strict=True):
        if p.shape != r.shape:
            return float("inf")
        c_gap = image_gap([c], [r])
        worst = max(worst, image_gap([p], [r]) / c_gap if c_gap > 0 else float("inf"))
    return worst


def check(cell, seed: int, device: str, readings: dict) -> dict:
    states = [s for s, _ in readings["calls"]]
    ref = reference_images(cell, seed, device, states)
    ctl = reference_images(cell, seed, device, states, precision="fp8")
    value = control_ratio([im for _, im in readings["calls"]], ctl, ref)
    return {"image": {"value": value, "limit": cell.limits["image"]}}
