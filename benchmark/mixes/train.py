"""The `train` mix: a closed loop of the port's bf16 train steps.

Set-up builds one train state (`ddgan_torch.train.create_train_state` with
`ClippedAdam` for G and D and G's EMA) and the step of
`ddgan_torch.train.make_train_step`, with weights from the seed
(`benchmark/weights.py`) and a pool of `pool_batches` real batches
resident on the device (the data layer is bypassed). It drives the step
through its first three steps (an R1 step, then two others) on pool
batches that all differ, through the window's own call; those steps warm
up every shape the window uses and give what the check compares: each
step's losses, the norm of each leaf's first gradient as the optimizer got
it (worked out from Adam's first moment after the first step), and the norm
of each leaf's change and of the EMA's after the three. The step counter
is then set to the next multiple of `lazy_reg`, so the window starts at an
R1 step.

The window is whole `lazy_reg` periods, as many as the first steps' times
say fit the run's seconds; steps are dispatched back to back with the
recipe's constant learning rates, and the rate is every sample of the
window over its time, ended by a synchronize. CUDA events around each R1
step give `r1_step_ms`. A traced run profiles one more period.
"""

from __future__ import annotations

import math
import time

import torch

from .. import trace as bench_trace
from ..weights import disc_scale, fill_weights, generator, real_pool
from . import Reading, build_kernels, leaf_gaps, median, port_config

FIRST_STEPS = 3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _named_norms(named, fn) -> dict:
    """{name: ||fn(name, tensor)||} over `named`, one host read."""
    names = [k for k, _ in named]
    norms = torch.stack([torch.linalg.vector_norm(fn(k, t).double()) for k, t in named])
    return dict(zip(names, norms.tolist()))


class Program:
    def __init__(self, cell, seed: int, device: str):
        from ddgan_torch import models
        from ddgan_torch import train as port
        from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients

        t0 = time.perf_counter()
        cfg = port_config(cell)
        if torch.device(device).type == "cuda":
            build_kernels(cfg)
        self.setup_parts = {"kernels_s": time.perf_counter() - t0}
        self.cell, self.device = cell, device
        self.batch, self.lazy = cell.batch, int(cfg.lazy_reg)
        self.lr_g, self.lr_d = float(cfg.lr_g), float(cfg.lr_d)
        shape = (self.batch, cfg.num_channels, cfg.image_size, cfg.image_size)
        with torch.device(device):
            gen = models.NCSNpp.from_config(cfg)
            disc = models.build_discriminator(cfg)
        fill_weights(gen, seed, "G")
        fill_weights(disc, seed, "D", disc_scale(cell.cfg))
        opt_g = port.ClippedAdam(gen.parameters(), cfg.beta1_g, cfg.beta2_g, cfg.weight_decay_G,
                                 cfg.grad_clip_norm)
        opt_d = port.ClippedAdam(disc.parameters(), cfg.beta1_d, cfg.beta2_d,
                                 cfg.weight_decay_D, cfg.grad_clip_norm)
        self.state = port.create_train_state(gen, disc, opt_g, opt_d, use_ema=True)
        coeff = DiffusionCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                             cfg.use_geometric, device=device)
        pos = PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                           cfg.use_geometric, device=device)
        self.step = port.make_train_step(
            coeff, pos, num_timesteps=cfg.num_timesteps, nz=cfg.nz, r1_gamma=cfg.r1_gamma,
            lazy_reg=self.lazy, ema_decay=cfg.ema_decay, use_ema=True, r1_shared=cfg.r1_shared)
        self.pool = real_pool(seed, int(cell.traffic["pool_batches"]), shape, device)
        self.rng = generator(seed, "steps", device)
        self.k = 0  # steps taken
        self.attempted = 0
        _sync(device)
        self.setup_parts["build_s"] = time.perf_counter() - t0 - self.setup_parts["kernels_s"]
        self._first_steps()
        self.setup_parts["first_steps_s"] = self.times

    def _call(self) -> None:
        self.step(self.state, self.pool[self.k % len(self.pool)], self.rng, self.lr_g, self.lr_d)
        self.k += 1

    def _first_steps(self) -> None:
        st = self.state
        named = {"G": list(st.gen.named_parameters()), "D": list(st.disc.named_parameters())}
        p0 = {net: {k: p.detach().clone() for k, p in ps} for net, ps in named.items()}
        losses, times, grads = [], [], {}
        for i in range(FIRST_STEPS):
            _sync(self.device)
            t0 = time.perf_counter()
            m = self.step(st, self.pool[self.k % len(self.pool)], self.rng, self.lr_g, self.lr_d)
            self.k += 1
            losses.append(torch.stack([m.errD, m.errG]))
            if i == 0:
                for net, opt in (("G", st.opt_G), ("D", st.opt_D)):
                    b1 = opt.adam.param_groups[0]["betas"][0]
                    grads[net] = _named_norms(named[net], lambda k, p, o=opt, b=b1: o.adam.state[
                        p].get("exp_avg", torch.zeros_like(p)) / (1 - b))
            _sync(self.device)
            times.append(time.perf_counter() - t0)
        with torch.no_grad():
            change = {net: _named_norms(ps, lambda k, p, n=net: p - p0[n][k])
                      for net, ps in named.items()}
            ema = _named_norms([(k, st.ema_G[k]) for k, _ in named["G"]],
                               lambda k, e: e - p0["G"][k])
        self._readings = {"losses": torch.stack(losses).tolist(), "grad": grads,
                          "change": change, "ema": ema}
        self.times = times
        self.t_r1, self.t_plain = times[0], sum(times[1:]) / (FIRST_STEPS - 1)
        st.step = -(-st.step // self.lazy) * self.lazy  # the next R1 step

    def window(self, seconds: float) -> dict:
        cuda = torch.device(self.device).type == "cuda"
        _sync(self.device)
        self.setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        period = self.t_r1 + (self.lazy - 1) * self.t_plain
        n = max(1, math.floor(seconds / period + 0.5)) * self.lazy
        spans = []
        t0 = time.perf_counter()
        for _ in range(n):
            if cuda and self.state.step % self.lazy == 0:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                self._call()
                b.record()
                spans.append((a, b))
            else:
                self._call()
        _sync(self.device)
        dt = time.perf_counter() - t0
        self.attempted = n
        self.rate = n * self.batch / dt
        self.window_info = {}
        if cuda:
            self.window_info["r1_ms"] = [a.elapsed_time(b) for a, b in spans]
            self.window_info["peak_bytes"] = torch.cuda.max_memory_allocated()
        return {"train_samples_per_s": self.rate}

    def trace(self) -> Reading:
        from ddgan_torch.ops import fir2x

        from ..work import flops

        def period():
            for _ in range(self.lazy):
                with torch.profiler.record_function("bench.train_step"):
                    self._call()

        before = sum(fir2x.LAUNCHES.values())
        summary = bench_trace.profile(period, self.lazy)
        bench_trace.check_launches("fir2x", sum(fir2x.LAUNCHES.values()) - before, summary)
        work = flops.period_work(self.cell.cfg, self.batch)
        return Reading(kind="train", trace=summary, rate=self.rate, window=self.window_info,
                       work=work, flops_per_item=work.flops / (self.lazy * self.batch))

    def readings(self) -> dict:
        return self._readings

    def peak_bytes(self) -> int:
        """The device memory peak of set-up, window and trace."""
        return max(self.setup_peak, torch.cuda.max_memory_allocated())

    def close(self) -> None:
        self.state = self.step = self.pool = None


def reference_readings(cell, seed: int, device: str, precision: str | None = None) -> dict:
    """The plain reference's first three steps from the seed's weights,
    pool and draws: the readings `Program` takes, in float32 (TF32 off) or,
    with `precision` "fp8", with every conv and linear map in float8 (`Ops`)."""
    from ..reference import diffusion, nets, ops, train

    ops.strict_float32()
    c = cell.cfg
    with torch.device(device):
        G, D = nets.Generator(c), nets.Discriminator(c)
    fill_weights(G, seed, "G")
    fill_weights(D, seed, "D", disc_scale(c))
    named = {"G": list(G.named_parameters()), "D": list(D.named_parameters())}
    p0 = {net: {k: p.detach().clone() for k, p in ps} for net, ps in named.items()}
    opt = {"G": train.Adam(G.parameters(), c["beta1_g"], c["beta2_g"], c["weight_decay_G"],
                           c["grad_clip_norm"]),
           "D": train.Adam(D.parameters(), c["beta1_d"], c["beta2_d"], c["weight_decay_D"],
                           c["grad_clip_norm"])}
    ema = [p.detach().clone() for p in G.parameters()]
    rng = generator(seed, "steps", device)
    shape = (cell.batch, c["num_channels"], c["image_size"], c["image_size"])
    pool = real_pool(seed, int(cell.traffic["pool_batches"]), shape, device)
    step = train.TrainStep(
        G, D, opt["G"], opt["D"], ema, diffusion.Schedule(c["num_timesteps"], c["beta_min"],
                                                          c["beta_max"], device),
        ops.Ops(precision=precision, generator=rng), nz=c["nz"], r1_gamma=c["r1_gamma"],
        lazy_reg=int(c["lazy_reg"]), ema_decay=c["ema_decay"],
        rows=cell.config.get("reference_rows"))
    losses, grads = [], {}
    for i in range(FIRST_STEPS):
        m = step(pool[i % len(pool)], rng, c["lr_g"], c["lr_d"])
        losses.append([float(m["errD"]), float(m["errG"])])
        if i == 0:
            for net in ("G", "D"):
                names = [k for k, _ in named[net]]
                grads[net] = dict(zip(names, train.leaf_norms(opt[net].last_grads)))
    with torch.no_grad():
        change = {net: {k: train.leaf_norms([p - p0[net][k]])[0] for k, p in ps}
                  for net, ps in named.items()}
        ema_n = {k: train.leaf_norms([e - p0["G"][k]])[0]
                 for (k, _), e in zip(named["G"], ema)}
    return {"losses": losses, "grad": grads, "change": change, "ema": ema_n}


# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone, and its change is not compared
MOVED = 1e-3


# the scale below which a loss's gap is taken against ln 2, the softplus
# loss at a logit of 0: a saturated discriminator's loss lies near 0, where
# a relative gap swings with the exponent of its logits
LOSS_FLOOR = math.log(2.0)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared:

      * loss: the worst gap of a step's losses, |p - r| over the larger of r
        and ln 2;
      * grad.<net>, change.<net>, ema: the worst leaf's gap (`leaf_gaps`) of
        the norms of the first gradient, of the change after three steps and
        of the EMA's change (G only); a leaf that did not move, or moved
        double, reads 1;
      * grad_median.<net>, change_median.<net>: the median leaf's gap, steady
        from seed to seed where the worst leaf's swings with the most
        sensitive leaf;
      * grad_agg.D: ||p - r|| / ||r|| over the vector of D's leaves' first
        gradient norms, dominated by the large leaves: the number that
        parts float8 from bfloat16 on every seed.

    Each network apart: D's first gradient is taken before any update,
    while G's passes through the D that the step's own Adam update has just
    moved, sign-like, so G's readings swing with the signs of D's smallest
    gradients whatever the precision (PERF.md, section 6)."""
    out = {"loss": max(abs(p - r) / max(abs(r), LOSS_FLOOR) for p, r in zip(
        sum(prog["losses"], []), sum(ref["losses"], []), strict=True))}
    for net in ("G", "D"):
        names = sorted(ref["grad"][net])
        r = [ref["grad"][net][k] for k in names]
        med = median(r)
        keep = [x >= MOVED * med for x in r]
        grad = leaf_gaps([prog["grad"][net][k] for k in names], r)
        change = leaf_gaps([prog["change"][net][k] for k in names],
                           [ref["change"][net][k] for k in names], keep)
        out.update({f"grad.{net}": max(grad), f"grad_median.{net}": median(grad),
                    f"change.{net}": max(change), f"change_median.{net}": median(change)})
        if net == "G":
            out["ema"] = max(leaf_gaps([prog["ema"][k] for k in names],
                                       [ref["ema"][k] for k in names], keep))
    names = sorted(ref["grad"]["D"])
    out["grad_agg.D"] = math.sqrt(
        sum((prog["grad"]["D"][k] - ref["grad"]["D"][k]) ** 2 for k in names)
        / sum(ref["grad"]["D"][k] ** 2 for k in names))
    return out


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The `n` leaves of each network with the widest gaps (`leaf_gaps`) of
    the first gradient's and the change's norms, as (name, program,
    reference)."""
    out = {}
    for key in ("grad", "change"):
        for net in ("G", "D"):
            names = sorted(ref[key][net])
            g = leaf_gaps([prog[key][net][k] for k in names], [ref[key][net][k] for k in names])
            rows = sorted(zip(g, names), reverse=True)[:n]
            out[f"{key}.{net}"] = [(k, prog[key][net][k], ref[key][net][k]) for _, k in rows]
    return out


def check(cell, seed: int, device: str, readings: dict) -> dict:
    ref = reference_readings(cell, seed, device)
    return {k: {"value": v, "limit": cell.limits[k]} for k, v in compare(readings, ref).items()}
