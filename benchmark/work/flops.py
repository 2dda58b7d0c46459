"""Model FLOPs and kernel work of a cell's unit of work, counted by running
the plain reference on the meta device.

The formulas of `torch.utils.flop_counter` count the matmuls and dense
convolutions (forward and backward, R1's grad-of-grad included); the
depthwise convolutions through which the reference computes its FIR
resamples are left out, as they are not model FLOPs and run outside the
tensor cores. A train step is counted as the reference runs it: R1 from
the same D(x_t) forward that gives D's loss on real data, so D(x_t) is
counted once even where the program recomputes it. The per-sample figure
averages one `lazy_reg` period (one R1 step and lazy_reg - 1 others).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from ..reference import diffusion, nets, ops, train
from .kernels import WorkRecorder

aten = torch.ops.aten


def _conv(x_shape, w_shape, bias, stride, padding, dilation, transposed, output_padding,
          groups, *args, out_shape=None, **kwargs):
    if groups != 1:
        return 0
    return flop_counter.conv_flop.__wrapped__(x_shape, w_shape, bias, stride, padding,
                                              dilation, transposed, out_shape=out_shape)


def _conv_bwd(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
              output_padding, groups, output_mask, out_shape, **kwargs):
    if groups != 1:
        return 0
    return flop_counter.conv_backward_flop.__wrapped__(
        grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
        output_padding, groups, output_mask, out_shape)


REGISTRY = {**flop_counter.flop_registry,
            **{op: flop_counter.shape_wrapper(f) for op, f in (
                (aten.convolution, _conv), (aten._convolution, _conv),
                (aten.convolution_backward, _conv_bwd))}}


class FlopCount(TorchDispatchMode):
    """Sums the FLOPs of every op with a formula in `REGISTRY` (no module
    hooks, so autograd.grad with create_graph runs under it)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = REGISTRY.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


@dataclasses.dataclass
class UnitWork:
    """The work of one unit (a train step or a sampler call)."""

    flops: float
    fir_bound_s: float
    pair_conv_bound_s: float
    fir_roles: dict
    pair_conv_roles: dict


def _count(fn) -> UnitWork:
    rec = WorkRecorder()
    with FlopCount() as counter:
        bf16 = fn(rec)
    return UnitWork(float(counter.total), rec.fir_bound_s(), rec.pair_conv_bound_s(bf16),
                    rec.fir_roles(), rec.pair_conv_roles(bf16))


def _bf16(cfg: dict) -> bool:
    return str(cfg.get("compute_dtype", "float32")) in ("bfloat16", "bf16")


def train_step_work(cfg: dict, batch: int, r1: bool) -> UnitWork:
    """One train step of batch `batch`, with R1 or without."""

    def run(rec):
        dev = torch.device("meta")
        with dev:
            G, D = nets.Generator(cfg), nets.Discriminator(cfg)
        o = ops.Ops(recorder=rec)
        sched = diffusion.Schedule(cfg["num_timesteps"], cfg["beta_min"], cfg["beta_max"], dev)
        step = train.TrainStep(
            G, D, train.Adam(G.parameters(), 0.5, 0.9, 0.0, 1.0),
            train.Adam(D.parameters(), 0.5, 0.9, 0.0, 1.0),
            [p.detach().clone() for p in G.parameters()], sched, o, nz=cfg["nz"],
            r1_gamma=cfg["r1_gamma"], lazy_reg=1 if r1 else None, ema_decay=0.5)
        if not r1:
            step.lazy_reg, step.step_count = 2, 1
        shape = (batch, cfg["num_channels"], cfg["image_size"], cfg["image_size"])
        step(torch.empty(shape, device=dev), None, 1e-4, 1e-4)
        return _bf16(cfg)

    return _count(run)


def sample_call_work(cfg: dict, batch: int) -> UnitWork:
    """One sampler call of batch `batch` (T generator forwards)."""

    def run(rec):
        dev = torch.device("meta")
        with dev:
            G = nets.Generator(cfg).eval()
        sched = diffusion.Schedule(cfg["num_timesteps"], cfg["beta_min"], cfg["beta_max"], dev)
        shape = (batch, cfg["num_channels"], cfg["image_size"], cfg["image_size"])
        diffusion.sample(sched, G, ops.Ops(recorder=rec), shape, cfg["nz"], None)
        return _bf16(cfg)

    return _count(run)


def period_work(cfg: dict, batch: int) -> UnitWork:
    """One lazy_reg period of train steps: an R1 step and lazy_reg - 1 others."""
    lazy = int(cfg["lazy_reg"])
    a, b = train_step_work(cfg, batch, True), train_step_work(cfg, batch, False)
    roles = {k: {r: a.fir_roles[k][r] + (lazy - 1) * b.fir_roles[k][r] for r in a.fir_roles[k]}
             for k in a.fir_roles}
    pair = {r: a.pair_conv_roles[r] + (lazy - 1) * b.pair_conv_roles[r] for r in a.pair_conv_roles}
    return UnitWork(a.flops + (lazy - 1) * b.flops, a.fir_bound_s + (lazy - 1) * b.fir_bound_s,
                    a.pair_conv_bound_s + (lazy - 1) * b.pair_conv_bound_s, roles, pair)
