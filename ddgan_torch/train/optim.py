"""Optimizers with the reference's torch Adam semantics, as the JAX package
builds them with optax (`ddgan_tpu/train/optim.py`).

Reference (ddgan.py:297-313): Adam(lr, betas=(beta1, beta2), weight_decay)
per network, with torch-style L2 weight decay (wd * p added to the
gradient before the Adam moments, not decoupled AdamW), gradients clipped
by their global norm before the step (ddgan.py:484, 507), and a
per-epoch CosineAnnealingLR with eta_min 1e-5 (ddgan.py:312-313).

`ClippedAdam(params, ...)` is the optimizer of those parameters. The clip
follows optax's `clip_by_global_norm` (scale by max_norm / norm only when
norm >= max_norm, no epsilon in the denominator), not
`torch.nn.utils.clip_grad_norm_`.
The L2 term and the moments are `torch.optim.Adam`'s, whose update is
optax's `add_decayed_weights` then `scale_by_adam(eps=1e-8)` then -lr. The
learning rate is set at each step. Its state dict is the inner Adam's, so a
checkpoint holds the reference's optimizer state (`content.pth`).

With a process `group`, the gradients are meaned across its ranks before
the clip (`parallel.mean_across_ranks_`: one all-reduce of one flat float32
buffer), as the JAX step `pmean`s them before `tx.update`
(`ddgan_tpu/train/step.py:282-283`, `:307-308`), so every rank applies the
same update to its replica. `train/zero1.py` is the same optimizer with the
moments sharded over the ranks.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch

from ..parallel.mesh import mean_across_ranks_


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by max_norm / ‖grads‖ when ‖grads‖ ≥ max_norm
    (optax `clip_by_global_norm`); returns the norm. No host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    # max_norm / norm clamped at 1: exactly 1 below the threshold (and at a
    # zero norm); NaN stays NaN, as optax's branch does
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))
    return norm


class ClippedAdam:
    """Clip → L2-into-grad → Adam(eps=1e-8) → -lr over `params`. `step(lr)`
    reads each parameter's `.grad` (a parameter without one gets zeros, as
    optax sees a zero cotangent), means it across the ranks of `group` when
    one is given, clips, and applies one Adam update at `lr`."""

    def __init__(self, params: Iterable[torch.nn.Parameter], beta1: float, beta2: float,
                 weight_decay: float = 0.0, grad_clip_norm: float | None = 1.0, group=None):
        self.params = list(params)
        self.grad_clip_norm = grad_clip_norm
        self.group = group
        self.adam = torch.optim.Adam(
            self.params, lr=0.0, betas=(beta1, beta2), eps=1e-8, weight_decay=weight_decay,
        )

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self, lr: float) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.group is not None:
            mean_across_ranks_([p.grad for p in self.params], self.group)
        if self.grad_clip_norm is not None and self.grad_clip_norm > 0:
            clip_by_global_norm_([p.grad for p in self.params], self.grad_clip_norm)
        self.adam.param_groups[0]["lr"] = float(lr)
        self.adam.step()

    def state_dict(self) -> dict:
        """The inner `torch.optim.Adam`'s state dict (the reference's format)."""
        return self.adam.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        self.adam.load_state_dict(state_dict)


def cosine_lr(base_lr: float, epoch: int, num_epoch: int, eta_min: float = 1e-5) -> float:
    """torch CosineAnnealingLR stepped once per epoch. (ddgan.py:312-313, :524-526)

    num_epoch <= 0 returns base_lr: T_max = 0 would divide by zero."""
    if num_epoch <= 0:
        return float(base_lr)
    t = min(float(epoch), float(num_epoch))
    return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * t / num_epoch))
