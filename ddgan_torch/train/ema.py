"""Exponential moving average of the generator's parameters.

Counterpart of `ddgan_tpu/train/ema.py` (reference ema.py:45-55):
ema = decay * ema + (1 - decay) * param, after every G step. The shadow is
a dict of tensors keyed like `named_parameters()`, so it loads into a
generator with `load_state_dict(..., strict=False)`.
"""

from __future__ import annotations

import torch

from ..trace import span


def ema_init(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A detached copy of the module's parameters. (ema.py:37-43)"""
    return {k: p.detach().clone() for k, p in module.named_parameters()}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], module: torch.nn.Module, decay: float) -> None:
    """One EMA step in place: decay * ema + (1 - decay) * param. (ema.py:45-55)"""
    with span("ddgan.ema", next(iter(ema.values())).device if ema else None):
        shadow = [ema[k] for k, _ in module.named_parameters()]
        params = [p for _, p in module.named_parameters()]
        torch._foreach_mul_(shadow, decay)
        torch._foreach_add_(shadow, params, alpha=1.0 - decay)
