"""Train state: what the reference's content.pth checkpoints (ddgan.py:545-561)
— G and D with their parameters, both optimizers, the EMA shadow, and the
step and epoch counters. Counterpart of `ddgan_tpu/train/state.py`.
"""

from __future__ import annotations

import dataclasses

import torch

from .ema import ema_init
from .optim import ClippedAdam
from .zero1 import Zero1Adam


@dataclasses.dataclass
class TrainState:
    gen: torch.nn.Module
    disc: torch.nn.Module
    opt_G: ClippedAdam | Zero1Adam
    opt_D: ClippedAdam | Zero1Adam
    ema_G: dict[str, torch.Tensor] | None
    step: int = 0  # global step
    epoch: int = 0


def create_train_state(gen: torch.nn.Module, disc: torch.nn.Module,
                       opt_G: ClippedAdam | Zero1Adam, opt_D: ClippedAdam | Zero1Adam,
                       use_ema: bool = True) -> TrainState:
    """The state of G and D (already built, initialized and on their device)
    with their optimizers, and G's parameters copied as the EMA shadow."""
    return TrainState(
        gen=gen,
        disc=disc,
        opt_G=opt_G,
        opt_D=opt_D,
        ema_G=ema_init(gen) if use_ema else None,
    )
