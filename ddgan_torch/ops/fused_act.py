"""Fused bias-add and activation (linear, or a scaled LeakyReLU), NCHW.

Counterpart of `ddgan_tpu/ops/fused_act.py` (reference:
score_sde/op/fused_act.py and the act switch of
fused_bias_act_kernel.cu:20-51). The JAX package computes both modes as
plain expressions that XLA fuses, with no Pallas kernel, and autodiff
takes the place of the reference's grad and grad2 entries; here they are
plain PyTorch expressions, differentiable to any order. The reference
models do not call them; they are library ops.

Layout: the bias is per channel, dim 1 (the JAX package's is the last
axis, NHWC).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _add_bias(x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    if bias is None:
        return x
    return x + bias.reshape((1, -1) + (1,) * (x.ndim - 2))


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2, scale: float = math.sqrt(2.0)) -> torch.Tensor:
    return F.leaky_relu(_add_bias(x, bias), negative_slope) * scale


def fused_bias_act(x: torch.Tensor, bias: torch.Tensor | None = None, act: str = "lrelu",
                   alpha: float = 0.2, scale: float | None = None) -> torch.Tensor:
    """act "linear": (x + b) * scale, scale 1 by default; act "lrelu":
    leaky_relu(x + b, alpha) * scale, scale sqrt(2) by default (the
    kernel's defaults for each mode)."""
    if scale is None:
        scale = 1.0 if act == "linear" else math.sqrt(2.0)
    if act == "linear":
        return _add_bias(x, bias) * scale
    if act == "lrelu":
        return fused_leaky_relu(x, bias, alpha, scale)
    raise ValueError(f"unknown act {act!r}; expected 'linear' or 'lrelu'")
