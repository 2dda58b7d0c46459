"""StyleGAN2-style FIR resampling built on `upfirdn2d` (NCHW).

Counterpart of `ddgan_tpu/ops/resample.py` (reference semantics:
score_sde/models/up_or_down_sampling.py). `upsample_2d` / `downsample_2d`
send the 2x, 4-tap case on a CUDA tensor with even H and W to the
hand-written kernel (`fir2x.up2x` / `fir2x.down2x`); every other case, and
every CPU tensor, takes the plain path, which computes the same function.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import fir2x
from .upfirdn2d import upfirdn2d_ref


def _fir2x_ok(x: torch.Tensor, k1d: np.ndarray, factor: int) -> bool:
    """The kernel's domain (`_pallas_2x_ok` of the JAX package without its
    VMEM clause): a CUDA tensor, factor 2, 4 separable taps, even H and W."""
    return (
        x.device.type == "cuda"
        and factor == 2
        and k1d.ndim == 1
        and len(k1d) == 4
        and x.shape[2] % 2 == 0
        and x.shape[3] % 2 == 0
    )


def setup_kernel(k) -> np.ndarray:
    """Normalize a 1-D (separable) or 2-D FIR kernel to sum 1.

    Reference: up_or_down_sampling.py:186-193 `_setup_kernel`.
    """
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / np.sum(k)
    assert k.ndim == 2 and k.shape[0] == k.shape[1]
    return k


def naive_upsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample. Reference: up_or_down_sampling.py:64-68."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h, 1, w, 1).expand(n, c, h, factor, w, factor)
    return x.reshape(n, c, h * factor, w * factor)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Mean-pool downsample. Reference: up_or_down_sampling.py:71-74."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // factor, factor, w // factor, factor)
    return x.mean(dim=(3, 5))


def upsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR upsample by `factor`. Reference: up_or_down_sampling.py:200-229."""
    assert isinstance(factor, int) and factor >= 1
    if k is None:
        k = [1] * factor
    k1d = np.asarray(k, np.float64)
    if _fir2x_ok(x, k1d, factor):
        # separable: outer(k,k)/sum * gain*4 == outer(k', k') with
        # k' = k/sum(k) * sqrt(gain)*2
        return fir2x.up2x(x, tuple((k1d / k1d.sum() * (gain**0.5) * factor).tolist()))
    k = setup_kernel(k) * (gain * (factor**2))
    p = k.shape[0] - factor
    return upfirdn2d_ref(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR downsample by `factor`. Reference: up_or_down_sampling.py:232-262."""
    assert isinstance(factor, int) and factor >= 1
    if k is None:
        k = [1] * factor
    k1d = np.asarray(k, np.float64)
    if _fir2x_ok(x, k1d, factor):
        return fir2x.down2x(x, tuple((k1d / k1d.sum() * (gain**0.5)).tolist()))
    k = setup_kernel(k) * gain
    p = k.shape[0] - factor
    return upfirdn2d_ref(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def upsample_conv_2d(
    x: torch.Tensor, w: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0
) -> torch.Tensor:
    """Fused upsample + conv2d (w is OIHW). Reference: up_or_down_sampling.py:77-146.

    The JAX package computes a cross-correlation of the factor-dilated input
    with w under full (kh-1) padding (`ddgan_tpu/ops/resample.py:123`); that
    is a stride-`factor` transposed conv with w flipped and its in/out axes
    swapped, followed by the FIR.
    """
    assert isinstance(factor, int) and factor >= 1
    out_c, in_c, kh, kw = w.shape
    assert kh == kw
    if k is None:
        k = [1] * factor
    k = setup_kernel(k) * (gain * (factor**2))
    p = (k.shape[0] - factor) - (kw - 1)
    out = F.conv_transpose2d(x, torch.flip(w, (2, 3)).transpose(0, 1), stride=factor)
    return upfirdn2d_ref(out, k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(
    x: torch.Tensor, w: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0
) -> torch.Tensor:
    """Fused conv2d + downsample (w is OIHW). Reference: up_or_down_sampling.py:149-183."""
    assert isinstance(factor, int) and factor >= 1
    _, _, kh, kw = w.shape
    assert kh == kw
    if k is None:
        k = [1] * factor
    k = setup_kernel(k) * gain
    p = (k.shape[0] - factor) + (kw - 1)
    x = upfirdn2d_ref(x, k, pad=((p + 1) // 2, p // 2))
    return F.conv2d(x, w, stride=factor)
