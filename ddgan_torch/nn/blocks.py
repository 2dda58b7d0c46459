"""NCSN++ building blocks (NCHW).

Counterpart of `ddgan_tpu/nn/blocks.py` (reference semantics:
score_sde/models/layerspp.py and up_or_down_sampling.py:28-61). All group
norms use eps=1e-6 and num_groups=min(C//4, 32); skip connections rescale
by 1/sqrt(2) when `skip_rescale`.

Compute dtype follows the JAX package. Group-norm statistics and softmax
run in float32. The JAX package rescales a skip sum by the NumPy scalar
`np.sqrt(2.0)`, which is not weakly typed, so a bfloat16 sum is promoted
to float32 there; `_rescale` keeps that, and the stream between blocks is
float32 in both packages.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import resample
from .layers import NIN, Conv1x1, Conv3x3, Linear, compute_dtype, default_init, dense_init


def _num_groups(channels: int) -> int:
    return min(channels // 4, 32)


def _rescale(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.promote_types(v.dtype, torch.float32)) / math.sqrt(2.0)


def _group_stats(x: torch.Tensor, groups: int):
    """Per-(batch, group) mean and variance in f32, as E[x²] − E[x]² from
    two per-channel reductions; each returned [B, C] (repeated over the
    channels of a group)."""
    b, c = x.shape[:2]
    cpg = c // groups
    xf = x.to(torch.float32)
    s1 = xf.mean(dim=(2, 3))
    s2 = xf.square().mean(dim=(2, 3))
    mean = s1.reshape(b, groups, cpg).mean(-1)
    var = s2.reshape(b, groups, cpg).mean(-1) - mean.square()
    return mean.repeat_interleave(cpg, dim=1), var.repeat_interleave(cpg, dim=1)


def _folded_norm(x, mean, var, scale, shift, dt):
    """(x − μ_dt)·a + b with a = scale·rstd in f32 and the rounding residual
    of μ_dt folded into b, as `ddgan_tpu/nn/blocks.py:62-116`: in bfloat16
    the naive x·a + (β − μ·a) cancels when |μ| ≫ σ; in f32 this is plain
    centering."""
    a_f = scale * torch.rsqrt(var + 1e-6)
    mu_dt = mean.to(dt)
    b_f = shift + (mu_dt.to(torch.float32) - mean) * a_f
    return (x.to(dt) - mu_dt[:, :, None, None]) * a_f.to(dt)[:, :, None, None] + b_f.to(dt)[
        :, :, None, None
    ]


def _style_bias_init(channels: int, bias: torch.Tensor) -> None:
    """[1]*C + [0]*C: gamma starts at 1 and beta at 0."""
    bias[:channels] = 1.0
    bias[channels:] = 0.0


class AdaptiveGroupNorm(nn.Module):
    """GroupNorm(affine=False) modulated by a style vector. (layerspp.py:46-63)

    style = Linear(zemb) → (gamma, beta), with the bias initialized so gamma
    starts at 1 and beta at 0 (the JAX package's `style_bias_init`).
    """

    def __init__(self, num_groups: int, in_channel: int, style_dim: int, dtype=None):
        super().__init__()
        self.num_groups, self.channels, self.dtype = num_groups, in_channel, dtype
        self.style = Linear(style_dim, in_channel * 2, dense_init(1.0), dtype=dtype,
                            bias_init=functools.partial(_style_bias_init, in_channel))

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.style(style).chunk(2, dim=1)
        mean, var = _group_stats(x, self.num_groups)
        dt = self.dtype if self.dtype is not None else torch.promote_types(x.dtype, torch.float32)
        return _folded_norm(x, mean, var, gamma.to(torch.float32), beta.to(torch.float32), dt)


class HeadGroupNorm(nn.Module):
    """Affine GroupNorm(eps=1e-6) in the folded form of AdaptiveGroupNorm.
    Parameters `weight` (ones) and `bias` (zeros), as torch's GroupNorm."""

    def __init__(self, num_groups: int, num_channels: int, dtype=None):
        super().__init__()
        self.num_groups, self.dtype = num_groups, dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _group_stats(x, self.num_groups)
        dt = self.dtype if self.dtype is not None else torch.promote_types(x.dtype, torch.float32)
        return _folded_norm(x, mean, var, self.weight.float()[None], self.bias.float()[None], dt)


class GroupNorm(nn.Module):
    """flax.linen.GroupNorm(epsilon=eps): statistics and normalization in
    float32 (variance E[x²] − E[x]², clamped at 0), output in the compute
    dtype."""

    def __init__(self, num_groups: int, num_channels: int, dtype=None, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.dtype, self.eps = num_groups, dtype, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        cpg = c // self.num_groups
        xf = x.to(torch.float32)
        xg = xf.reshape(b, self.num_groups, -1)
        mean = xg.mean(-1)
        var = (xg.square().mean(-1) - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(cpg, dim=1) * self.weight.float()
        mean = mean.repeat_interleave(cpg, dim=1)
        y = (xf - mean[:, :, None, None]) * mul[:, :, None, None]
        y = y + self.bias.float()[None, :, None, None]
        dt = self.dtype if self.dtype is not None else torch.promote_types(x.dtype, torch.float32)
        return y.to(dt)


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier embedding of the noise level. (layerspp.py:65-74)

    W, a fixed random projection N(0, 1) * scale, is a persistent buffer:
    the JAX package keeps it in the 'buffers' collection, out of the
    parameters that Adam, the EMA and the swarms cover; the state_dict
    still carries it as `W`, the reference's key.
    """

    def __init__(self, embedding_size: int = 256, scale: float = 1.0):
        super().__init__()
        self.scale = float(scale)
        self.register_buffer("W", torch.empty(embedding_size))
        self.init_weights()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        self.W.normal_(generator=generator).mul_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class Combine(nn.Module):
    """Combine the input pyramid with the stream: Conv1x1 of the pyramid,
    then cat or sum. (layerspp.py:77-92)"""

    def __init__(self, in_ch: int, out_ch: int, method: str = "cat", dtype=None):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"Method {method} not recognized.")
        self.method = method
        self.Conv_0 = Conv1x1(in_ch, out_ch, dtype=dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(x)
        if self.method == "cat":
            dt = torch.promote_types(h.dtype, y.dtype)
            return torch.cat([h.to(dt), y.to(dt)], dim=1)
        return h + y


class AttnBlockpp(nn.Module):
    """Full spatial self-attention over H*W. (layerspp.py:95-124)

    q/k/v/out are NIN projections; logits scaled by C^-0.5, softmax over the
    key positions. Both products and the softmax run in float32, as the
    JAX package's einsums with preferred_element_type=float32.
    """

    def __init__(self, channels: int, skip_rescale: bool = False, init_scale: float = 0.0,
                 dtype=None):
        super().__init__()
        self.skip_rescale, self.dtype = skip_rescale, dtype
        self.GroupNorm_0 = GroupNorm(_num_groups(channels), channels, dtype=dtype)
        self.NIN_0 = NIN(channels, channels, dtype=dtype)
        self.NIN_1 = NIN(channels, channels, dtype=dtype)
        self.NIN_2 = NIN(channels, channels, dtype=dtype)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wid = x.shape
        h = self.GroupNorm_0(x).reshape(b, c, hgt * wid).transpose(1, 2)  # (B, HW, C)
        q = self.NIN_0.channels_last(h)
        k = self.NIN_1.channels_last(h)
        v = self.NIN_2.channels_last(h)
        w = torch.matmul(q.float(), k.float().transpose(1, 2)) * (int(c) ** (-0.5))
        w = torch.softmax(w, dim=-1).to(v.dtype)
        h = torch.matmul(w.float(), v.float()).to(v.dtype)
        h = self.NIN_3.channels_last(h).transpose(1, 2).reshape(b, c, hgt, wid)
        if not self.skip_rescale:
            return x + h
        return _rescale(x + h)


class FirConv2d(nn.Module):
    """Conv2d fused with FIR up/down resampling. (up_or_down_sampling.py:28-61)

    Weight (out, in, k, k) with default_init(); zero bias.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, up: bool = False,
                 down: bool = False, resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 use_bias: bool = True, dtype=None):
        super().__init__()
        assert not (up and down)
        self.kernel, self.up, self.down, self.dtype = kernel, up, down, dtype
        self.resample_kernel = tuple(resample_kernel)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        self.init_weights()

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        out_ch, in_ch, kh, kw = self.weight.shape
        default_init()(self.weight, in_ch * kh * kw, out_ch * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x, self.weight, self.dtype)
        x, w = x.to(dt), self.weight.to(dt)
        if self.up:
            out = resample.upsample_conv_2d(x, w, k=self.resample_kernel)
        elif self.down:
            out = resample.conv_downsample_2d(x, w, k=self.resample_kernel)
        else:
            out = F.conv2d(x, w, padding=self.kernel // 2)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype).reshape(1, -1, 1, 1)
        return out


class Upsample(nn.Module):
    """2x upsampling, optionally FIR and/or with conv. (layerspp.py:127-159)"""

    def __init__(self, in_ch: int, out_ch: int | None = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel: Sequence[int] = (1, 3, 3, 1), dtype=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)
        if with_conv and not fir:
            self.Conv_0 = Conv3x3(in_ch, out_ch, dtype=dtype)
        elif with_conv:
            self.Conv2d_0 = FirConv2d(in_ch, out_ch, kernel=3, up=True,
                                      resample_kernel=fir_kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fir:
            out = resample.naive_upsample_2d(x, factor=2)
            return self.Conv_0(out) if self.with_conv else out
        if not self.with_conv:
            return resample.upsample_2d(x, self.fir_kernel, factor=2)
        return self.Conv2d_0(x)


class Downsample(nn.Module):
    """2x downsampling, optionally FIR and/or with conv. (layerspp.py:162-196)"""

    def __init__(self, in_ch: int, out_ch: int | None = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel: Sequence[int] = (1, 3, 3, 1), dtype=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)
        if with_conv and not fir:
            self.Conv_0 = Conv3x3(in_ch, out_ch, stride=2, padding=0, dtype=dtype)
        elif with_conv:
            self.Conv2d_0 = FirConv2d(in_ch, out_ch, kernel=3, down=True,
                                      resample_kernel=fir_kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fir:
            if self.with_conv:
                # F.pad (0,1,0,1) then stride-2 valid conv (layerspp.py:186-188)
                return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
            return F.avg_pool2d(x, 2, 2)
        if not self.with_conv:
            return resample.downsample_2d(x, self.fir_kernel, factor=2)
        return self.Conv2d_0(x)


class Dropout(nn.Module):
    """Dropout whose masks come from `generator` (None: torch's default
    generator of the input's device), so two runs seeded alike draw the
    same masks: in training, keep each value with probability 1 - p and
    scale it by 1 / (1 - p), as flax's `nn.Dropout`; the identity in eval
    mode or at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


class _TembProj(Linear):
    """Per-channel bias from the time embedding: Linear(act(temb)),
    default_init weight, zero bias (layerspp.py:263-265)."""

    def __init__(self, in_features: int, out_features: int, dtype=None):
        super().__init__(in_features, out_features, default_init(), dtype=dtype)


class ResnetBlockBigGANppAdagn(nn.Module):
    """BigGAN-style ResBlock with in-block FIR up/down. (layerspp.py:247-310)

    The FIR resampling of h and of the skip x goes through
    `resample.upsample_2d` / `downsample_2d`, so on the GPU each up or down
    block launches the fir2x kernel twice.
    """

    def __init__(self, in_ch: int, out_ch: int | None = None, temb_dim: int | None = None,
                 zemb_dim: int = 256, up: bool = False, down: bool = False,
                 dropout: float = 0.1, fir: bool = False,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1), skip_rescale: bool = True,
                 init_scale: float = 0.0, dtype=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.up, self.down, self.fir = up, down, fir
        self.fir_kernel, self.skip_rescale = tuple(fir_kernel), skip_rescale
        self.GroupNorm_0 = AdaptiveGroupNorm(_num_groups(in_ch), in_ch, zemb_dim, dtype=dtype)
        self.Conv_0 = Conv3x3(in_ch, out_ch, dtype=dtype)
        if temb_dim is not None:
            self.Dense_0 = _TembProj(temb_dim, out_ch, dtype=dtype)
        self.GroupNorm_1 = AdaptiveGroupNorm(_num_groups(out_ch), out_ch, zemb_dim, dtype=dtype)
        self.Dropout_0 = Dropout(dropout)
        self.Conv_1 = Conv3x3(out_ch, out_ch, init_scale=init_scale, dtype=dtype)
        if in_ch != out_ch or up or down:
            self.Conv_2 = Conv1x1(in_ch, out_ch, dtype=dtype)

    def _resample(self, v: torch.Tensor) -> torch.Tensor:
        if self.up:
            if self.fir:
                return resample.upsample_2d(v, self.fir_kernel, factor=2)
            return resample.naive_upsample_2d(v, factor=2)
        if self.fir:
            return resample.downsample_2d(v, self.fir_kernel, factor=2)
        return resample.naive_downsample_2d(v, factor=2)

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None,
                zemb: torch.Tensor | None = None) -> torch.Tensor:
        h = F.silu(self.GroupNorm_0(x, zemb))
        if self.up or self.down:
            h = self._resample(h)
            x = self._resample(x)
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(F.silu(temb))[:, :, None, None]
        h = F.silu(self._norm_1(h, zemb))
        h = self.Dropout_0(h)
        h = self.Conv_1(h)
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        if not self.skip_rescale:
            return x + h
        return _rescale(x + h)

    def _norm_1(self, h: torch.Tensor, zemb: torch.Tensor | None) -> torch.Tensor:
        return self.GroupNorm_1(h, zemb)


class ResnetBlockBigGANppAdagnOne(ResnetBlockBigGANppAdagn):
    """The BigGAN ResBlock with the adaptive norm on the first GroupNorm
    only; GroupNorm_1 is a plain affine GroupNorm. (layerspp.py:313-379)"""

    def __init__(self, in_ch: int, out_ch: int | None = None, zemb_dim: int = 256,
                 dtype=None, **kw):
        super().__init__(in_ch, out_ch, zemb_dim=zemb_dim, dtype=dtype, **kw)
        out_ch = out_ch or in_ch
        self.GroupNorm_1 = GroupNorm(_num_groups(out_ch), out_ch, dtype=dtype)

    def _norm_1(self, h: torch.Tensor, zemb: torch.Tensor | None) -> torch.Tensor:
        return self.GroupNorm_1(h)


class ResnetBlockDDPMppAdagn(nn.Module):
    """DDPM-style ResBlock with adaptive GroupNorms. (layerspp.py:199-244)

    The shortcut is NIN_0 when the width changes, or the 3x3 Conv_2 under
    `conv_shortcut`.
    """

    def __init__(self, in_ch: int, out_ch: int | None = None, temb_dim: int | None = None,
                 zemb_dim: int = 256, conv_shortcut: bool = False, dropout: float = 0.1,
                 skip_rescale: bool = False, init_scale: float = 0.0, dtype=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = AdaptiveGroupNorm(_num_groups(in_ch), in_ch, zemb_dim, dtype=dtype)
        self.Conv_0 = Conv3x3(in_ch, out_ch, dtype=dtype)
        if temb_dim is not None:
            self.Dense_0 = _TembProj(temb_dim, out_ch, dtype=dtype)
        self.GroupNorm_1 = AdaptiveGroupNorm(_num_groups(out_ch), out_ch, zemb_dim, dtype=dtype)
        self.Dropout_0 = Dropout(dropout)
        self.Conv_1 = Conv3x3(out_ch, out_ch, init_scale=init_scale, dtype=dtype)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = Conv3x3(in_ch, out_ch, dtype=dtype)
            else:
                self.NIN_0 = NIN(in_ch, out_ch, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None,
                zemb: torch.Tensor | None = None) -> torch.Tensor:
        h = F.silu(self.GroupNorm_0(x, zemb))
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(F.silu(temb))[:, :, None, None]
        h = F.silu(self.GroupNorm_1(h, zemb))
        h = self.Dropout_0(h)
        h = self.Conv_1(h)
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        elif hasattr(self, "NIN_0"):
            x = self.NIN_0(x)
        if not self.skip_rescale:
            return x + h
        return _rescale(x + h)
