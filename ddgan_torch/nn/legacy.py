"""Legacy NCSNv1/v2 and plain DDPM layer library (NCHW).

Counterpart of `ddgan_tpu/nn/legacy.py` (reference: score_sde/models/
layers.py:147-362, the NCSN blocks, and :515-619, the plain DDPM blocks).
NCSN++ does not use them; they are the library surface that score networks
built on them need. Module names are the reference torch modules'
(`convs.{i}`, `{i}_{j}_conv`, `adapt_convs.{i}`, `msf`, `crp`,
`output_convs`, `normalize1`, `conv1`, …, `GroupNorm_0`, `NIN_0`, …).

As in the JAX package, every block takes its input width at construction
(torch needs it), `NCSNConv` draws torch's default weight bound
uniform(±1/sqrt(fan_in)) scaled by init_scale with a zero bias, and the
InstanceNorm of `ResidualBlock` is an affine GroupNorm with one channel a
group and eps 1e-5.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resample import naive_upsample_2d
from .blocks import Dropout, GroupNorm
from .layers import NIN, Conv2d, Conv3x3, Linear, default_init

Act = Callable[[torch.Tensor], torch.Tensor]


def get_act(name: str) -> Act:
    """Activation by config name. (layers.py:42-55)"""
    name = name.lower()
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return functools.partial(F.leaky_relu, negative_slope=0.2)
    if name == "swish":
        return F.silu
    raise NotImplementedError("activation function does not exist!")


def _torch_default_init(init_scale: float):
    scale = 1e-10 if init_scale == 0 else init_scale

    @torch.no_grad()
    def init(t, fan_in, fan_out, generator=None):
        bound = 1.0 / math.sqrt(fan_in)
        return t.uniform_(-bound, bound, generator=generator).mul_(scale)

    return init


class NCSNConv(Conv2d):
    """ncsn_conv1x1 / ncsn_conv3x3. (layers.py:58-66, :123-129)"""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 use_bias: bool = True, dilation: int = 1, init_scale: float = 1.0,
                 padding: int | None = None):
        pad = kernel_size // 2 if padding is None else padding
        super().__init__(in_ch, out_ch, kernel_size, stride, pad, dilation, use_bias,
                         _torch_default_init(init_scale))


def _pool5(x: torch.Tensor, maxpool: bool) -> torch.Tensor:
    """5x5 stride-1 same-pad max or average pool (count_include_pad). (layers.py:154-157)"""
    if maxpool:
        return F.max_pool2d(x, 5, stride=1, padding=2)
    return F.avg_pool2d(x, 5, stride=1, padding=2)


class CRPBlock(nn.Module):
    """Chained residual pooling. (layers.py:147-168)"""

    def __init__(self, features: int, n_stages: int, act: Act = F.relu, maxpool: bool = True):
        super().__init__()
        self.act, self.maxpool = act, maxpool
        self.convs = nn.ModuleList(NCSNConv(features, features, 3, use_bias=False)
                                   for _ in range(n_stages))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(x)
        path = x
        for conv in self.convs:
            path = conv(_pool5(path, self.maxpool))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv units. (layers.py:197-218)"""

    def __init__(self, features: int, n_blocks: int, n_stages: int, act: Act = F.relu):
        super().__init__()
        self.act, self.n_blocks, self.n_stages = act, n_blocks, n_stages
        for i in range(n_blocks):
            for j in range(n_stages):
                setattr(self, f"{i + 1}_{j + 1}_conv",
                        NCSNConv(features, features, 3, use_bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


def _resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """F.interpolate(x, shape, mode='bilinear', align_corners=True)."""
    if tuple(x.shape[2:]) == tuple(shape):
        return x
    return F.interpolate(x, size=tuple(shape), mode="bilinear", align_corners=True)


class MSFBlock(nn.Module):
    """Multi-scale fusion: a conv of each input, resized bilinearly, summed.
    (layers.py:249-264)"""

    def __init__(self, in_planes: Sequence[int], features: int):
        super().__init__()
        self.features = features
        self.convs = nn.ModuleList(NCSNConv(c, features, 3) for c in in_planes)

    def forward(self, xs: Sequence[torch.Tensor], shape) -> torch.Tensor:
        sums = xs[0].new_zeros((xs[0].shape[0], self.features, *shape))
        for conv, xi in zip(self.convs, xs):
            sums = sums + _resize_bilinear(conv(xi), shape)
        return sums


class RefineBlock(nn.Module):
    """RefineNet block: adapting RCUs, MSF, CRP, the output RCU.
    (layers.py:291-325)"""

    def __init__(self, in_planes: Sequence[int], features: int, act: Act = F.relu,
                 start: bool = False, end: bool = False, maxpool: bool = True):
        super().__init__()
        self.adapt_convs = nn.ModuleList(RCUBlock(c, 2, 2, act) for c in in_planes)
        if len(in_planes) > 1:
            self.msf = MSFBlock(in_planes, features)
        self.crp = CRPBlock(features, 2, act, maxpool=maxpool)
        self.output_convs = RCUBlock(features, 3 if end else 1, 2, act)

    def forward(self, xs: Sequence[torch.Tensor], output_shape) -> torch.Tensor:
        hs = [block(xi) for block, xi in zip(self.adapt_convs, xs)]
        h = self.msf(hs, output_shape) if len(xs) > 1 else hs[0]
        return self.output_convs(self.crp(h))


def _mean_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """The mean of the four 2x2 phases. (layers.py:382-385)"""
    return (x[:, :, ::2, ::2] + x[:, :, 1::2, ::2] + x[:, :, ::2, 1::2]
            + x[:, :, 1::2, 1::2]) / 4.0


class ConvMeanPool(nn.Module):
    """(layers.py:365-385)"""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
                 biases: bool = True, adjust_padding: bool = False):
        super().__init__()
        self.adjust_padding = adjust_padding
        self.conv = NCSNConv(input_dim, output_dim, kernel_size, use_bias=biases)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.adjust_padding:
            x = F.pad(x, (1, 0, 1, 0))
        return _mean_pool_2x(self.conv(x))


class MeanPoolConv(nn.Module):
    """(layers.py:388-398)"""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
                 biases: bool = True):
        super().__init__()
        self.conv = NCSNConv(input_dim, output_dim, kernel_size, use_bias=biases)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_mean_pool_2x(x))


class UpsampleConv(nn.Module):
    """cat x4, pixel shuffle 2x (a nearest 2x upsample), conv. (layers.py:401-412)"""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
                 biases: bool = True):
        super().__init__()
        self.conv = NCSNConv(input_dim, output_dim, kernel_size, use_bias=biases)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(naive_upsample_2d(x))


class ResidualBlock(nn.Module):
    """NCSNv1/v2 residual block. (layers.py:413-467)"""

    def __init__(self, input_dim: int, output_dim: int, resample: str | None = None,
                 act: Act = F.elu, dilation: int = 1, adjust_padding: bool = False):
        super().__init__()
        self.act, self.resample = act, resample
        self.normalize1 = GroupNorm(input_dim, input_dim, eps=1e-5)
        if resample == "down":
            mid = input_dim
            self.conv1 = NCSNConv(input_dim, input_dim, 3, dilation=dilation)
            if dilation > 1:
                self.conv2 = NCSNConv(input_dim, output_dim, 3, dilation=dilation)
                shortcut = NCSNConv(input_dim, output_dim, 3, dilation=dilation)
            else:
                self.conv2 = ConvMeanPool(input_dim, output_dim, 3, adjust_padding=adjust_padding)
                shortcut = ConvMeanPool(input_dim, output_dim, 1, adjust_padding=adjust_padding)
        elif resample is None:
            mid = output_dim
            self.conv1 = NCSNConv(input_dim, output_dim, 3, dilation=dilation)
            self.conv2 = NCSNConv(output_dim, output_dim, 3, dilation=dilation)
            shortcut = (NCSNConv(input_dim, output_dim, 3, dilation=dilation) if dilation > 1
                        else NCSNConv(input_dim, output_dim, 1))
        else:
            raise Exception("invalid resample value")
        self.normalize2 = GroupNorm(mid, mid, eps=1e-5)
        self.reshape = output_dim != input_dim or resample is not None
        if self.reshape:  # else the identity skip (layers.py:437-438)
            self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.normalize1(x))
        h = self.conv1(h)
        h = self.act(self.normalize2(h))
        h = self.conv2(h)
        if self.reshape:
            x = self.shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Plain DDPM attention: GroupNorm of 32 groups, no skip rescale.
    (layers.py:515-540)"""

    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(32, channels)
        self.NIN_0 = NIN(channels, channels)
        self.NIN_1 = NIN(channels, channels)
        self.NIN_2 = NIN(channels, channels)
        self.NIN_3 = NIN(channels, channels, init_scale=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wid = x.shape
        h = self.GroupNorm_0(x).reshape(b, c, hgt * wid).transpose(1, 2)  # (B, HW, C)
        q, k, v = self.NIN_0.channels_last(h), self.NIN_1.channels_last(h), self.NIN_2.channels_last(h)
        w = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * (int(c) ** (-0.5)), dim=-1)
        h = self.NIN_3.channels_last(torch.matmul(w, v))
        return x + h.transpose(1, 2).reshape(b, c, hgt, wid)


class UpsampleDDPM(nn.Module):
    """Nearest 2x, and a conv when `with_conv`. (layers.py:543-556)"""

    def __init__(self, channels: int, with_conv: bool = False):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.Conv_0 = Conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = naive_upsample_2d(x)
        return self.Conv_0(out) if self.with_conv else out


class DownsampleDDPM(nn.Module):
    """A stride-2 conv after a (0, 1, 0, 1) pad, or a 2x average pool.
    (layers.py:559-576)"""

    def __init__(self, channels: int, with_conv: bool = False):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.Conv_0 = Conv3x3(channels, channels, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.with_conv:
            return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2, 2)


class ResnetBlockDDPM(nn.Module):
    """Plain DDPM ResBlock: GroupNorms of 32 groups, no adaptive norm.
    (layers.py:579-619)"""

    def __init__(self, act: Act, in_ch: int, out_ch: int | None = None,
                 temb_dim: int | None = None, conv_shortcut: bool = False,
                 dropout: float = 0.1):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = act
        self.GroupNorm_0 = GroupNorm(32, in_ch)
        self.Conv_0 = Conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Linear(temb_dim, out_ch, default_init())
        self.GroupNorm_1 = GroupNorm(32, out_ch)
        self.Dropout_0 = Dropout(dropout)
        self.Conv_1 = Conv3x3(out_ch, out_ch, init_scale=0.0)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = Conv3x3(in_ch, out_ch)
            else:
                self.NIN_0 = NIN(in_ch, out_ch)

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None) -> torch.Tensor:
        h = self.Conv_0(self.act(self.GroupNorm_0(x)))
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        h = self.act(self.GroupNorm_1(h))
        h = self.Conv_1(self.Dropout_0(h))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        elif hasattr(self, "NIN_0"):
            x = self.NIN_0(x)
        return x + h
