"""Time-conditional discriminators D(x_t | x_{t+1}) (NCHW).

Counterpart of `ddgan_tpu/models/discriminator.py` (reference semantics:
score_sde/models/discriminator.py). The pair (x, x_t) is concatenated on
channels; every DownConvBlock adds a per-channel projection of the time
embedding; a StyleGAN2-style minibatch-stddev feature is appended before
the head. Module names are the reference torch keys (`t_embed.main.{0,2}`,
`conv1.conv1.0`, `conv1.dense_t1`, `conv1.skip.0`, `final_conv`,
`end_linear`), so `load_state_dict(strict=True)` takes a reference
checkpoint and the output of `compat.state_dict_from_flax`.

With a compute dtype (bfloat16) the convs and the block's time projection
run in it, while the time embedding, the stddev statistic, the head's sum
and the final Dense run in float32, as in the JAX package. The FIR
downsampling goes through `resample.downsample_2d`, so on the GPU each
downsampling block launches the fir2x kernel twice, and its gradients
(R1's grad-of-grad included) launch it too.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import _rescale
from ..nn.layers import ConvLayer, Dense, get_timestep_embedding
from ..ops import resample
from ..trace import span
from .ncsnpp import resolve_compute_dtype
from .registry import register_model

FIR_KERNEL = (1, 3, 3, 1)


def leaky_relu_02(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


class TimestepEmbedding(nn.Module):
    """Sinusoidal embedding → dense → act → dense. (discriminator.py:19-36)"""

    def __init__(self, embedding_dim: int, hidden_dim: int, output_dim: int):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.main = nn.Sequential(
            Dense(embedding_dim, hidden_dim), nn.LeakyReLU(0.2), Dense(hidden_dim, output_dim)
        )

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.main(get_timestep_embedding(t, self.embedding_dim))


class DownConvBlock(nn.Module):
    """Residual conv block with t-conditioning and FIR down. (discriminator.py:38-94)"""

    def __init__(self, in_channel: int, out_channel: int, t_emb_dim: int,
                 downsample: bool = False, dtype=None):
        super().__init__()
        self.downsample = downsample
        self.conv1 = nn.Sequential(ConvLayer(in_channel, out_channel, 3, padding=1, dtype=dtype))
        self.conv2 = nn.Sequential(
            ConvLayer(out_channel, out_channel, 3, padding=1, init_scale=0.0, dtype=dtype)
        )
        self.dense_t1 = Dense(t_emb_dim, out_channel, dtype=dtype)
        self.skip = nn.Sequential(
            ConvLayer(in_channel, out_channel, 1, padding=0, use_bias=False, dtype=dtype)
        )

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        out = self.conv1(leaky_relu_02(x))
        out = out + self.dense_t1(t_emb)[:, :, None, None]
        out = leaky_relu_02(out)
        if self.downsample:
            out = resample.downsample_2d(out, FIR_KERNEL, factor=2)
            x = resample.downsample_2d(x, FIR_KERNEL, factor=2)
        out = self.conv2(out)
        skip = self.skip(x)
        # / np.sqrt(2.0) in the JAX package: a bf16 sum becomes float32
        return _rescale(out + skip)


def minibatch_stddev(out: torch.Tensor, stddev_group: int = 4,
                     stddev_feat: int = 1) -> torch.Tensor:
    """Append the StyleGAN2 minibatch-stddev feature map. (discriminator.py:150-158)

    Grouping is strided over the batch (torch `.view(group, -1, ...)`):
    group member m aggregates samples {m, m + B/g, ...}. The variance is
    biased; the statistic is computed in float32 and cast back.
    """
    batch, channel, height, width = out.shape
    group = min(batch, stddev_group)
    s = out.float().reshape(group, -1, stddev_feat, channel // stddev_feat, height, width)
    std = torch.sqrt(s.var(0, correction=0) + 1e-8)
    std = std.mean((2, 3, 4), keepdim=True).squeeze(2)  # (B/g, feat, 1, 1)
    std = std.repeat(group, 1, height, width).to(out.dtype)
    return torch.cat([out, std], 1)


class _Discriminator(nn.Module):
    """The shared trunk of both discriminators: time embedding, the pair
    concat, a 1x1 start conv, the DownConvBlocks, minibatch stddev, a 3x3
    conv and the float32 head."""

    def __init__(self, nc: int, ngf: int, t_emb_dim: int, blocks: list, final_init_scale: float,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.t_embed = TimestepEmbedding(t_emb_dim, t_emb_dim, t_emb_dim)
        self.start_conv = ConvLayer(nc, ngf * 2, 1, padding=0, dtype=dtype)
        for i, (c_in, c_out, down) in enumerate(blocks, start=1):
            setattr(self, f"conv{i}", DownConvBlock(c_in, c_out, t_emb_dim, down, dtype))
        self.n_blocks = len(blocks)
        self.final_conv = ConvLayer(ngf * 8 + 1, ngf * 8, 3, padding=1,
                                    init_scale=final_init_scale, dtype=dtype)
        self.end_linear = Dense(ngf * 8, 1)

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """Draw every layer's initial weights from `generator`."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
        with span("ddgan.D", x.device):
            t_embed = leaky_relu_02(self.t_embed(t))
            # cast before the concat, as the JAX package (bit-identical to
            # concat-then-cast, half the bytes)
            if self.dtype is not None:
                x, x_t = x.to(self.dtype), x_t.to(self.dtype)
            h = self.start_conv(torch.cat([x, x_t], dim=1))
            for i in range(1, self.n_blocks + 1):
                h = getattr(self, f"conv{i}")(h, t_embed)
            out = leaky_relu_02(self.final_conv(minibatch_stddev(h)))
            # head in float32 (big spatial sums deserve full precision)
            return self.end_linear(out.float().sum((2, 3)))


@register_model(name="discriminator_small")
class DiscriminatorSmall(_Discriminator):
    """4-block discriminator for 32x32 images. (discriminator.py:96-167)

    `nc` counts the channels of the input pair (2 x image channels), as the
    reference's constructor argument."""

    def __init__(self, nc: int = 6, ngf: int = 64, t_emb_dim: int = 128, dtype=None):
        blocks = [(ngf * 2, ngf * 2, False), (ngf * 2, ngf * 4, True),
                  (ngf * 4, ngf * 8, True), (ngf * 8, ngf * 8, True)]
        super().__init__(nc, ngf, t_emb_dim, blocks, final_init_scale=0.0, dtype=dtype)


@register_model(name="discriminator_large")
class DiscriminatorLarge(_Discriminator):
    """6-block discriminator for 256x256 images. (discriminator.py:170-238)

    `nc` counts the channels of the input pair (2 x image channels)."""

    def __init__(self, nc: int = 2, ngf: int = 32, t_emb_dim: int = 128, dtype=None):
        blocks = [(ngf * 2, ngf * 4, True), (ngf * 4, ngf * 8, True)] + [
            (ngf * 8, ngf * 8, True)] * 4
        super().__init__(nc, ngf, t_emb_dim, blocks, final_init_scale=1.0, dtype=dtype)


def build_discriminator(config, generator: torch.Generator | None = None) -> nn.Module:
    """The discriminator of a config (`disc_small` yes → Small, else
    Large) in its `compute_dtype`, as the JAX package's `build_models`;
    with `generator`, the initial weights are drawn from it."""
    cls = DiscriminatorSmall if str(config.disc_small).lower() == "yes" else DiscriminatorLarge
    disc = cls(nc=2 * config.num_channels, ngf=config.ngf, t_emb_dim=config.t_emb_dim,
               dtype=resolve_compute_dtype(getattr(config, "compute_dtype", "float32")))
    if generator is not None:
        disc.init_weights(generator)
    return disc
