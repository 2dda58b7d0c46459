"""NCSN++ z-conditioned generator (NCHW).

Predicts x0 from (x_{t+1}, t, z). Counterpart of `ddgan_tpu/models/ncsnpp.py`
(reference: score_sde/models/ncsnpp_generator_adagn.py). The modules sit in
one flat `all_modules` list built in the reference's order, and the latent
map is the Sequential `z_transform`, so the state_dict keys are the
reference's (`all_modules.{i}.…`, `z_transform.{2j+1}.…`).

This port covers the block options that the flagship CIFAR-10 recipe and
the CelebA-HQ 256 recipe share: BigGAN resblocks, no output pyramid, a
residual input pyramid, positional time embedding, FIR resampling, time
conditioning and the tanh head, at any width, ch_mult, depth and image
size. Any other option raises NotImplementedError naming the ROADMAP item
that ports it. In bf16, the 3x3 convs of the 128² and 256² levels with 64
output channels run the gated conv kernel (`ops/pair_conv.py`). In train
mode the dropout masks come from the generator given to
`set_dropout_generator` (the train step hands it its own).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn import blocks
from ..nn.layers import Conv3x3, Dense, Linear, PixelNorm, default_init, get_timestep_embedding
from .registry import register_model

_OTHER_OPTIONS = "ROADMAP.md Queue 1 item 4 (the other generator options)"

# option -> the value this port supports
_FLAGSHIP_OPTIONS = {
    "resblock_type": "biggan",
    "progressive": "none",
    "progressive_input": "residual",
    "embedding_type": "positional",
    "fir": True,
    "conditional": True,
    "not_use_tanh": False,
    "centered": True,
}


def resolve_compute_dtype(name: Any) -> torch.dtype | None:
    """config.compute_dtype → torch dtype (None = float32). Raises on an
    unknown name rather than running float32 in silence."""
    table = {"float32": None, "f32": None, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
    key = str(name)
    if key not in table:
        raise ValueError(f"compute_dtype={name!r} not supported; expected one of {sorted(table)}")
    return table[key]


@register_model(name="ncsnpp")
class NCSNpp(nn.Module):
    """NCSN++ generator. Construct via `NCSNpp.from_config(cfg)`."""

    def __init__(
        self,
        nf: int = 128,
        ch_mult: Sequence[int] = (1, 2, 2, 2),
        num_res_blocks: int = 2,
        attn_resolutions: Sequence[int] = (16,),
        dropout: float = 0.1,
        image_size: int = 32,
        fir_kernel: Sequence[int] = (1, 3, 3, 1),
        skip_rescale: bool = True,
        num_channels: int = 3,
        nz: int = 100,
        z_emb_dim: int = 256,
        n_mlp: int = 3,
        dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None,
        **options: Any,
    ):
        super().__init__()
        for key, value in options.items():
            if key not in _FLAGSHIP_OPTIONS:
                raise TypeError(f"unknown NCSNpp option {key!r}")
            if value != _FLAGSHIP_OPTIONS[key]:
                raise NotImplementedError(
                    f"NCSNpp {key}={value!r} is not ported yet (the port has "
                    f"{key}={_FLAGSHIP_OPTIONS[key]!r}); see {_OTHER_OPTIONS}"
                )
        self.nf, self.ch_mult = nf, tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.skip_rescale, self.dtype = skip_rescale, dtype
        num_resolutions = len(self.ch_mult)
        all_resolutions = [image_size // (2**i) for i in range(num_resolutions)]

        temb_dim = nf * 4
        modules: list[nn.Module] = [
            Linear(nf, temb_dim, default_init()),
            Linear(temb_dim, temb_dim, default_init()),
        ]

        def resnet_block(in_ch, out_ch=None, **kw):
            return blocks.ResnetBlockBigGANppAdagn(
                in_ch, out_ch, temb_dim=temb_dim, zemb_dim=z_emb_dim, dropout=dropout,
                fir=True, fir_kernel=fir_kernel, skip_rescale=skip_rescale,
                init_scale=0.0, dtype=dtype, **kw,
            )

        def attn_block(ch):
            return blocks.AttnBlockpp(ch, skip_rescale=skip_rescale, init_scale=0.0, dtype=dtype)

        # Downsampling (reference :174-210)
        modules.append(Conv3x3(num_channels, nf, dtype=dtype))
        hs_c = [nf]
        in_ch = nf
        input_pyramid_ch = num_channels
        for i_level in range(num_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resnet_block(in_ch, out_ch))
                in_ch = out_ch
                if all_resolutions[i_level] in self.attn_resolutions:
                    modules.append(attn_block(in_ch))
                hs_c.append(in_ch)
            if i_level != num_resolutions - 1:
                modules.append(resnet_block(in_ch, down=True))
                modules.append(
                    blocks.Downsample(input_pyramid_ch, in_ch, with_conv=True, fir=True,
                                      fir_kernel=fir_kernel, dtype=dtype)
                )
                input_pyramid_ch = in_ch
                hs_c.append(in_ch)

        # middle (:212-215)
        in_ch = hs_c[-1]
        modules += [resnet_block(in_ch), attn_block(in_ch), resnet_block(in_ch)]

        # Upsampling (:217-261)
        for i_level in reversed(range(num_resolutions)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resnet_block(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if all_resolutions[i_level] in self.attn_resolutions:
                modules.append(attn_block(in_ch))
            if i_level != 0:
                modules.append(resnet_block(in_ch, up=True))
        assert not hs_c

        modules.append(blocks.HeadGroupNorm(min(in_ch // 4, 32), in_ch, dtype=dtype))
        modules.append(Conv3x3(in_ch, num_channels, init_scale=0.0, dtype=dtype))
        self.all_modules = nn.ModuleList(modules)

        # latent mapping (:271-277): PixelNorm, then 1 + n_mlp x (dense, act)
        mapping: list[nn.Module] = [PixelNorm()]
        for j in range(1 + n_mlp):
            mapping += [Dense(nz if j == 0 else z_emb_dim, z_emb_dim), nn.SiLU()]
        self.z_transform = nn.Sequential(*mapping)
        if generator is not None:
            self.init_weights(generator)

    @classmethod
    def from_config(cls, config: Any, generator: torch.Generator | None = None) -> "NCSNpp":
        options = {
            "resblock_type": str(config.resblock_type).lower(),
            "progressive": str(config.progressive).lower(),
            "progressive_input": str(config.progressive_input).lower(),
            "embedding_type": str(config.embedding_type).lower(),
            "fir": bool(config.fir),
            "conditional": bool(config.conditional),
            "not_use_tanh": bool(config.not_use_tanh),
            "centered": bool(getattr(config, "centered", True)),
        }
        return cls(
            nf=config.num_channels_dae,
            ch_mult=tuple(config.ch_mult),
            num_res_blocks=config.num_res_blocks,
            attn_resolutions=tuple(config.attn_resolutions),
            dropout=config.dropout,
            image_size=config.image_size,
            fir_kernel=tuple(config.fir_kernel),
            skip_rescale=config.skip_rescale,
            num_channels=config.num_channels,
            nz=config.nz,
            z_emb_dim=config.z_emb_dim,
            n_mlp=config.n_mlp,
            dtype=resolve_compute_dtype(getattr(config, "compute_dtype", "float32")),
            generator=generator,
            **options,
        )

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """Draw every layer's initial weights from `generator`."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """Draw the dropout masks of train mode from `generator` (on the
        device the model runs on); None restores torch's default one."""
        for m in self.modules():
            if isinstance(m, blocks.Dropout):
                m.generator = generator

    def forward(self, x: torch.Tensor, time_cond: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        modules = self.all_modules
        zemb = self.z_transform(z)
        temb = get_timestep_embedding(time_cond, self.nf)
        temb = modules[0](temb)
        temb = modules[1](F.silu(temb))
        m_idx = 2

        if self.dtype is not None:
            x = x.to(self.dtype)
        input_pyramid = x
        hs = [modules[m_idx](x)]
        m_idx += 1
        num_resolutions = len(self.ch_mult)
        for i_level in range(num_resolutions):
            for _ in range(self.num_res_blocks):
                h = modules[m_idx](hs[-1], temb, zemb)
                m_idx += 1
                # resolution test on the W axis, as the JAX package's NHWC shape[2]
                if h.shape[3] in self.attn_resolutions:
                    h = modules[m_idx](h)
                    m_idx += 1
                hs.append(h)
            if i_level != num_resolutions - 1:
                h = modules[m_idx](hs[-1], temb, zemb)
                m_idx += 1
                input_pyramid = modules[m_idx](input_pyramid)
                m_idx += 1
                if self.skip_rescale:
                    input_pyramid = blocks._rescale(input_pyramid + h)
                else:
                    input_pyramid = input_pyramid + h
                h = input_pyramid
                hs.append(h)

        h = hs[-1]
        h = modules[m_idx](h, temb, zemb)
        h = modules[m_idx + 1](h)
        h = modules[m_idx + 2](h, temb, zemb)
        m_idx += 3

        for i_level in reversed(range(num_resolutions)):
            for _ in range(self.num_res_blocks + 1):
                h = modules[m_idx](torch.cat([h, hs.pop()], dim=1), temb, zemb)
                m_idx += 1
            if h.shape[3] in self.attn_resolutions:
                h = modules[m_idx](h)
                m_idx += 1
            if i_level != 0:
                h = modules[m_idx](h, temb, zemb)
                m_idx += 1
        assert not hs

        h = F.silu(modules[m_idx](h))
        h = modules[m_idx + 1](h)
        assert m_idx + 2 == len(modules)
        return torch.tanh(h.to(torch.float32))
