"""The plain reference NCSN++ generator with score_sde's output and input
pyramids, in float32.

Written from score_sde's `ncsnpp.py` (its `progressive` and
`progressive_input` branches) and `layerspp.Combine`, with DDGAN's
z-conditioned AdaGN blocks, and built from the blocks of `nets.py`:

  * progressive "output_skip": at each level of the way up, after its
    resblocks and attention, a head GroupNorm -> SiLU -> 3x3 conv to the
    image's channels; the pyramid starts at the lowest level's head and is
    FIR-upsampled 2x and summed with each higher level's head (no rescale);
    the network's output is the pyramid;
  * progressive_input "input_skip": the input pyramid starts at x and is
    FIR-downsampled 2x at each transition, then combined with the stream by
    `Combine`: a 1x1 conv of the pyramid to the stream's channels, summed
    with it (no rescale).

"none" and "residual" are `nets.Generator`'s, computed the same way, so at
those options this generator gives its output bit for bit. Parameters carry
the program's names (`ddgan_torch.models.NCSNpp`): the per-level heads and
the combines sit in `all_modules` in the order the program builds them, and
the parameter-free pyramid resamplers lie outside it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import nets
from .nets import SQRT2, Affine, Attn, FirDown, Norm, ResBlock, conv
from .ops import Ops, timestep_embedding

PROGRESSIVE = ("none", "output_skip")
PROGRESSIVE_INPUT = ("residual", "input_skip")


def _supported(cfg: dict) -> None:
    """`nets._supported` with the two pyramids' options let through."""
    if cfg.get("progressive", "none") not in PROGRESSIVE:
        raise ValueError(f"the reference generator has progressive in {PROGRESSIVE}, "
                         f"not {cfg['progressive']!r}")
    if cfg.get("progressive_input", "residual") not in PROGRESSIVE_INPUT:
        raise ValueError(f"the reference generator has progressive_input in "
                         f"{PROGRESSIVE_INPUT}, not {cfg['progressive_input']!r}")
    rest = {k: v for k, v in cfg.items() if k not in ("progressive", "progressive_input")}
    nets._supported(rest)


class Combine(nn.Module):
    """The input pyramid's 1x1 conv to the stream's channels
    (layerspp.py:77-92, method "sum")."""

    def __init__(self, c_pyr: int, c_out: int):
        super().__init__()
        self.Conv_0 = Affine(c_out, c_pyr, 1, 1)


class Generator(nn.Module):
    """NCSN++ x0-predictor G(x_{t+1}, t, z) of DDGAN with the output and
    input pyramids, float32 (NCHW)."""

    def __init__(self, cfg: dict):
        super().__init__()
        _supported(cfg)
        nf, mult = cfg["num_channels_dae"], list(cfg["ch_mult"])
        nrb, attn = cfg["num_res_blocks"], set(cfg["attn_resolutions"])
        ch, zdim, size = cfg["num_channels"], cfg["z_emb_dim"], cfg["image_size"]
        self.nf, self.mult, self.nrb, self.attn = nf, mult, nrb, attn
        self.out_skip = cfg.get("progressive", "none") == "output_skip"
        self.in_skip = cfg.get("progressive_input", "residual") == "input_skip"
        temb = 4 * nf

        def rb(c_in, c_out=None, **kw):
            return ResBlock(c_in, c_out or c_in, temb, zdim, cfg["dropout"], **kw)

        mods: list[nn.Module] = [Affine(temb, nf), Affine(temb, temb), Affine(nf, ch, 3, 3)]
        hs_c, c_in, pyr = [nf], nf, ch
        for lvl, m in enumerate(mult):
            for _ in range(nrb):
                mods.append(rb(c_in, nf * m))
                c_in = nf * m
                if size >> lvl in attn:
                    mods.append(Attn(c_in))
                hs_c.append(c_in)
            if lvl != len(mult) - 1:
                mods.append(rb(c_in, down=True))
                if self.in_skip:
                    mods.append(Combine(ch, c_in))
                else:
                    mods.append(FirDown(pyr, c_in))
                    pyr = c_in
                hs_c.append(c_in)
        c_in = hs_c[-1]
        mods += [rb(c_in), Attn(c_in), rb(c_in)]
        for lvl in reversed(range(len(mult))):
            for _ in range(nrb + 1):
                mods.append(rb(c_in + hs_c.pop(), nf * mult[lvl]))
                c_in = nf * mult[lvl]
            if size >> lvl in attn:
                mods.append(Attn(c_in))
            if self.out_skip:
                mods += [Norm(c_in), Affine(ch, c_in, 3, 3)]
            if lvl != 0:
                mods.append(rb(c_in, up=True))
        if not self.out_skip:
            mods += [Norm(c_in), Affine(ch, c_in, 3, 3)]
        self.all_modules = nn.ModuleList(mods)
        z: list[nn.Module] = [nn.Identity()]
        for j in range(1 + cfg["n_mlp"]):
            z += [Affine(zdim, cfg["nz"] if j == 0 else zdim), nn.SiLU()]
        self.z_transform = nn.Sequential(*z)

    def forward(self, ops: Ops, x, t, z):
        zemb = z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8)
        for lin in list(self.z_transform)[1::2]:
            zemb = F.silu(ops.linear(zemb, lin.weight, lin.bias))
        it = iter(self.all_modules)
        m0, m1 = next(it), next(it)
        temb = ops.linear(timestep_embedding(t, self.nf), m0.weight, m0.bias)
        temb = ops.linear(F.silu(temb), m1.weight, m1.bias)
        pyramid = x
        hs = [conv(ops, next(it), x)]
        for lvl in range(len(self.mult)):
            for _ in range(self.nrb):
                h = next(it).run(ops, hs[-1], temb, zemb)
                if h.shape[3] in self.attn:
                    h = next(it).run(ops, h)
                hs.append(h)
            if lvl != len(self.mult) - 1:
                h = next(it).run(ops, hs[-1], temb, zemb)
                if self.in_skip:
                    pyramid = ops.down2x(pyramid)
                    h = conv(ops, next(it).Conv_0, pyramid) + h
                else:
                    down = next(it).Conv2d_0
                    pyramid = ops.conv_down2x(pyramid, down.weight, down.bias)
                    pyramid = (pyramid + h) / SQRT2
                    h = pyramid
                hs.append(h)
        h = next(it).run(ops, hs[-1], temb, zemb)
        h = next(it).run(ops, h)
        h = next(it).run(ops, h, temb, zemb)
        out = None
        for lvl in reversed(range(len(self.mult))):
            for _ in range(self.nrb + 1):
                h = next(it).run(ops, torch.cat([h, hs.pop()], dim=1), temb, zemb)
            if h.shape[3] in self.attn:
                h = next(it).run(ops, h)
            if self.out_skip:
                head = _head(ops, next(it), next(it), h)
                out = head if out is None else ops.up2x(out) + head
            if lvl != 0:
                h = next(it).run(ops, h, temb, zemb)
        if not self.out_skip:
            out = _head(ops, next(it), next(it), h)
        return torch.tanh(out)


def _head(ops: Ops, norm: Norm, head: Affine, h):
    """GroupNorm -> SiLU -> 3x3 conv to the image's channels."""
    h = F.silu(F.group_norm(h, nets._groups(h.shape[1]), norm.weight, norm.bias, eps=1e-6))
    return conv(ops, head, h)
