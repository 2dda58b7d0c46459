"""The plain reference networks: the NCSN++ generator of DDGAN and its two
time-conditional discriminators, in float32.

Written from the published models (score_sde's NCSN++ with DDGAN's
z-conditioned AdaGN blocks, `ncsnpp_generator_adagn.py`, `layerspp.py`,
`discriminator.py` of NVlabs/denoising-diffusion-gan). Parameters carry the
reference torch model's names and shapes, so one set of weights drawn by
name fits this model and the program's. Every product goes through an
`Ops` (`ops.py`), which sets its precision and records its work.

The generator covers the options the benchmark's configurations use:
BigGAN AdaGN resblocks with FIR resampling, positional time embedding,
progressive "none" with a "residual" input pyramid, time conditioning, a
tanh head; anything else raises. Group norms use eps 1e-6 and min(C/4, 32)
groups; skip sums are scaled by 1/sqrt(2).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .ops import Ops, timestep_embedding

SQRT2 = math.sqrt(2.0)


def _groups(c: int) -> int:
    return min(c // 4, 32)


class Affine(nn.Module):
    """A weight (out, in[, k, k]) and an optional bias."""

    def __init__(self, *shape: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(shape[0])) if bias else None


class Nin(nn.Module):
    """1x1 channel mixing through W (in, out) and b."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.W = nn.Parameter(torch.empty(c_in, c_out))
        self.b = nn.Parameter(torch.empty(c_out))


class Norm(nn.Module):
    """An affine group norm's weight and bias."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))


class Style(nn.Module):
    """AdaGN: a group norm without affine, scaled and shifted by a linear map
    of the latent embedding, (gamma, beta) = style(zemb)."""

    def __init__(self, c: int, zdim: int):
        super().__init__()
        self.style = Affine(2 * c, zdim)


def ada_norm(ops: Ops, m: Style, x, zemb):
    gamma, beta = ops.linear(zemb, m.style.weight, m.style.bias).chunk(2, dim=1)
    h = F.group_norm(x, _groups(x.shape[1]), eps=1e-6)
    return h * gamma[:, :, None, None] + beta[:, :, None, None]


def conv(ops: Ops, m: Affine, x, gated: bool = True):
    """A same-padded conv; `gated` marks the generator's, which the program
    may send to its gated 3x3 kernel."""
    k = m.weight.shape[2]
    return ops.conv2d(x, m.weight, m.bias, 1, k // 2, gated)


class ResBlock(nn.Module):
    """BigGAN resblock with AdaGN, optional FIR up or down (layerspp.py:247-310)."""

    def __init__(self, c_in: int, c_out: int, temb: int, zdim: int, dropout: float,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down, self.p = up, down, dropout
        self.GroupNorm_0 = Style(c_in, zdim)
        self.Conv_0 = Affine(c_out, c_in, 3, 3)
        self.Dense_0 = Affine(c_out, temb)
        self.GroupNorm_1 = Style(c_out, zdim)
        self.Dropout_0 = nn.Identity()
        self.Conv_1 = Affine(c_out, c_out, 3, 3)
        if c_in != c_out or up or down:
            self.Conv_2 = Affine(c_out, c_in, 1, 1)

    def run(self, ops: Ops, x, temb, zemb):
        h = F.silu(ada_norm(ops, self.GroupNorm_0, x, zemb))
        if self.up:
            h, x = ops.up2x(h), ops.up2x(x)
        elif self.down:
            h, x = ops.down2x(h), ops.down2x(x)
        h = conv(ops, self.Conv_0, h)
        h = h + ops.linear(F.silu(temb), self.Dense_0.weight, self.Dense_0.bias)[:, :, None, None]
        h = F.silu(ada_norm(ops, self.GroupNorm_1, h, zemb))
        h = ops.dropout(h, self.p, id(self), self.training)
        h = conv(ops, self.Conv_1, h)
        if hasattr(self, "Conv_2"):
            x = conv(ops, self.Conv_2, x)
        return (x + h) / SQRT2


class Attn(nn.Module):
    """Self-attention over the H*W positions (layerspp.py:95-124)."""

    def __init__(self, c: int):
        super().__init__()
        self.GroupNorm_0 = Norm(c)
        self.NIN_0, self.NIN_1, self.NIN_2, self.NIN_3 = (Nin(c, c) for _ in range(4))

    def run(self, ops: Ops, x):
        b, c, hh, ww = x.shape
        n = self.GroupNorm_0
        h = F.group_norm(x, _groups(c), n.weight, n.bias, eps=1e-6)
        h = h.reshape(b, c, hh * ww).transpose(1, 2)
        q, k, v = (ops.matmul(h, m.W) + m.b for m in (self.NIN_0, self.NIN_1, self.NIN_2))
        # the two attention products run in float32 in every precision
        w = torch.softmax(ops.matmul_f32(q, k.transpose(1, 2)) * c ** -0.5, dim=-1)
        h = ops.matmul(ops.matmul_f32(w, v), self.NIN_3.W) + self.NIN_3.b
        return (x + h.transpose(1, 2).reshape(b, c, hh, ww)) / SQRT2


class FirDown(nn.Module):
    """The input pyramid's FIR downsampling 3x3 conv (layerspp.py:162-196)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.Conv2d_0 = Affine(c_out, c_in, 3, 3)


def _supported(cfg: dict) -> None:
    want = {"resblock_type": "biggan", "progressive": "none", "progressive_input": "residual",
            "progressive_combine": "sum", "embedding_type": "positional", "fir": True,
            "resamp_with_conv": True, "conditional": True, "skip_rescale": True,
            "not_use_tanh": False, "centered": True, "fir_kernel": [1, 3, 3, 1]}
    for k, v in want.items():
        if k in cfg and cfg[k] != v:
            raise ValueError(f"the reference generator has {k}={v!r} only, not {cfg[k]!r}")


class Generator(nn.Module):
    """NCSN++ x0-predictor G(x_{t+1}, t, z) of DDGAN, float32 (NCHW)."""

    def __init__(self, cfg: dict):
        super().__init__()
        _supported(cfg)
        nf, mult = cfg["num_channels_dae"], list(cfg["ch_mult"])
        nrb, attn = cfg["num_res_blocks"], set(cfg["attn_resolutions"])
        ch, zdim, size = cfg["num_channels"], cfg["z_emb_dim"], cfg["image_size"]
        self.nf, self.mult, self.nrb, self.attn = nf, mult, nrb, attn
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
            if lvl != 0:
                mods.append(rb(c_in, up=True))
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
                down = next(it).Conv2d_0
                pyramid = ops.conv_down2x(pyramid, down.weight, down.bias)
                pyramid = (pyramid + h) / SQRT2
                hs.append(pyramid)
        h = next(it).run(ops, hs[-1], temb, zemb)
        h = next(it).run(ops, h)
        h = next(it).run(ops, h, temb, zemb)
        for lvl in reversed(range(len(self.mult))):
            for _ in range(self.nrb + 1):
                h = next(it).run(ops, torch.cat([h, hs.pop()], dim=1), temb, zemb)
            if h.shape[3] in self.attn:
                h = next(it).run(ops, h)
            if lvl != 0:
                h = next(it).run(ops, h, temb, zemb)
        norm, head = next(it), next(it)
        h = F.silu(F.group_norm(h, _groups(h.shape[1]), norm.weight, norm.bias, eps=1e-6))
        return torch.tanh(conv(ops, head, h))


# ---------------------------------------------------------------------------
# discriminators
class DownBlock(nn.Module):
    """Residual conv block with t-conditioning and FIR down (discriminator.py:38-94)."""

    def __init__(self, c_in: int, c_out: int, tdim: int, down: bool):
        super().__init__()
        self.down = down
        self.conv1 = nn.Sequential(Affine(c_out, c_in, 3, 3))
        self.conv2 = nn.Sequential(Affine(c_out, c_out, 3, 3))
        self.dense_t1 = Affine(c_out, tdim)
        self.skip = nn.Sequential(Affine(c_out, c_in, 1, 1, bias=False))

    def run(self, ops: Ops, x, temb):
        out = conv(ops, self.conv1[0], F.leaky_relu(x, 0.2), False)
        out = out + ops.linear(temb, self.dense_t1.weight, self.dense_t1.bias)[:, :, None, None]
        out = F.leaky_relu(out, 0.2)
        if self.down:
            out, x = ops.down2x(out), ops.down2x(x)
        out = conv(ops, self.conv2[0], out, False)
        return (out + conv(ops, self.skip[0], x, False)) / SQRT2


class Discriminator(nn.Module):
    """D(x_t | x_{t+1}, t): DiscriminatorSmall (32², 4 blocks) when `small`,
    else DiscriminatorLarge (256², 6 blocks)."""

    def __init__(self, cfg: dict):
        super().__init__()
        ngf, tdim, nc = cfg["ngf"], cfg["t_emb_dim"], 2 * cfg["num_channels"]
        self.tdim = tdim
        small = str(cfg.get("disc_small", "yes")).lower() == "yes"
        if small:
            blocks = [(ngf * 2, ngf * 2, False), (ngf * 2, ngf * 4, True),
                      (ngf * 4, ngf * 8, True), (ngf * 8, ngf * 8, True)]
        else:
            blocks = [(ngf * 2, ngf * 4, True), (ngf * 4, ngf * 8, True)] + [
                (ngf * 8, ngf * 8, True)] * 4
        self.t_embed = nn.Module()
        self.t_embed.main = nn.Sequential(Affine(tdim, tdim), nn.LeakyReLU(0.2),
                                          Affine(tdim, tdim))
        self.start_conv = Affine(ngf * 2, nc, 1, 1)
        self.n = len(blocks)
        for i, (a, b, d) in enumerate(blocks, start=1):
            setattr(self, f"conv{i}", DownBlock(a, b, tdim, d))
        self.final_conv = Affine(ngf * 8, ngf * 8 + 1, 3, 3)
        self.end_linear = Affine(1, ngf * 8)

    def forward(self, ops: Ops, x, t, x_tp1):
        l0, l2 = self.t_embed.main[0], self.t_embed.main[2]
        temb = ops.linear(timestep_embedding(t, self.tdim), l0.weight, l0.bias)
        temb = F.leaky_relu(ops.linear(F.leaky_relu(temb, 0.2), l2.weight, l2.bias), 0.2)
        h = conv(ops, self.start_conv, torch.cat([x, x_tp1], dim=1), False)
        for i in range(1, self.n + 1):
            h = getattr(self, f"conv{i}").run(ops, h, temb)
        h = F.leaky_relu(conv(ops, self.final_conv, minibatch_stddev(h), False), 0.2)
        return ops.linear(h.sum((2, 3)), self.end_linear.weight, self.end_linear.bias).reshape(-1)


def minibatch_stddev(h, group: int = 4):
    """Append the std over groups of rows {j, j + B/g, ...} (biased, + 1e-8
    under the root), averaged over channels and pixels, as a channel."""
    b, c, hh, ww = h.shape
    g = min(b, group)
    s = h.reshape(g, -1, 1, c, hh, ww)
    std = torch.sqrt(s.var(0, unbiased=False) + 1e-8).mean((2, 3, 4), keepdim=True).squeeze(2)
    return torch.cat([h, std.repeat(g, 1, hh, ww)], 1)
