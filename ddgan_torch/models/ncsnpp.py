"""NCSN++ z-conditioned generator (NCHW).

Predicts x0 from (x_{t+1}, t, z). Counterpart of `ddgan_tpu/models/ncsnpp.py`
(reference: score_sde/models/ncsnpp_generator_adagn.py). The modules sit in
one flat `all_modules` list built in the reference's order, and the latent
map is the Sequential `z_transform`, so the state_dict keys are the
reference's (`all_modules.{i}.…`, `z_transform.{2j+1}.…`).

Every option of the JAX package: resblock_type {ddpm, biggan,
biggan_oneadagn}; progressive {none, output_skip, residual};
progressive_input {none, input_skip, residual}; progressive_combine {sum,
cat}; embedding_type {positional, fourier}; FIR or naive resampling, with
or without conv; time conditioning on or off; inputs in [-1, 1] or [0, 1]
(`centered`); the tanh head on or off. The parameter-free pyramid
resamplers of output_skip / input_skip sit outside `all_modules`, as in
the JAX package. Its width-s2d closure is a TPU layout and is not ported:
`from_config` accepts `s2d_conv` and ignores it.

With `use_remat` every resblock call that records a graph runs under a
non-reentrant `torch.utils.checkpoint` (the JAX package's `nn.remat` of
each ResnetBlock, `ddgan_tpu/models/ncsnpp.py:246-272`): its activations
are recomputed in the backward. remat_policy "full" recomputes the whole
block; "save-convs" keeps the outputs of its 3x3 and 1x1 convs
(`nn/layers.conv_out`, the JAX package's `conv_out` names) and recomputes
the rest, so no conv, the gated conv kernel included, runs twice. The
numbers are those of a run without remat, bit for bit: the dropout masks
of the recompute come from the state the block's dropout generator had in
its forward, and the generator is left where the forward left it.

With embedding_type fourier the time embedding is taken of log(t), as in
the JAX package and the reference, so the row of a batch at t = 0 is not
finite.

Spans (`trace.span`, on only while a profiler records): `ddgan.G.embed`,
each level's way down and up (`ddgan.G.down<side>`, `ddgan.G.up<side>`),
`ddgan.G.mid`, `ddgan.G.attn` and `ddgan.G.out`; with the output pyramid
each level's step of it (its head, up2x and sum) is `ddgan.G.skip_out`,
with the input pyramid each transition's (down2x and combine)
`ddgan.G.skip_in`, each counted in `SKIP_STEPS` and by the span counters
`ncsnpp.skip_out` / `ncsnpp.skip_in`.

In bf16, the 3x3 convs of the 128² and 256² levels with 64 output
channels run the gated conv kernel (`ops/pair_conv.py`). In train mode the
dropout masks come from the generator given to `set_dropout_generator`
(the train step hands it its own).
"""

from __future__ import annotations

import contextlib
from typing import Any, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..diffusion.graphed import register_tallies
from ..nn import blocks
from ..nn.layers import (Conv3x3, ConvOutputs, Dense, Linear, PixelNorm, default_init,
                         get_timestep_embedding, saving_conv_outputs)
from ..trace import count, span
from .registry import register_model

RESBLOCK_TYPES = ("ddpm", "biggan", "biggan_oneadagn")
PROGRESSIVE = ("none", "output_skip", "residual")
PROGRESSIVE_INPUT = ("none", "input_skip", "residual")
EMBEDDING_TYPES = ("fourier", "positional")
COMBINE_METHODS = ("sum", "cat")


def _check(name: str, value: str, allowed: tuple) -> None:
    if value not in allowed:
        raise ValueError(f"NCSNpp {name}={value!r} not recognized; expected one of {allowed}")


# Steps of the output and input pyramids (`progressive` "output_skip",
# `progressive_input` "input_skip") since the last reset, counted on every
# device: a level's output head, up2x and sum; a transition's down2x and
# combine. The same steps are the counters of the innermost open span
# (`trace.count`), which lies in the spans `ddgan.G.skip_out` / `.skip_in`.
# A sampler's graph replays count them too (`graphed.register_tallies`).
SKIP_STEPS = {"skip_out": 0, "skip_in": 0}
COUNTERS = {name: f"ncsnpp.{name}" for name in SKIP_STEPS}


def reset_skip_counts() -> None:
    for name in SKIP_STEPS:
        SKIP_STEPS[name] = 0


def _skip_step(name: str) -> None:
    SKIP_STEPS[name] += 1
    count(COUNTERS[name])


register_tallies(lambda: [(SKIP_STEPS, name, COUNTERS[name]) for name in SKIP_STEPS])


REMAT_POLICIES = {"full": "full", "": "full", "save-convs": "save-convs",
                  "save_convs": "save-convs", "convs": "save-convs"}


def resolve_use_remat(config: Any) -> bool:
    """use_remat as `ddgan_tpu/models/ncsnpp.py:100-108` reads it: yes / true
    / 1 (any case) or True turn it on; no, other strings or False keep it
    off. "auto" (the default) is off in the port at every size: on the
    H100 the recipe's bf16 step is slower with remat under either policy
    (PERF.md §5, PR 12, the lsun256 step at batch 8). The JAX package's
    "auto" turns it on at image_size >= 256, from a TPU measurement."""
    raw = getattr(config, "use_remat", "auto")
    if isinstance(raw, str):
        s = raw.lower()
        return False if s == "auto" else s in ("yes", "true", "1")
    return bool(raw)


def resolve_remat_policy(name: str) -> str:
    """"full" or "save-convs", the names the JAX package takes
    (`ncsnpp.py:252-265`); anything else raises. Its $DDGAN_TPU_REMAT_POLICY,
    a knob for A/B runs on the TPU, is not read: the config key is the one
    way to choose."""
    pol = name.lower()
    if pol not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={pol!r} not recognized (expected 'full' or 'save-convs')")
    return REMAT_POLICIES[pol]


class _RematContexts:
    """The forward and recompute contexts of one checkpointed resblock call
    (`torch.utils.checkpoint`'s `context_fn`): the recompute draws its
    dropout masks from the generator states of the forward and puts the
    generators back where they were; under "save-convs" the forward
    records the conv outputs and the recompute replays them."""

    def __init__(self, block: nn.Module, policy: str):
        gens = {}
        for m in block.modules():
            if isinstance(m, blocks.Dropout) and m.training and m.p > 0 and m.generator is not None:
                gens[id(m.generator)] = m.generator
        self.gens = list(gens.values())
        self.convs = ConvOutputs() if policy == "save-convs" else None
        self.states: list = []

    @contextlib.contextmanager
    def forward(self):
        self.states = [g.get_state() for g in self.gens]
        with (saving_conv_outputs(self.convs, replay=False) if self.convs is not None
              else contextlib.nullcontext()):
            yield

    @contextlib.contextmanager
    def recompute(self):
        now = [g.get_state() for g in self.gens]
        for g, st in zip(self.gens, self.states):
            g.set_state(st)
        try:
            with (saving_conv_outputs(self.convs, replay=True) if self.convs is not None
                  else contextlib.nullcontext()):
                yield
        finally:
            for g, st in zip(self.gens, now):
                g.set_state(st)

    def __call__(self):
        return self.forward(), self.recompute()


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
        resamp_with_conv: bool = True,
        image_size: int = 32,
        conditional: bool = True,
        fir: bool = True,
        fir_kernel: Sequence[int] = (1, 3, 3, 1),
        skip_rescale: bool = True,
        resblock_type: str = "biggan",
        progressive: str = "none",
        progressive_input: str = "residual",
        progressive_combine: str = "sum",
        embedding_type: str = "positional",
        fourier_scale: float = 16.0,
        not_use_tanh: bool = False,
        num_channels: int = 3,
        nz: int = 100,
        z_emb_dim: int = 256,
        n_mlp: int = 3,
        centered: bool = True,
        dtype: torch.dtype | None = None,
        use_remat: bool = False,
        remat_policy: str = "full",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.use_remat = bool(use_remat)
        self.remat_policy = resolve_remat_policy(remat_policy) if self.use_remat else None
        _check("resblock_type", resblock_type, RESBLOCK_TYPES)
        _check("progressive", progressive, PROGRESSIVE)
        _check("progressive_input", progressive_input, PROGRESSIVE_INPUT)
        _check("progressive_combine", progressive_combine, COMBINE_METHODS)
        _check("embedding_type", embedding_type, EMBEDDING_TYPES)
        self.nf, self.ch_mult = nf, tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.skip_rescale, self.dtype = skip_rescale, dtype
        self.resblock_type, self.progressive = resblock_type, progressive
        self.progressive_input, self.embedding_type = progressive_input, embedding_type
        self.conditional, self.centered, self.not_use_tanh = conditional, centered, not_use_tanh
        num_resolutions = len(self.ch_mult)
        all_resolutions = [image_size // (2**i) for i in range(num_resolutions)]
        # the span of each level's way down and up (`trace`), by its input side
        self._level_spans = [(f"ddgan.G.down{r}", f"ddgan.G.up{r}") for r in all_resolutions]
        channels = num_channels
        fir_kernel = tuple(fir_kernel)

        # time embedding (reference :96-117)
        modules: list[nn.Module] = []
        embed_dim = nf
        if embedding_type == "fourier":
            modules.append(blocks.GaussianFourierProjection(nf, fourier_scale))
            embed_dim = 2 * nf
        temb_dim = None
        if conditional:
            temb_dim = nf * 4
            modules += [Linear(embed_dim, temb_dim, default_init()),
                        Linear(temb_dim, temb_dim, default_init())]

        def resnet_block(in_ch, out_ch=None, **kw):
            common = dict(temb_dim=temb_dim, zemb_dim=z_emb_dim, dropout=dropout,
                          skip_rescale=skip_rescale, init_scale=0.0, dtype=dtype)
            if resblock_type == "ddpm":
                return blocks.ResnetBlockDDPMppAdagn(in_ch, out_ch, **common, **kw)
            cls = (blocks.ResnetBlockBigGANppAdagn if resblock_type == "biggan"
                   else blocks.ResnetBlockBigGANppAdagnOne)
            return cls(in_ch, out_ch, fir=fir, fir_kernel=fir_kernel, **common, **kw)

        def attn_block(ch):
            return blocks.AttnBlockpp(ch, skip_rescale=skip_rescale, init_scale=0.0, dtype=dtype)

        def resample(cls, in_ch, out_ch, with_conv):
            return cls(in_ch, out_ch, with_conv=with_conv, fir=fir, fir_kernel=fir_kernel,
                       dtype=dtype)

        if progressive == "output_skip":
            self.pyramid_upsample = blocks.Upsample(channels, fir=fir, fir_kernel=fir_kernel)
        if progressive_input == "input_skip":
            self.pyramid_downsample = blocks.Downsample(channels, fir=fir, fir_kernel=fir_kernel)

        # Downsampling (:174-210)
        modules.append(Conv3x3(channels, nf, dtype=dtype))
        hs_c = [nf]
        in_ch = nf
        input_pyramid_ch = channels
        for i_level in range(num_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resnet_block(in_ch, out_ch))
                in_ch = out_ch
                if all_resolutions[i_level] in self.attn_resolutions:
                    modules.append(attn_block(in_ch))
                hs_c.append(in_ch)
            if i_level != num_resolutions - 1:
                if resblock_type == "ddpm":
                    modules.append(resample(blocks.Downsample, in_ch, in_ch, resamp_with_conv))
                else:
                    modules.append(resnet_block(in_ch, down=True))
                if progressive_input == "input_skip":
                    modules.append(blocks.Combine(channels, in_ch, progressive_combine, dtype))
                    if progressive_combine == "cat":
                        in_ch *= 2
                elif progressive_input == "residual":
                    modules.append(resample(blocks.Downsample, input_pyramid_ch, in_ch, True))
                    input_pyramid_ch = in_ch
                hs_c.append(in_ch)

        # middle (:212-215)
        in_ch = hs_c[-1]
        modules += [resnet_block(in_ch), attn_block(in_ch), resnet_block(in_ch)]

        # Upsampling (:217-261)
        pyramid_ch = 0
        for i_level in reversed(range(num_resolutions)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resnet_block(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if all_resolutions[i_level] in self.attn_resolutions:
                modules.append(attn_block(in_ch))
            if progressive != "none":
                top = i_level == num_resolutions - 1
                if progressive == "output_skip":
                    modules.append(blocks.GroupNorm(min(in_ch // 4, 32), in_ch, dtype=dtype))
                    modules.append(Conv3x3(in_ch, channels, init_scale=0.0, dtype=dtype))
                    pyramid_ch = channels
                elif top:  # residual
                    modules.append(blocks.GroupNorm(min(in_ch // 4, 32), in_ch, dtype=dtype))
                    modules.append(Conv3x3(in_ch, in_ch, dtype=dtype))
                    pyramid_ch = in_ch
                else:
                    modules.append(resample(blocks.Upsample, pyramid_ch, in_ch, True))
                    pyramid_ch = in_ch
            if i_level != 0:
                if resblock_type == "ddpm":
                    modules.append(resample(blocks.Upsample, in_ch, in_ch, resamp_with_conv))
                else:
                    modules.append(resnet_block(in_ch, up=True))
        assert not hs_c

        if progressive != "output_skip":
            modules.append(blocks.HeadGroupNorm(min(in_ch // 4, 32), in_ch, dtype=dtype))
            modules.append(Conv3x3(in_ch, channels, init_scale=0.0, dtype=dtype))
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
        """The generator of a config: use_remat as `resolve_use_remat` reads
        it, remat_policy as `resolve_remat_policy`; s2d_conv (a TPU layout of
        the JAX package) is ignored."""
        return cls(
            nf=config.num_channels_dae,
            ch_mult=tuple(config.ch_mult),
            num_res_blocks=config.num_res_blocks,
            attn_resolutions=tuple(config.attn_resolutions),
            dropout=config.dropout,
            resamp_with_conv=bool(config.resamp_with_conv),
            image_size=config.image_size,
            conditional=bool(config.conditional),
            fir=bool(config.fir),
            fir_kernel=tuple(config.fir_kernel),
            skip_rescale=config.skip_rescale,
            resblock_type=str(config.resblock_type).lower(),
            progressive=str(config.progressive).lower(),
            progressive_input=str(config.progressive_input).lower(),
            progressive_combine=str(config.progressive_combine).lower(),
            embedding_type=str(config.embedding_type).lower(),
            fourier_scale=float(config.fourier_scale),
            not_use_tanh=bool(config.not_use_tanh),
            num_channels=config.num_channels,
            nz=config.nz,
            z_emb_dim=config.z_emb_dim,
            n_mlp=config.n_mlp,
            centered=bool(getattr(config, "centered", True)),
            dtype=resolve_compute_dtype(getattr(config, "compute_dtype", "float32")),
            use_remat=resolve_use_remat(config),
            remat_policy=str(getattr(config, "remat_policy", "full")),
            generator=generator,
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

    def _resblock(self, m: nn.Module, h: torch.Tensor, temb, zemb) -> torch.Tensor:
        """A ResnetBlock call, checkpointed under use_remat when it records
        a graph."""
        if not (self.use_remat and torch.is_grad_enabled()):
            return m(h, temb, zemb)
        return torch.utils.checkpoint.checkpoint(
            m, h, temb, zemb, use_reentrant=False,
            context_fn=_RematContexts(m, self.remat_policy))

    def _block(self, m: nn.Module, h: torch.Tensor, temb, zemb) -> torch.Tensor:
        if isinstance(m, (blocks.Upsample, blocks.Downsample)):  # ddpm resampling
            return m(h)
        return self._resblock(m, h, temb, zemb)

    def _skip_sum(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return blocks._rescale(a + b) if self.skip_rescale else a + b

    def forward(self, x: torch.Tensor, time_cond: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        modules = self.all_modules
        dev = x.device
        m_idx = 0
        with span("ddgan.G.embed", dev):
            zemb = self.z_transform(z)
            if self.embedding_type == "fourier":
                temb = modules[m_idx](torch.log(time_cond.to(torch.float32)))
                m_idx += 1
            else:
                temb = get_timestep_embedding(time_cond, self.nf)
            if self.conditional:
                temb = modules[m_idx](temb)
                temb = modules[m_idx + 1](F.silu(temb))
                m_idx += 2
            else:
                temb = None

        num_resolutions = len(self.ch_mult)
        for i_level in range(num_resolutions):
            with span(self._level_spans[i_level][0], dev):
                if i_level == 0:
                    if not self.centered:
                        x = 2 * x - 1.0  # input in [0, 1]
                    if self.dtype is not None:
                        x = x.to(self.dtype)
                    input_pyramid = x
                    hs = [modules[m_idx](x)]
                    m_idx += 1
                for _ in range(self.num_res_blocks):
                    h = self._resblock(modules[m_idx], hs[-1], temb, zemb)
                    m_idx += 1
                    # resolution test on the W axis, as the JAX package's NHWC shape[2]
                    if h.shape[3] in self.attn_resolutions:
                        with span("ddgan.G.attn", dev):
                            h = modules[m_idx](h)
                        m_idx += 1
                    hs.append(h)
                if i_level != num_resolutions - 1:
                    h = self._block(modules[m_idx], hs[-1], temb, zemb)
                    m_idx += 1
                    if self.progressive_input == "input_skip":
                        with span("ddgan.G.skip_in", dev):
                            input_pyramid = self.pyramid_downsample(input_pyramid)
                            h = modules[m_idx](input_pyramid, h)
                            _skip_step("skip_in")
                        m_idx += 1
                    elif self.progressive_input == "residual":
                        input_pyramid = modules[m_idx](input_pyramid)
                        m_idx += 1
                        input_pyramid = self._skip_sum(input_pyramid, h)
                        h = input_pyramid
                    hs.append(h)

        with span("ddgan.G.mid", dev):
            h = hs[-1]
            h = self._resblock(modules[m_idx], h, temb, zemb)
            with span("ddgan.G.attn", dev):
                h = modules[m_idx + 1](h)
            h = self._resblock(modules[m_idx + 2], h, temb, zemb)
            m_idx += 3

        pyramid = None
        for i_level in reversed(range(num_resolutions)):
            with span(self._level_spans[i_level][1], dev):
                for _ in range(self.num_res_blocks + 1):
                    h = self._resblock(modules[m_idx], torch.cat([h, hs.pop()], dim=1), temb,
                                       zemb)
                    m_idx += 1
                if h.shape[3] in self.attn_resolutions:
                    with span("ddgan.G.attn", dev):
                        h = modules[m_idx](h)
                    m_idx += 1
                if self.progressive == "output_skip":
                    with span("ddgan.G.skip_out", dev):
                        pyramid_h = modules[m_idx + 1](F.silu(modules[m_idx](h)))
                        pyramid = (pyramid_h if pyramid is None
                                   else self.pyramid_upsample(pyramid) + pyramid_h)
                        _skip_step("skip_out")
                    m_idx += 2
                elif self.progressive == "residual":
                    if i_level == num_resolutions - 1:
                        pyramid = modules[m_idx + 1](F.silu(modules[m_idx](h)))
                        m_idx += 2
                    else:
                        pyramid = self._skip_sum(modules[m_idx](pyramid), h)
                        m_idx += 1
                        h = pyramid
                if i_level != 0:
                    h = self._block(modules[m_idx], h, temb, zemb)
                    m_idx += 1
        assert not hs

        with span("ddgan.G.out", dev):
            if self.progressive == "output_skip":
                h = pyramid
            else:
                h = modules[m_idx + 1](F.silu(modules[m_idx](h)))
                m_idx += 2
            assert m_idx == len(modules)
            h = h.to(torch.float32)
            return h if self.not_use_tanh else torch.tanh(h)
