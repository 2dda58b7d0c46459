"""Shared primitives: initializers, dense/conv layers, embeddings (NCHW).

Counterpart of `ddgan_tpu/nn/layers.py`. Its width-s2d path is a TPU
layout of the same math and is not ported. Its paired-pixel path is the
Pallas kernel `pair_conv3x3`: `Conv3x3` sends the convs that pass its gate
to the port's kernel (`ops/pair_conv.py`). Parameter names and shapes are
the reference torch model's, so `load_state_dict` takes a reference `.pth`:

  * `default_init` — variance_scaling(fan_avg, uniform), scale 0 mapped
    to 1e-10 (score_sde/models/layers.py:101-105).
  * `dense_init` — the reference dense_layer init with its fan_avg →
    fan_out quirk: uniform(±sqrt(3*scale/fan_out)) (dense_layer.py:23-66).

Every layer takes a compute `dtype` (None or torch.bfloat16): its input and
parameters are cast to it, while the parameters themselves stay float32.
With dtype None the layer computes in the promoted type of its input and
parameters, as flax does.

While a resblock checkpointed with remat_policy "save-convs"
(`models/ncsnpp.py`) runs, the 3x3 and 1x1 convs hand their outputs to
`conv_out`, the counterpart of the JAX package's `name_conv_out` tag
(`ddgan_tpu/nn/layers.py:36`): it keeps each conv's output in the forward
and gives it back in the recompute, so that no conv runs twice, the
hand-written kernel's included. Outside such a block a conv calls its
function directly.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import pair_conv

# init(tensor, fan_in, fan_out, generator) fills `tensor` in place
Initializer = Callable[[torch.Tensor, int, int, "torch.Generator | None"], torch.Tensor]


def _variance_scaling_uniform(scale: float, mode: str) -> Initializer:
    scale = 1e-10 if scale == 0 else scale

    @torch.no_grad()
    def init(t, fan_in, fan_out, generator=None):
        fan = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2.0}[mode]
        bound = math.sqrt(3.0 * scale / fan)
        return t.uniform_(-bound, bound, generator=generator)

    return init


def default_init(scale: float = 1.0) -> Initializer:
    """DDPM initializer: variance_scaling(scale, fan_avg, uniform); 0 → 1e-10."""
    return _variance_scaling_uniform(scale, "fan_avg")


def dense_init(scale: float = 1.0) -> Initializer:
    """dense_layer.py init — uniform(±sqrt(3*scale/fan_out)); 0 → 1e-10."""
    return _variance_scaling_uniform(scale, "fan_out")


def compute_dtype(x: torch.Tensor, param: torch.Tensor, dtype) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, param.dtype)


class ConvOutputs:
    """The conv outputs of one checkpointed call, in call order: appended by
    the forward, handed back (and dropped) one by one by the recompute."""

    def __init__(self):
        self.outs: list = []
        self.next = 0
        self.replay = False


_CONV_OUTPUTS = threading.local()  # the recompute runs on autograd's thread
# `saving_conv_outputs` contexts open on any thread; while it is 0 the convs
# skip `conv_out`. A conv on a thread without a store of its own computes in
# `conv_out` as usual.
_SAVING = 0
_SAVING_LOCK = threading.Lock()


@contextlib.contextmanager
def saving_conv_outputs(store: ConvOutputs, replay: bool):
    """Within it, `conv_out` appends to `store` or, with `replay`, takes
    from it."""
    global _SAVING
    prev = getattr(_CONV_OUTPUTS, "store", None)
    store.replay, store.next = replay, 0
    _CONV_OUTPUTS.store = store
    with _SAVING_LOCK:
        _SAVING += 1
    try:
        yield store
    finally:
        with _SAVING_LOCK:
            _SAVING -= 1
        _CONV_OUTPUTS.store = prev


class _Output:
    def __init__(self, y: torch.Tensor):
        self.y = y


class _SavedConvOutput(torch.autograd.Function):
    """A conv's recorded output, saving what the conv saves (its input and
    weight, in the order the conv saves them) so that a non-reentrant
    checkpoint's recompute packs the tensors the original graph's conv node
    unpacks. That graph does the backward: this node's never runs."""

    @staticmethod
    def forward(ctx, out, *saved):
        ctx.save_for_backward(*saved)
        return out.y

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("a recompute's saved conv output was differentiated; only the "
                           "checkpointed forward's graph is")


def conv_out(compute: Callable[[], torch.Tensor], *saved: torch.Tensor) -> torch.Tensor:
    """`compute()`, the output of a conv that saves `saved` for its backward;
    under `saving_conv_outputs` recorded, or replayed without computing."""
    store = getattr(_CONV_OUTPUTS, "store", None)
    if store is None:
        return compute()
    if store.replay:
        y, store.outs[store.next] = store.outs[store.next], None
        store.next += 1
        return _SavedConvOutput.apply(_Output(y), *saved)
    y = compute()
    store.outs.append(y.detach())
    return y


def get_timestep_embedding(
    timesteps: torch.Tensor, embedding_dim: int, max_positions: int = 10000
) -> torch.Tensor:
    """Sinusoidal positional embedding, cat(sin, cos). (layers.py:475-486)"""
    assert timesteps.ndim == 1
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -emb
    )
    emb = timesteps.to(torch.float32)[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class Linear(nn.Module):
    """Linear layer, weight (out, in); `init` defaults to dense_init(1).

    `bias_init(bias)` fills the bias in place (zeros by default), as flax's
    `Dense(bias_init=)`: the layer that owns a parameter sets it, so a
    model-level `init_weights` walk draws each weight once and keeps every
    constant."""

    def __init__(self, in_features: int, out_features: int, init: Initializer | None = None,
                 use_bias: bool = True, dtype=None,
                 bias_init: Callable[[torch.Tensor], object] | None = None):
        super().__init__()
        self.dtype = dtype
        self._init = init or dense_init(1.0)
        self._bias_init = bias_init or nn.init.zeros_
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.init_weights()

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        out_f, in_f = self.weight.shape
        self._init(self.weight, in_f, out_f, generator)
        if self.bias is not None:
            with torch.no_grad():
                self._bias_init(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x, self.weight, self.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Dense(Linear):
    """Linear with the reference dense_layer init (dense_init(init_scale))."""

    def __init__(self, in_features: int, out_features: int, init_scale: float = 1.0,
                 use_bias: bool = True, dtype=None):
        super().__init__(in_features, out_features, dense_init(init_scale), use_bias, dtype)


class Conv2d(nn.Module):
    """Conv2d, weight OIHW with `init`, zero bias, compute dtype as above."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, use_bias: bool = True,
                 init: Initializer | None = None, dtype=None):
        super().__init__()
        self.stride, self.padding, self.dilation, self.dtype = stride, padding, dilation, dtype
        self._init = init or default_init(1.0)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        self.init_weights()

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        out_ch, in_ch, kh, kw = self.weight.shape
        self._init(self.weight, in_ch * kh * kw, out_ch * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x, self.weight, self.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        if not _SAVING:
            return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride, self.padding,
                            self.dilation)
        xd, wd = x.to(dt), self.weight.to(dt)
        return conv_out(lambda: F.conv2d(xd, wd, b, self.stride, self.padding, self.dilation),
                        xd, wd)


class Conv3x3(Conv2d):
    """ddpm_conv3x3: 3x3 conv, default_init(init_scale), zero bias. (layers.py:131-138)

    A bf16 conv with stride, padding and dilation 1 and a bias whose shapes
    pass `pair_conv.supported` (C_out 64 on the 128² and 256² maps) runs
    `pair_conv.pair_conv3x3` on the live weight and bias, the hand-written
    kernel on the GPU, with its VJP: the JAX package's path under
    DDGAN_TPU_PALLAS_CONV=1 (`ddgan_tpu/nn/layers.py:285-302`). Every other
    conv is `F.conv2d`.
    """

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, use_bias: bool = True,
                 dilation: int = 1, init_scale: float = 1.0, padding: int = 1, dtype=None):
        super().__init__(in_ch, out_ch, 3, stride, padding, dilation, use_bias,
                         default_init(init_scale), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (
            self.dtype == torch.bfloat16
            and self.stride == 1
            and self.padding == 1
            and self.dilation == 1
            and self.bias is not None
            and pair_conv.supported(x.shape, self.weight.shape, torch.bfloat16)
        ):
            if not _SAVING:
                return pair_conv.pair_conv3x3(x.to(torch.bfloat16), self.weight, self.bias)
            xb = x.to(torch.bfloat16)
            return conv_out(lambda: pair_conv.pair_conv3x3(xb, self.weight, self.bias),
                            xb, self.weight)
        return super().forward(x)


class ConvLayer(Conv2d):
    """Conv2d with the reference dense_layer init (dense_layer.py:69-80) and
    zero bias: the discriminators' conv (`ddgan_tpu/nn/layers.py:99-125`).
    It never routes to the gated conv kernel, as in the JAX package."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, use_bias: bool = True, init_scale: float = 1.0, dtype=None):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding, 1, use_bias,
                         dense_init(init_scale), dtype)


class Conv1x1(Conv2d):
    """ddpm_conv1x1: 1x1 conv, default_init(init_scale), zero bias. (layers.py:114-120)"""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, use_bias: bool = True,
                 init_scale: float = 1.0, padding: int = 0, dtype=None):
        super().__init__(in_ch, out_ch, 1, stride, padding, 1, use_bias,
                         default_init(init_scale), dtype)


class NIN(nn.Module):
    """1x1 channel mixing through a (C_in, C_out) matrix W and bias b.
    (layers.py:489-512)"""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1, dtype=None):
        super().__init__()
        self.dtype = dtype
        self._init = default_init(init_scale)
        self.W = nn.Parameter(torch.empty(in_dim, num_units))
        self.b = nn.Parameter(torch.zeros(num_units))
        self.init_weights()

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        in_dim, units = self.W.shape
        self._init(self.W, in_dim, units, generator)
        nn.init.zeros_(self.b)

    def channels_last(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., C_in) → (..., C_out)."""
        dt = compute_dtype(x, self.W, self.dtype)
        return torch.matmul(x.to(dt), self.W.to(dt)) + self.b.to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C_in, H, W) → (N, C_out, H, W)."""
        return self.channels_last(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class PixelNorm(nn.Module):
    """x / sqrt(mean(x^2, dim=1) + 1e-8). (ncsnpp_generator_adagn.py:51-56)"""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(torch.mean(x**2, dim=1, keepdim=True) + 1e-8)
