"""The arithmetic every layer of the plain reference goes through.

`Ops` holds what a run may change about it, so that the networks stay plain
code:

  * `precision`: None computes every product in float32 (TF32 must be off:
    `strict_float32`); "fp8" rounds the operands and the output of every
    convolution and linear map (the products the configurations compute in
    bfloat16) to float8 e4m3 with one scale per tensor (its largest
    magnitude at 448): the precision below bfloat16. The rounding is passed
    straight through in the backward, so a training step runs on the
    rounded values.
  * `recorder`: a `WorkRecorder` (`benchmark/work/`) that is told of every
    FIR resample and 3x3 convolution, with its shape and its order of
    differentiation; the FIR resamples then run as autograd Functions
    whose backward is the other pattern, as a hand-written kernel's would.
  * the dropout masks: `begin_masks(batch)` starts the forwards of a batch
    of `batch` rows, and `use_rows(rows)` names the rows (indices into the
    batch) that the next forwards see. Each dropout draws its mask for the
    whole batch at its first call, from the generator, as
    `torch.rand(shape) >= p` of the full shape, so a batch run in chunks
    draws what it draws in one piece, in layer order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def strict_float32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor, in x's dtype;
    the gradient passes through unchanged."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def upfirdn2d(x: torch.Tensor, k2d: torch.Tensor, up: int, down: int, pad0: int,
              pad1: int) -> torch.Tensor:
    """Zero-stuff by `up`, pad by (pad0, pad1) on both axes, convolve with
    `k2d` (a true convolution), keep every `down`-th sample; depthwise."""
    n, c, h, w = x.shape
    if up > 1:
        s = x.new_zeros((n, c, h * up, w * up))
        s[:, :, ::up, ::up] = x
        x = s
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    kh, kw = k2d.shape
    weight = torch.flip(k2d, (0, 1)).to(x).reshape(1, 1, kh, kw).expand(c, 1, kh, kw)
    return F.conv2d(x, weight, stride=down, groups=c)


def fir_taps(k, gain: float) -> torch.Tensor:
    """outer(k, k) / sum(outer(k, k)) * gain, float32."""
    k = np.asarray(k, np.float64)
    k2 = np.outer(k, k)
    return torch.from_numpy((k2 / k2.sum() * gain).astype(np.float32))


def _outer(k1d) -> torch.Tensor:
    return torch.from_numpy(np.outer(k1d, k1d).astype(np.float32))


def _down2x_plain(x, k1d):
    """The 2x FIR downsample, pad (1, 1), separable taps `k1d`."""
    return upfirdn2d(x, _outer(k1d), 1, 2, 1, 1)


def _up2x_plain(x, k1d):
    """The 2x FIR upsample, pad (2, 1), separable taps `k1d`."""
    return upfirdn2d(x, _outer(k1d), 2, 1, 2, 1)


class _Fir(torch.autograd.Function):
    """A recorded 2x FIR resample whose backward is the other pattern with
    the taps reversed, itself recorded and differentiable."""

    @staticmethod
    def forward(ctx, x, name, k1d, order, recorder):
        ctx.name, ctx.k1d, ctx.order, ctx.recorder = name, k1d, order, recorder
        recorder.fir(name, tuple(x.shape), order)
        return (_down2x_plain if name == "down2x" else _up2x_plain)(x, k1d)

    @staticmethod
    def backward(ctx, g):
        other = "up2x" if ctx.name == "down2x" else "down2x"
        return (_Fir.apply(g.contiguous(), other, ctx.k1d[::-1], ctx.order + 1, ctx.recorder),
                None, None, None, None)


class Ops:
    def __init__(self, precision: str | None = None, recorder=None,
                 generator: torch.Generator | None = None):
        if precision not in (None, "fp8"):
            raise ValueError(f"precision {precision!r}: expected None or 'fp8'")
        self.precision, self.recorder, self.generator = precision, recorder, generator
        self._masks: dict[int, torch.Tensor] = {}
        self._rows: torch.Tensor | None = None
        self._batch = 0

    # ---- products
    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.precision == "fp8" else x

    def conv2d(self, x, w, b=None, stride=1, padding=0, gated=False):
        """F.conv2d; a `gated` 3x3 same conv at stride 1 is told to the
        recorder."""
        if self.recorder is not None and gated and w.shape[2:] == (3, 3) and stride == 1:
            self.recorder.conv3x3(tuple(x.shape), tuple(w.shape), x.requires_grad)
        return self._q(F.conv2d(self._q(x), self._q(w), b, stride, padding))

    def linear(self, x, w, b=None):
        return self._q(F.linear(self._q(x), self._q(w), b))

    def matmul(self, a, b):
        return self._q(torch.matmul(self._q(a), self._q(b)))

    def matmul_f32(self, a, b):
        """A product that runs in float32 in every precision (attention's)."""
        return torch.matmul(a, b)

    # ---- FIR resampling (4 separable taps, factor 2)
    def down2x(self, x, k=(1, 3, 3, 1)):
        k1d = tuple(float(v) for v in np.asarray(k, np.float64) / np.sum(k))
        if self.recorder is not None:
            return _Fir.apply(x, "down2x", k1d, 0, self.recorder)
        return _down2x_plain(x, k1d)

    def up2x(self, x, k=(1, 3, 3, 1)):
        k1d = tuple(float(v) for v in np.asarray(k, np.float64) / np.sum(k) * 2.0)
        if self.recorder is not None:
            return _Fir.apply(x, "up2x", k1d, 0, self.recorder)
        return _up2x_plain(x, k1d)

    def conv_down2x(self, x, w, b, k=(1, 3, 3, 1)):
        """3x3 conv at stride 2 after the FIR blur (pad 2, 2): the FIR
        downsampling conv of a progressive input."""
        x = upfirdn2d(x, fir_taps(k, 1.0), 1, 1, 2, 2)
        return self.conv2d(x, w, b, stride=2)

    # ---- dropout
    def begin_masks(self, batch: int) -> None:
        """Start the forwards of one batch of `batch` rows: the first layer
        call of each dropout draws its mask for the whole batch."""
        self._masks, self._batch, self._rows = {}, batch, None

    def use_rows(self, rows) -> None:
        """The rows of the batch that the next forwards see: an index
        tensor or a slice (None: all)."""
        self._rows = rows

    def dropout(self, x: torch.Tensor, p: float, key: int, training: bool) -> torch.Tensor:
        if not training or p == 0.0:
            return x
        if key not in self._masks:
            shape = (self._batch,) + tuple(x.shape[1:])
            self._masks[key] = torch.rand(shape, generator=self.generator, device=x.device) >= p
        keep = self._masks[key]
        if self._rows is not None:
            keep = keep[self._rows]
        return torch.where(keep, x / (1.0 - p), 0.0)


def timestep_embedding(t: torch.Tensor, dim: int, max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding cat(sin, cos) of t (DDPM)."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * -(math.log(max_positions) / (half - 1)))
    arg = t.to(torch.float32)[:, None] * freq[None]
    emb = torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb
