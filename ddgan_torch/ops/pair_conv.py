"""The gated 3x3 conv of the narrow 256x256 levels (K2), as a CUDA kernel
and as plain PyTorch.

Counterpart of `ddgan_tpu/ops/experimental/pallas_conv.py` (`supported`
:67, `pair_conv3x3` :189, kernel `_pair_kernel` :104). It computes a 3x3
stride-1 same-pad conv plus bias, NCHW x OIHW: x and w rounded to
bfloat16, products summed in float32, the float32 bias added to the sum,
and one rounding of the result to bfloat16.

`pair_conv3x3_ref` is the plain version. `pair_conv3x3` checks its inputs
on every device and raises on what the kernel does not take: a shape or
dtype outside `supported`, or a non-contiguous input. Then it applies a
`torch.autograd.Function` whose forward launches the hand-written kernel
of `csrc/pair_conv3x3.cu` on a CUDA tensor and runs the plain version on a
CPU tensor. The kernel is built with nvcc for sm_90a at first use
(`_nvcc.build`); a build or launch failure raises, and there is no
fallback.

The backward mirrors the JAX package's custom VJP (`_bwd` :208-226):

  * dx, only when x needs it: the same conv of the cotangent g with w
    flipped spatially and its in/out axes swapped, zero bias. When that
    conv passes `supported` (C_in 64, so the swapped weights have 64
    outputs) it goes through this Function, so through the kernel on the
    GPU; otherwise (C_in 128) it is the library's bf16 conv, as JAX's
    `_ref_conv`;
  * dW: the library's weight gradient of the bf16 conv of x and g, cast
    to float32, as JAX's vjp of `_ref_conv` in the activation dtype;
  * db: the sum of g in float32.

On the GPU the plain version is a float32 `F.conv2d`, which cuDNN runs in
TF32 unless `torch.backends.cudnn.allow_tf32` is False: compare the kernel
with it only with TF32 off.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _nvcc

C_OUT = 64

# Launches of the kernel since the last reset; a run reads this to show
# that its path went through the kernel.
LAUNCHES = {"pair_conv3x3": 0}
# Routed calls by role, counted on every device once the call has
# returned: "forward" and "dx" go through the kernel's route (on a CUDA
# tensor each is a launch), "dx_library" is a dx that the gate sends to
# the library conv.
CALLS = {"forward": 0, "dx": 0, "dx_library": 0}

_lib = None


def reset_launch_counts() -> None:
    LAUNCHES["pair_conv3x3"] = 0
    for role in CALLS:
        CALLS[role] = 0


def supported(x_shape, w_shape, dtype) -> bool:
    """The JAX package's gate (`pallas_conv.supported`) in NCHW / OIHW terms:
    a 3x3 kernel, C_out 64, even C_in <= 128, square maps of side >= 128
    and a multiple of 32, bfloat16."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    _, c, h, w = x_shape
    co, ci, kh, kw = w_shape
    return (
        (kh, kw) == (3, 3)
        and ci == c
        and co == C_OUT
        and c % 2 == 0
        and c <= 128
        and h == w
        and h >= 128
        and h % 32 == 0
        and dtype == torch.bfloat16
    )


def pair_conv3x3_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 conv of the bf16-rounded x and w, plus the f32 bias, rounded once."""
    xf = x.to(torch.bfloat16).float()
    wf = w.to(torch.bfloat16).float()
    y = F.conv2d(xf, wf, padding=1) + b.float().reshape(1, -1, 1, 1)
    return y.to(torch.bfloat16)


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library (`_nvcc.build`)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _nvcc.build("pair_conv3x3.cu", verbose)
    fn = lib.ddgan_pair_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if not supported(tuple(x.shape), tuple(w.shape), x.dtype):
        raise ValueError(
            f"pair_conv3x3: x {tuple(x.shape)} {x.dtype} with w {tuple(w.shape)} is outside "
            "the kernel's gate (`supported`)"
        )
    if tuple(b.shape) != (C_OUT,):
        raise ValueError(f"pair_conv3x3: bias must have shape ({C_OUT},), got {tuple(b.shape)}")
    if not x.is_contiguous():
        raise ValueError("pair_conv3x3: input must be contiguous (NCHW)")
    if x.device != w.device or x.device != b.device:
        raise ValueError(f"pair_conv3x3: x, w and b on {x.device}, {w.device}, {b.device}")


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The checked conv: the kernel on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return pair_conv3x3_ref(x, w, b)
    if x.device.type != "cuda":
        raise RuntimeError(f"pair_conv3x3: kernel needs a CUDA tensor, got {x.device}")
    n, c, h, wd = x.shape
    wb = w.detach().to(torch.bfloat16).contiguous()
    bb = b.detach().to(torch.float32).contiguous()
    y = torch.empty((n, C_OUT, h, wd), device=x.device, dtype=torch.bfloat16)
    if n == 0:
        return y
    if x.numel() >= 2**31 or y.numel() >= 2**31 or n > 65535:
        raise ValueError(f"pair_conv3x3: {tuple(x.shape)} is too large for the kernel's grid")
    if any(t.data_ptr() % 16 for t in (x, wb, y)):
        raise ValueError("pair_conv3x3: x, w and y must be 16-byte aligned")
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ddgan_pair_conv3x3(
            x.data_ptr(), wb.data_ptr(), bb.data_ptr(), y.data_ptr(), n, c, h, wd, stream
        )
    if err != 0:
        raise RuntimeError(f"pair_conv3x3: kernel launch failed with CUDA error {err}")
    LAUNCHES["pair_conv3x3"] += 1
    return y


class _PairConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, role):
        y = _conv(x, w, b)
        CALLS[role] += 1
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            w_flip = w.flip(2, 3).transpose(0, 1)  # (C_in, 64, 3, 3)
            if supported(tuple(g.shape), tuple(w_flip.shape), g.dtype):
                zeros = torch.zeros(w_flip.shape[0], device=g.device, dtype=torch.float32)
                dx = _apply(g, w_flip, zeros, "dx")
            else:
                dx = F.conv2d(g, w_flip.to(g.dtype), padding=1)
                CALLS["dx_library"] += 1
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                x.to(torch.bfloat16), w.shape, g.to(torch.bfloat16), padding=1
            ).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.float().sum((0, 2, 3))
        return dx, dw, db, None


def _apply(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, role: str) -> torch.Tensor:
    _check(x, w, b)
    return _PairConv3x3.apply(x, w, b, role)


def pair_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 same-pad conv plus bias (x NCHW bf16, w OIHW, b (64,)) -> NCHW
    bf16, differentiable in x, w and b: the kernel on CUDA, the plain
    version on CPU."""
    return _apply(x, w, b, "forward")
