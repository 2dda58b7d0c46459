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
fallback. The kernel reads the live weight (float32 or bfloat16) and
rounds it to bf16 itself, so a call launches the kernel and nothing else;
its grid and ring depth come from `launch_plan`.

The backward mirrors the JAX package's custom VJP (`_bwd` :208-226):

  * dx, only when x needs it: the same conv of the cotangent g with w
    flipped spatially and its in/out axes swapped, zero bias. When that
    conv passes `supported` (C_in 64, so the swapped weights have 64
    outputs) it goes through this Function with `flip` set and no bias,
    so through the kernel on the GPU, which flips and swaps the weight
    while it packs it; otherwise (C_in 128) it is the library's bf16 conv,
    as JAX's `_ref_conv`;
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

from .. import trace
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
# the same calls as counters of the innermost open span (`trace.count`)
COUNTERS = {role: f"pair_conv3x3.{role}" for role in CALLS}

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


def flipped(w: torch.Tensor) -> torch.Tensor:
    """The VJP's weight: w flipped spatially, in/out axes swapped (a view)."""
    return w.flip(2, 3).transpose(0, 1)


def pair_conv3x3_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                     flip: bool = False) -> torch.Tensor:
    """f32 conv of the bf16-rounded x and w (`flipped(w)` with `flip`), plus
    the f32 bias (none if `b` is None), rounded once."""
    xf = x.to(torch.bfloat16).float()
    wf = (flipped(w) if flip else w).to(torch.bfloat16).float()
    y = F.conv2d(xf, wf, padding=1)
    if b is not None:
        y = y + b.float().reshape(1, -1, 1, 1)
    return y.to(torch.bfloat16)


# The kernel's tiles and shared memory (csrc/pair_conv3x3.cu): a stage is 6
# input rows x 16 channels x 64 columns of bf16 at each of kx = 0, 1, 2 and
# two halo blocks of 8 columns, with three mbarriers; the packed weights are
# one 64 x 64 bf16 tile per tap and 64 input channels; a block may use 227 KB.
_SMEM_LIMIT = 232448
_STAGE_BYTES = 3 * 6 * 16 * 64 * 2 + 2 * 16 * 6 * 8 * 2
_STAGE_BARRIER_BYTES = 24
_WEIGHT_TILE_BYTES = 64 * 64 * 2


def launch_plan(x_shape, sm_count: int) -> dict:
    """The kernel's launch for an NCHW input: output tiles of 4 rows x 64
    columns, a persistent grid of one block per SM (at most one per tile),
    and as many stages in the ring as fit in the shared memory beside the
    packed weights and 1024 bytes of alignment slack: 3 at C_in <= 64, 2 at
    C_in 128."""
    n, c, h, w = x_shape
    weight_bytes = 9 * -(-c // 64) * _WEIGHT_TILE_BYTES
    per_stage = _STAGE_BYTES + _STAGE_BARRIER_BYTES
    stages = (_SMEM_LIMIT - 1024 - weight_bytes) // per_stage
    tiles = n * (h // 4) * -(-w // 64)
    return {"tiles": tiles, "grid": min(tiles, sm_count), "stages": stages,
            "smem_bytes": 1024 + weight_bytes + stages * per_stage}


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library (`_nvcc.build`)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _nvcc.build("pair_conv3x3.cu", verbose)
    fn = lib.ddgan_pair_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, flip: bool) -> None:
    w_shape = tuple(w.shape)
    if flip and len(w_shape) == 4:
        w_shape = (w_shape[1], w_shape[0]) + w_shape[2:]
    if not supported(tuple(x.shape), w_shape, x.dtype):
        raise ValueError(
            f"pair_conv3x3: x {tuple(x.shape)} {x.dtype} with w {w_shape} is outside "
            "the kernel's gate (`supported`)"
        )
    if b is not None and tuple(b.shape) != (C_OUT,):
        raise ValueError(f"pair_conv3x3: bias must have shape ({C_OUT},), got {tuple(b.shape)}")
    if not x.is_contiguous():
        raise ValueError("pair_conv3x3: input must be contiguous (NCHW)")
    if x.device != w.device or (b is not None and x.device != b.device):
        raise ValueError(f"pair_conv3x3: x, w and b on {x.device}, {w.device}, "
                         f"{None if b is None else b.device}")


_SM_COUNT: dict = {}


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
          flip: bool = False) -> torch.Tensor:
    """The checked conv: the kernel on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return pair_conv3x3_ref(x, w, b, flip)
    if x.device.type != "cuda":
        raise RuntimeError(f"pair_conv3x3: kernel needs a CUDA tensor, got {x.device}")
    n, c, h, wd = x.shape
    # the kernel rounds an f32 or bf16 weight itself; these are no-ops for the
    # model's parameters (contiguous f32) and bias (f32)
    wk = w.detach()
    if wk.dtype not in (torch.float32, torch.bfloat16):
        wk = wk.float()
    wk = wk.contiguous()
    bk = None if b is None else b.detach().to(torch.float32).contiguous()
    y = torch.empty((n, C_OUT, h, wd), device=x.device, dtype=torch.bfloat16)
    if n == 0:
        return y
    if x.numel() >= 2**31 or y.numel() >= 2**31:
        raise ValueError(f"pair_conv3x3: {tuple(x.shape)} is too large for the kernel's indexing")
    if any(t.data_ptr() % 16 for t in (x, y)):
        raise ValueError("pair_conv3x3: x and y must be 16-byte aligned")
    lib = build()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_plan(x.shape, _SM_COUNT[dev])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ddgan_pair_conv3x3(
            x.data_ptr(), wk.data_ptr(), 0 if bk is None else bk.data_ptr(), y.data_ptr(),
            n, c, h, wd, int(wk.dtype == torch.bfloat16), int(flip), plan["stages"],
            plan["smem_bytes"], plan["grid"], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"pair_conv3x3: kernel launch failed with error {err} (CUDA's own codes; 10001: no "
            "cuTensorMapEncodeTiled; 20000 / 30000 + a CUresult: the tile / halo map refused; "
            f"x at {x.data_ptr():#x}, shape {tuple(x.shape)})")
    LAUNCHES["pair_conv3x3"] += 1
    return y


class _PairConv3x3(torch.autograd.Function):
    """The conv of x with w (with `flipped(w)` when `flip`) plus b."""

    @staticmethod
    def forward(ctx, x, w, b, role, flip):
        y = _conv(x, w, b, flip)
        CALLS[role] += 1
        trace.count(COUNTERS[role])
        ctx.flip = flip
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        # the conv's own weight (64, C_in, 3, 3); its VJP's weight is w when
        # the conv was itself a flipped one
        w_conv = flipped(w) if ctx.flip else w
        if ctx.needs_input_grad[0]:
            w_vjp_shape = (w_conv.shape[1], w_conv.shape[0], 3, 3)
            if supported(tuple(g.shape), w_vjp_shape, g.dtype):
                dx = _apply(g, w, None, "dx", not ctx.flip)
            else:
                w_vjp = w if ctx.flip else flipped(w)
                dx = F.conv2d(g, w_vjp.to(g.dtype), padding=1)
                CALLS["dx_library"] += 1
                trace.count(COUNTERS["dx_library"])
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                x.to(torch.bfloat16), w_conv.shape, g.to(torch.bfloat16), padding=1
            ).to(w.dtype)
            if ctx.flip:
                dw = flipped(dw)
        if ctx.needs_input_grad[2]:
            db = g.float().sum((0, 2, 3))
        return dx, dw, db, None, None


def _apply(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, role: str,
           flip: bool = False) -> torch.Tensor:
    _check(x, w, b, flip)
    return _PairConv3x3.apply(x, w, b, role, flip)


def pair_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 same-pad conv plus bias (x NCHW bf16, w OIHW, b (64,)) -> NCHW
    bf16, differentiable in x, w and b: the kernel on CUDA, the plain
    version on CPU."""
    return _apply(x, w, b, "forward")
