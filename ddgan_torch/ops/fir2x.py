"""The 2x separable FIR resample, as a CUDA kernel and as plain PyTorch.

Counterpart of `ddgan_tpu/ops/experimental/pallas_upfirdn.py` (`down2x`
:133, `up2x` :158, kernel `_sep_mxu_kernel` :56). Two patterns of
upfirdn2d with the 2-D kernel outer(k1d, k1d), 4 taps:

  * down2x: up=1, down=2, pad=(1,1)  (N, C, H, W) -> (N, C, H/2, W/2), H, W even
  * up2x:   up=2, down=1, pad=(2,1)  (N, C, H, W) -> (N, C, 2H, 2W), any H, W

`down2x_ref` / `up2x_ref` are the plain versions. `down2x` / `up2x` are
`torch.autograd.Function`s on every device; only their innermost call
differs: the hand-written kernel in `csrc/fir2x.cu` on a CUDA tensor, the
plain version on a CPU tensor; any other input raises.

Gradients mirror the JAX VJPs (`_down2x_bwd` :142, `_up2x_bwd` :167): the
VJP of down2x is the up2x pattern with the taps reversed, and the VJP of
up2x is the down2x pattern with the taps reversed, at the same pads and
with no extra gain. Each backward applies the other Function, so it is
differentiable in turn, and R1's grad-of-grad through `down2x` launches
the kernels too. The up2x kernel takes odd sides, as the JAX `up2x` does,
so the backward of a down2x whose output has an odd side launches it too.

The kernel is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, and loaded with ctypes (`_nvcc.build`).
A build or launch failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import trace
from . import _nvcc
from .upfirdn2d import upfirdn2d_ref

# Launches of each kernel since the last reset; a run reads these to show
# that its path went through the kernels.
LAUNCHES = {"down2x": 0, "up2x": 0}
# Calls of each pattern by the order of differentiation that made them,
# counted on every device once the call has returned: on a CUDA tensor
# each is a launch of the kernel. "backward" is a pattern applied as the
# other pattern's VJP; "second_order" is one applied in the backward of
# such a VJP (R1's grad-of-grad).
ROLES = ("forward", "backward", "second_order")
CALLS = {name: dict.fromkeys(ROLES, 0) for name in LAUNCHES}
# the same calls as counters of the innermost open span (`trace.count`)
COUNTERS = {name: {role: f"fir2x.{name}.{role}" for role in ROLES} for name in LAUNCHES}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        CALLS[name] = dict.fromkeys(ROLES, 0)


# --------------------------------------------------------------------------
# plain versions
def _kernel2d(k1d) -> torch.Tensor:
    k = np.asarray(k1d, np.float64)
    return torch.from_numpy(np.outer(k, k).astype(np.float32))


def down2x_ref(x: torch.Tensor, k1d) -> torch.Tensor:
    """upfirdn2d(up=1, down=2, pad=(1,1)) with kernel outer(k1d, k1d)."""
    return upfirdn2d_ref(x, _kernel2d(k1d), up=1, down=2, pad=(1, 1))


def up2x_ref(x: torch.Tensor, k1d) -> torch.Tensor:
    """upfirdn2d(up=2, down=1, pad=(2,1)) with kernel outer(k1d, k1d)."""
    return upfirdn2d_ref(x, _kernel2d(k1d), up=2, down=1, pad=(2, 1))


# --------------------------------------------------------------------------
# build and bind
def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library (`_nvcc.build`)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _nvcc.build("fir2x.cu", verbose)
    fn = lib.ddgan_fir2x
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


# --------------------------------------------------------------------------
# wrappers
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Lanes in flight that fill an H100 to a quarter (132 SMs x 512): each
# plan shortens its row segments until a launch has this many, trading
# re-read halo rows for parallelism on small tensors.
_TARGET_LANES = 132 * 512
_MAX_ROWS = 16


def _stencil_plan(planes: int, n_rows: int, lanes_per_row: int, vec: bool) -> dict:
    """Lane groups, rows per lane and path of a streaming stencil launch
    whose lanes walk `n_rows` rows of each of `planes` planes, a row strip
    taking `lanes_per_row` lanes. A group is that many rounded up to a
    power of two (to a multiple of 32 past one warp), so groups never
    straddle a warp. Each lane walks at most 16 rows, halved while the
    launch would have fewer than `_TARGET_LANES` lanes."""
    if lanes_per_row <= 32:
        group = 1 << (lanes_per_row - 1).bit_length()
    else:
        group = 32 * -(-lanes_per_row // 32)
    rows = min(n_rows, _MAX_ROWS)
    while rows > 1 and planes * -(-n_rows // rows) * group < _TARGET_LANES:
        rows = (rows + 1) // 2
    segs = -(-n_rows // rows)
    return {"vec": bool(vec), "group": group, "rows": rows, "segments": segs,
            "lanes": planes * segs * group}


def down2x_plan(planes: int, h: int, w: int, aligned: bool) -> dict:
    """The launch plan of the down2x kernel for `planes` planes of h x w.

    A lane owns 4 adjacent outputs of a row (8 input columns), so a row
    strip takes ceil(w / 8) lanes, and walks down `rows` output rows
    (`_stencil_plan`). The vector path (16-byte loads, one store per strip)
    needs every row to start on a 16-byte boundary in both dtypes: w % 8 ==
    0 and 16-byte aligned tensors (`aligned`); otherwise the scalar path."""
    return _stencil_plan(planes, h // 2, -(-w // 8), w % 8 == 0 and aligned)


def up2x_plan(planes: int, h: int, w: int, aligned: bool) -> dict:
    """The launch plan of the up2x kernel for `planes` planes of h x w (any
    h, w >= 1).

    A lane owns 4 adjacent input columns of a row (8 output columns), so a
    row strip takes ceil(w / 4) lanes, and walks down `rows` input rows,
    writing two output rows for each (`_stencil_plan`). The vector path
    (an 8- or 16-byte load, 16-byte stores) needs every input and output row
    to start on its vector's boundary: w % 4 == 0 and 16-byte aligned
    tensors (`aligned`); otherwise the scalar path."""
    return _stencil_plan(planes, h, -(-w // 4), w % 4 == 0 and aligned)


def _check(x: torch.Tensor, k1d, name: str) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.ndim != 4:
        raise ValueError(f"{name}: expected (N, C, H, W), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous (NCHW)")
    if name == "down2x" and (x.shape[2] % 2 or x.shape[3] % 2):
        raise ValueError(f"{name}: H and W must be even, got {tuple(x.shape)}")
    if len(k1d) != 4:
        raise ValueError(f"{name}: needs 4 taps, got {len(k1d)}")
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: tensor too large for the kernel's int indexing")


def _launch(up: int, x: torch.Tensor, k1d, out_hw, name: str) -> torch.Tensor:
    _check(x, k1d, name)
    n, c, h, w = x.shape
    y = torch.empty((n, c) + out_hw, device=x.device, dtype=x.dtype)
    if y.numel() == 0:
        return y
    lib = build()
    taps = [float(v) for v in k1d]
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    plan = (up2x_plan if up else down2x_plan)(n * c, h, w, aligned)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ddgan_fir2x(
            up, _DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
            n * c, h, w, *taps, int(plan["vec"]), plan["group"], plan["rows"], stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def _resample(name: str, x: torch.Tensor, k1d: tuple, order: int) -> torch.Tensor:
    """The pattern `name` at differentiation order `order`: the kernel on
    CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        y = down2x_ref(x, k1d) if name == "down2x" else up2x_ref(x, k1d)
    elif name == "down2x":
        y = _launch(0, x, k1d, (x.shape[2] // 2, x.shape[3] // 2), name)
    else:
        y = _launch(1, x, k1d, (x.shape[2] * 2, x.shape[3] * 2), name)
    role = ROLES[min(order, 2)]
    CALLS[name][role] += 1
    trace.count(COUNTERS[name][role])
    return y


class _Down2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k1d, order):
        ctx.k1d, ctx.order = k1d, order
        return _resample("down2x", x, k1d, order)

    @staticmethod
    def backward(ctx, g):
        return _Up2x.apply(g.contiguous(), ctx.k1d[::-1], ctx.order + 1), None, None


class _Up2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k1d, order):
        ctx.k1d, ctx.order = k1d, order
        return _resample("up2x", x, k1d, order)

    @staticmethod
    def backward(ctx, g):
        return _Down2x.apply(g.contiguous(), ctx.k1d[::-1], ctx.order + 1), None, None


def down2x(x: torch.Tensor, k1d) -> torch.Tensor:
    """FIR downsample by 2, differentiable to any order: the kernel on CUDA,
    the plain version on CPU."""
    return _Down2x.apply(x, tuple(float(v) for v in k1d), 0)


def up2x(x: torch.Tensor, k1d) -> torch.Tensor:
    """FIR upsample by 2, differentiable to any order: the kernel on CUDA,
    the plain version on CPU."""
    return _Up2x.apply(x, tuple(float(v) for v in k1d), 0)
