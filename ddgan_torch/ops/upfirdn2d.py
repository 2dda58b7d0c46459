"""upfirdn2d — upsample, FIR filter, downsample (NCHW, plain PyTorch).

Counterpart of `ddgan_tpu/ops/upfirdn2d.py:42-96` (`upfirdn2d_ref`), with
the semantics of the reference CUDA op's golden CPU model
(score_sde/op/upfirdn2d.py:184-225):

    1. zero-stuff: insert `up - 1` zeros after every input sample (per axis)
    2. zero-pad by (pad0, pad1) per axis (negative pads crop)
    3. convolve with the 2-D FIR `kernel` (true convolution, i.e.
       cross-correlation with the flipped kernel)
    4. keep every `down`-th sample

    out_size = (in * up + pad0 + pad1 - k) // down + 1

Done as one depthwise `F.conv2d` over the zero-stuffed, padded input with
the flipped kernel and stride `down`. Autograd differentiates it to any
order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _as_pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) == 1:
            return (int(v[0]), int(v[0]))
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def upfirdn2d_ref(x: torch.Tensor, kernel, up=1, down=1, pad=(0, 0)) -> torch.Tensor:
    """Plain upfirdn2d.

    Args:
      x: (N, C, H, W) input.
      kernel: (kh, kw) 2-D FIR filter, applied depthwise to every channel.
      up: int or (up_y, up_x) upsampling factor.
      down: int or (down_y, down_x) downsampling factor.
      pad: (pad0, pad1) applied to both spatial axes, or
           (pad_x0, pad_x1, pad_y0, pad_y1).

    Returns:
      (N, C, H_out, W_out) with H_out = (H*up_y + pad_y0 + pad_y1 - kh)//down_y + 1.
    """
    up_y, up_x = _as_pair(up)
    down_y, down_x = _as_pair(down)
    if len(pad) == 2:
        pad_x0, pad_x1 = int(pad[0]), int(pad[1])
        pad_y0, pad_y1 = int(pad[0]), int(pad[1])
    else:
        pad_x0, pad_x1, pad_y0, pad_y1 = (int(p) for p in pad)

    n, c, h, w = x.shape
    kernel = torch.as_tensor(kernel).to(device=x.device, dtype=x.dtype)
    kh, kw = kernel.shape

    if up_y > 1 or up_x > 1:
        stuffed = x.new_zeros((n, c, h * up_y, w * up_x))
        stuffed[:, :, ::up_y, ::up_x] = x
        x = stuffed
    # F.pad takes (left, right, top, bottom); negative values crop
    x = F.pad(x, (pad_x0, pad_x1, pad_y0, pad_y1))
    weight = torch.flip(kernel, (0, 1)).reshape(1, 1, kh, kw).repeat(c, 1, 1, 1)
    return F.conv2d(x, weight, stride=(down_y, down_x), groups=c)
