"""Pillow's 8-bit resampler (`Image.resize`) in numpy integer arithmetic.

The JAX package resizes with PIL at four sites, with two filters:

  * bilinear: `transforms.Resize` (`ddgan_tpu/data/transforms.py:39`,
    `Image.BILINEAR`) and the FID loader's `resize > 0`
    (`ddgan_tpu/eval/fid.py:36`, `Image.BILINEAR`);
  * bicubic, PIL's default filter for "L" and "RGB" images:
    `Luna16Dataset2` (`ddgan_tpu/data/datasets.py:251-252`,
    `.resize((64, 64))`) and `nii_to_png_simple`
    (`ddgan_tpu/data/converters.py:37-38`, `img.resize(do_resize_to)`).

`resize` follows Pillow's `libImaging/Resample.c` step by step, so it
gives PIL's pixels bit for bit on uint8 "L" (H, W) and "RGB" (H, W, 3)
images of any size, shrinking or enlarging:

  * each output pixel's weights are computed in double: the filter's
    support is widened by the scale when shrinking, its center is at
    (x + 0.5) * scale, the weights are summed in order and normalized,
    then made fixed point with 22 fractional bits (`PRECISION_BITS`),
    rounded away from zero;
  * the horizontal pass runs first, over only the rows the vertical pass
    reads, and writes an 8-bit image (each sum starts at 1 << 21, is
    shifted down by 22 and clipped to 0..255); the vertical pass then
    reads that image;
  * a pass whose size does not change is skipped; with neither, the image
    is copied.

Every sum is held in int64 (Pillow's int32 sums cannot overflow, so the
results are the same).
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 22
BILINEAR = "bilinear"
BICUBIC = "bicubic"


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    # Resample.c's bicubic_filter with a = -0.5, each product in its order
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0)}


def coefficients(in_size: int, out_size: int, resample: str):
    """(xmin, count, fixed-point weights (out_size, ksize) int64) of one
    axis: output pixel i reads input pixels xmin[i] .. xmin[i] + count[i]
    - 1 (`precompute_coeffs` and `normalize_coeffs_8bpc`)."""
    filt, support = _FILTERS[resample]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64)
    count = xmax - xmin
    taps = np.arange(ksize)
    w = filt(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss)
    w[taps[None, :] >= count[:, None]] = 0.0
    ww = np.zeros(out_size)
    for t in range(ksize):  # summed in order, as the C loop does
        ww += w[:, t]
    nz = ww != 0.0
    w[nz] /= ww[nz, None]
    scaled = w * (1 << PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return xmin, count, fixed.astype(np.int64)


def _resample(img: np.ndarray, axis: int, xmin: np.ndarray, kk: np.ndarray) -> np.ndarray:
    """One 8-bit pass along `axis` (0 or 1) of an (H, W, C) uint8 image."""
    n = img.shape[axis]
    shape = list(img.shape)
    shape[axis] = len(xmin)
    acc = np.full(shape, 1 << (PRECISION_BITS - 1), np.int64)
    weight_shape = (-1, 1, 1) if axis == 0 else (1, -1, 1)
    for t in range(kk.shape[1]):
        # a tap past an output's window has weight 0; clip its index into the image
        idx = np.minimum(xmin + t, n - 1)
        acc += np.take(img, idx, axis=axis).astype(np.int64) * kk[:, t].reshape(weight_shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: tuple[int, int], resample: str) -> np.ndarray:
    """PIL's `Image.fromarray(img).resize(size, resample)` as an array.

    img: uint8 (H, W) ("L") or (H, W, 3) ("RGB"); size: (width, height), as
    PIL takes it; resample: BILINEAR or BICUBIC.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"resize takes uint8 (H, W) or (H, W, 3) images, got {img.dtype} "
                         f"{img.shape}")
    if resample not in _FILTERS:
        raise ValueError(f"resample must be one of {sorted(_FILTERS)}, got {resample!r}")
    out_w, out_h = int(size[0]), int(size[1])
    if out_w < 1 or out_h < 1:
        raise ValueError(f"resize to {size}: both sides must be at least 1")
    grey = img.ndim == 2
    x = img[:, :, None] if grey else img
    in_h, in_w = x.shape[:2]
    ymin, ycount, ykk = coefficients(in_h, out_h, resample)
    if out_w != in_w:
        # only the rows the vertical pass reads
        first, last = int(ymin[0]), int(ymin[-1] + ycount[-1])
        xmin, _, xkk = coefficients(in_w, out_w, resample)
        x = _resample(x[first:last], 1, xmin, xkk)
        ymin = ymin - first
    if out_h != in_h:
        x = _resample(x, 0, ymin, ykk)
    return (x[:, :, 0] if grey else x).copy()
