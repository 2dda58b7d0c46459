"""Image saving, range mapping and random weights for checks.

`save_image` and `to_range_0_1` follow `ddgan_tpu/utils.py`; the PNG is
encoded with the standard library (zlib) so the port needs no imaging
package.
"""

from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path

import numpy as np
import torch


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(arr: np.ndarray) -> bytes:
    """8-bit PNG bytes of an (H, W) grey or (H, W, 3) RGB uint8 array."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        color_type = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"PNG needs (H, W) or (H, W, 3) pixels, got {arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(raw, 6))
        + _png_chunk(b"IEND", b"")
    )


def save_image(x: np.ndarray, path: str | Path, normalize: bool = False) -> None:
    """torchvision save_image semantics for one HWC image in [0,1].

    normalize=True min-max rescales; otherwise clamp to [0,1]. uint8 via
    mul(255).add_(0.5).clamp_(0,255) rounding (torchvision's formula).
    """
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 2:
        x = x[:, :, None]
    if normalize:
        lo, hi = float(x.min()), float(x.max())
        x = (x - lo) / max(hi - lo, 1e-5)
    x = np.clip(x, 0.0, 1.0)
    arr = np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[:, :, 0]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(arr))


def to_range_0_1(x):
    """[-1,1] → [0,1] (test_ddgan.py:149)."""
    return (x + 1.0) / 2.0


@torch.no_grad()
def randomize_parameters_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Overwrite every parameter with N(0, 1) / sqrt(fan_in) from a numpy seed.

    For checks only. Under the DDPM init the last conv of every block and
    the head are scaled by 1e-10, so the generator's output is ~0 and any
    comparison of two implementations passes vacuously. fan_in is
    numel / shape[0] for a weight and numel for a vector. The draw depends
    only on the seed and the parameter names, not on the device.
    """
    rng = np.random.RandomState(seed)
    for _, p in sorted(module.named_parameters(), key=lambda kv: kv[0]):
        fan_in = p.numel() // p.shape[0] if p.ndim > 1 else p.numel()
        draw = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        p.copy_(torch.from_numpy(draw / math.sqrt(max(fan_in, 1))))
    return module
