"""Image saving and reading, range mapping, random weights for checks, and
the file and shell helpers of the reference's additionals/utilities.py.

`save_image`, `to_range_0_1`, `copy_file`, `copy_directory`, `move_file`,
`run_bash_command`, `find_python_command` and `install_package` follow
`ddgan_tpu/utils.py`; PNGs are encoded and decoded with the standard
library (zlib), baseline JPEGs and WebP files decoded by the port's own
decoders (`data/jpeg.py`, `data/webp.py`), so the port needs no imaging
package.
"""

from __future__ import annotations

import math
import shutil
import struct
import subprocess
import sys
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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def _not_decodable(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: ddgan_torch reads 8-bit non-interlaced PNGs, baseline JPEGs and WebP "
        "files only; other images need an image decoder (ROADMAP.md Queue 1 item 13)."
    )


def _unfilter(filters: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of N images of one shape at once.

    filters (N, H) uint8, data (N, H, W, bpp) uint8 filtered bytes ->
    (N, H, W, bpp) uint8 pixels. A pixel's prediction reads its left (a),
    upper (b) and upper-left (c) neighbours, already decoded, so the pixels
    of one anti-diagonal x + y = d depend on earlier diagonals only: the
    loop runs over the H + W - 1 diagonals, each step one set of numpy ops
    over that diagonal's pixels in every image, whatever the rows' filters.
    Diagonal d is plane d + 2 of a skewed int16 copy whose planes 0-1 and
    row 0 stay zero: the PNG's zero border.
    """
    n, h, w, bpp = data.shape
    if int(filters.max(initial=0)) > 4:
        raise ValueError(f"PNG row filter {int(filters.max())} is not one of 0-4")
    yy, xx = np.indices((h, w))
    skewed = np.zeros((h + w + 1, h, n, bpp), np.int16)
    skewed[xx + yy + 2, yy] = data.transpose(1, 2, 0, 3)
    out = np.zeros((h + w + 1, h + 1, n, bpp), np.int16)  # row r holds pixel row r - 1
    rows = np.broadcast_to(filters.T[:, :, None], (h, n, bpp))  # each byte's row filter
    # 0/1 weights, not masked ufuncs or np.where: those cost 10-30x an add here
    masks = {k: (rows == k).astype(np.int16) for k in (1, 2, 3, 4) if (filters == k).any()}
    for j in range(2, h + w + 1):
        lo, hi = max(0, j - 1 - w), min(h, j - 1)  # the pixel rows on this diagonal
        a, b, c = out[j - 1, lo + 1:hi + 1], out[j - 1, lo:hi], out[j - 2, lo:hi]
        x = skewed[j, lo:hi]
        if 1 in masks:  # Sub
            x += a * masks[1][lo:hi]
        if 2 in masks:  # Up
            x += b * masks[2][lo:hi]
        if 3 in masks:  # Average
            x += ((a + b) >> 1) * masks[3][lo:hi]
        if 4 in masks:  # Paeth: the neighbour closest to a + b - c, ties to a, then b
            bc, ac = b - c, a - c
            pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
            take_a = (pa <= pb) & (pa <= pc)
            take_b = ~take_a & (pb <= pc)
            x += (c + ac * take_a + bc * take_b) * masks[4][lo:hi]
        np.bitwise_and(x, 0xFF, out=out[j, lo + 1:hi + 1])
    return out[xx + yy + 2, yy + 1].astype(np.uint8).transpose(2, 0, 1, 3)


def _read_png(data: bytes):
    """(header, palette, rows) of a PNG; rows are the inflated scanlines,
    (H, 1 + W * bpp) uint8, each row's filter byte first."""
    data = bytes(data)
    if data[:8] != _PNG_SIGNATURE:
        raise _not_decodable("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r} is truncated or fails its CRC")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        raise _not_decodable(f"PNG with bit depth {depth}, colour type {color}, "
                             f"interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * _PNG_CHANNELS[color]
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, {h * (stride + 1)} expected")
    return header, palette, raw.reshape(h, stride + 1)


def _to_rgb(pixels: np.ndarray, color: int, palette) -> np.ndarray:
    if color == 3:
        if palette is None or int(pixels.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index outside its PLTE chunk")
        return palette[pixels[:, :, 0]]
    if color in (0, 4):
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


_UNFILTER_GROUP = 64  # images unfiltered together; bounds the int16 copies


def decode_pngs(datas) -> list[np.ndarray]:
    """(H, W, 3) uint8 pixels of each PNG, as PIL's
    `Image.open(f).convert("RGB")` gives them: grey is replicated to three
    channels, a palette is looked up and alpha is dropped.

    Reads 8-bit, non-interlaced images of colour types 0, 2, 3, 4 and 6;
    any other image (16-bit, fewer bits, Adam7, not a PNG) raises
    NotImplementedError. Filtered images of one shape are unfiltered
    together, up to 64 at a time (`_unfilter`).
    """
    read = [_read_png(d) for d in datas]
    pixels: list = [None] * len(read)
    groups: dict = {}
    for i, ((w, h, _, color, _, _, _), _, rows) in enumerate(read):
        bpp = _PNG_CHANNELS[color]
        if rows[:, 0].any():
            groups.setdefault((h, w, bpp), []).append(i)
        else:  # no row filtered: the port's own PNGs
            pixels[i] = rows[:, 1:].reshape(h, w, bpp)
    for (h, w, bpp), members in groups.items():
        for k in range(0, len(members), _UNFILTER_GROUP):
            part = members[k:k + _UNFILTER_GROUP]
            stack = np.stack([read[i][2] for i in part])
            done = _unfilter(stack[:, :, 0], stack[:, :, 1:].reshape(len(part), h, w, bpp))
            for i, img in zip(part, done):
                pixels[i] = img
    return [_to_rgb(p, r[0][3], r[1]) for p, r in zip(pixels, read)]


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of one PNG (see `decode_pngs`)."""
    return decode_pngs([data])[0]


def decode_images(datas) -> list[np.ndarray]:
    """(H, W, 3) uint8 pixels of each image file's bytes, as PIL's
    `Image.open(f).convert("RGB")` gives them, the format told by its first
    bytes: PNGs through `decode_pngs` (together), JPEGs through
    `data.jpeg.decode_jpeg` (grey replicated to three channels), WebP files
    (RIFF....WEBP, the LSUN release's values) through `data.webp.decode_webp`.
    Any other format raises NotImplementedError naming ROADMAP.md Queue 1
    item 13."""
    from .data.jpeg import SOI, decode_jpeg
    from .data.webp import decode_webp, is_webp

    datas = [bytes(d) for d in datas]
    for d in datas:
        if not (d.startswith(_PNG_SIGNATURE) or d.startswith(SOI) or is_webp(d)):
            raise _not_decodable("an image that is neither PNG, JPEG nor WebP")
    pngs = [i for i, d in enumerate(datas) if d.startswith(_PNG_SIGNATURE)]
    out: list = [None] * len(datas)
    for i, img in zip(pngs, decode_pngs([datas[i] for i in pngs])):
        out[i] = img
    for i, d in enumerate(datas):
        if out[i] is None and is_webp(d):
            out[i] = decode_webp(d)
        elif out[i] is None:
            img = decode_jpeg(d)
            out[i] = np.repeat(img[:, :, None], 3, axis=2) if img.ndim == 2 else img
    return out


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


# ---- file/shell helpers (additionals/utilities.py:10-177, `ddgan_tpu/utils.py:42-108`)
def copy_file(src, dst, replace=False, rename=None):
    """Copy `src` to `dst` (named `rename` in dst's directory); an existing
    target is kept unless `replace`. Returns the target's path."""
    dst = Path(dst)
    if rename:
        dst = dst.parent / rename
    if dst.exists() and not replace:
        return str(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy2(src, dst)
    return str(dst)


def copy_directory(src, dst, replace=False, rename=None):
    """Copy the tree `src` to `dst` as `copy_file` copies a file."""
    dst = Path(dst)
    if rename:
        dst = dst.parent / rename
    if dst.exists():
        if not replace:
            return str(dst)
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    return str(dst)


def move_file(src, dst, replace=False, rename=None):
    """Move `src` to `dst` as `copy_file` copies it (an existing target kept
    unless `replace`, and then `src` stays)."""
    dst = Path(dst)
    if rename:
        dst = dst.parent / rename
    if dst.exists() and not replace:
        return str(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.move(src, dst)
    return str(dst)


def find_python_command() -> str:
    return sys.executable or "python"


def install_package(package_name: str) -> None:
    """Reference API (additionals/utilities.py:165-177). Installs nothing:
    it prints what to do instead of running pip at run time."""
    print(
        f"install_package('{package_name}'): runtime pip installs are "
        "disabled in this environment; add the package to the image instead."
    )


def run_bash_command(command: str) -> str:
    """Run a shell command and return its standard output (pso.py:94-116,
    `ddgan_tpu/utils.py:76`). A command that exits non-zero raises, with the
    end of its standard error, so that a failed PSO evaluation is seen as one
    (the JAX package's runner returns what it printed and drops the error)."""
    res = subprocess.run(command, shell=True, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"{command!r} exited {res.returncode}:\n{res.stderr[-4000:]}")
    return res.stdout


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
