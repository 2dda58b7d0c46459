"""Image saving and reading, range mapping, random weights for checks, and
the file and shell helpers of the reference's additionals/utilities.py.

`save_image`, `to_range_0_1`, `copy_file`, `copy_directory`, `move_file`,
`run_bash_command`, `find_python_command` and `install_package` follow
`ddgan_tpu/utils.py`; PNGs are encoded and decoded with the standard
library (zlib) at every bit depth and with Adam7, JPEG, WebP, BMP,
PBM/PGM/PPM and TIFF files decoded by the port's own decoders
(`data/jpeg.py`, `data/webp.py`, `data/bmp.py`, `data/netpbm.py`,
`data/tiff.py`) and converted to RGB as PIL's `convert("RGB")` does
(`to_rgb`), so the port needs no imaging package.
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
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's seven passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


def _not_decodable(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: ddgan_torch reads PNG, JPEG (baseline, progressive, arithmetic-coded, at "
        "any integral sampling), WebP, BMP, PBM/PGM/PPM and TIFF (classic and BigTIFF; "
        "uncompressed, LZW, Deflate, PackBits, LZMA, CCITT and JPEG; integer and float "
        "samples) files in the layouts PIL reads, except those ROADMAP.md Queue 1 item 13i "
        "lists; this one needs an image decoder (item 13i)."
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
    """(header, palette, raw) of a PNG: header the IHDR fields (width,
    height, depth, colour type, compression, filter, interlace), raw the
    inflated scanlines, uint8, each row's filter byte first."""
    data = bytes(data)
    if data[:8] != _PNG_SIGNATURE:
        raise _not_decodable("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if pos + 12 + length > len(data):
            raise ValueError("PNG chunk runs past the end of the file")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r} is truncated or fails its CRC")
        pos += 12 + length
        if tag == b"IHDR":
            if length != 13:
                raise ValueError("PNG IHDR chunk is not 13 bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if color not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[color] or interlace > 1:
        raise ValueError(f"PNG with bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}: not a valid layout")
    if w == 0 or h == 0:
        raise ValueError(f"PNG of {w}x{h} pixels")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    need = sum(ph * (1 + _row_bytes(pw, depth, color)) for ph, pw in _passes(w, h, interlace))
    if raw.size < need:
        raise ValueError(f"PNG data holds {raw.size} bytes, {need} expected")
    return header, palette, raw[:need]


def _row_bytes(w: int, depth: int, color: int) -> int:
    return (w * depth * _PNG_CHANNELS[color] + 7) // 8


def _passes(w: int, h: int, interlace: int) -> list:
    """(height, width) of each sub-image: the image itself, or Adam7's seven
    passes (an empty pass has no bytes, not even filter bytes)."""
    if not interlace:
        return [(h, w)]
    out = []
    for y0, x0, dy, dx in _ADAM7:
        ph, pw = max(0, (h - y0 + dy - 1) // dy), max(0, (w - x0 + dx - 1) // dx)
        out.append((ph, pw) if ph and pw else (0, 0))
    return out


def unpack_bits(rows: np.ndarray, n: int, bits: int) -> np.ndarray:
    """(H, n) uint8 values of the first n `bits`-bit samples of each of the
    (H, row bytes) uint8 rows, packed MSB first as PNG, BMP, PBM and TIFF
    pack 1-, 2- and 4-bit samples."""
    h = rows.shape[0]
    if bits == 1:
        return np.unpackbits(rows, axis=1, count=n)
    b = np.unpackbits(rows, axis=1)[:, :n * bits].reshape(h, n, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (b * weights).sum(axis=2, dtype=np.uint8)


def _samples(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """(H, W, channels) samples of unfiltered rows (H, row bytes): uint8
    below 16 bits (1, 2 and 4 bits unpacked, MSB first), uint16 at 16."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    if depth == 16:
        return rows.view(">u2")[:, :w * channels].astype(np.uint16).reshape(h, w, channels)
    return unpack_bits(rows, w, depth)[:, :, None]


def _png_samples(header, raw: np.ndarray) -> np.ndarray:
    """(H, W, channels) samples of one PNG of any depth, Adam7 or not."""
    w, h, depth, color, _, _, interlace = header
    channels = _PNG_CHANNELS[color]
    bpp = max(1, depth * channels // 8)  # the filters' byte distance
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (ph, pw), (y0, x0, dy, dx) in zip(_passes(w, h, interlace),
                                          _ADAM7 if interlace else ((0, 0, 1, 1),)):
        if ph == 0 or pw == 0:
            continue
        stride = _row_bytes(pw, depth, color)
        rows = raw[pos:pos + ph * (stride + 1)].reshape(ph, stride + 1)
        pos += ph * (stride + 1)
        data = rows[:, 1:].reshape(1, ph, stride // bpp, bpp)
        done = _unfilter(rows[None, :, 0], data) if rows[:, 0].any() else data
        out[y0::dy, x0::dx] = _samples(done.reshape(ph, stride), pw, depth, channels)
    return out


def _png_mode(samples: np.ndarray, color: int, palette, depth: int) -> tuple[np.ndarray, str]:
    """A PNG's samples in the mode PIL opens it in, for `to_rgb`: a palette
    looked up ("RGB"), 16-bit grey as "I" (PIL's "I;16", clipped there),
    other 16-bit samples by their high bytes, 1-, 2- and 4-bit grey scaled
    by 255, 85 and 17 (PIL's "1", "L;2" and "L;4"), grey+alpha as "L"."""
    if color == 3:
        if palette is None or int(samples.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index outside its PLTE chunk")
        return palette[samples[:, :, 0]], "RGB"
    if depth == 16:
        if color == 0:
            return samples[:, :, 0], "I"
        samples = (samples >> 8).astype(np.uint8)
    elif depth < 8:
        samples = samples * np.uint8({1: 255, 2: 85, 4: 17}[depth])
    if color in (0, 4):
        return samples[:, :, 0], "L"
    return samples, "RGBA" if color == 6 else "RGB"


_UNFILTER_GROUP = 64  # images unfiltered together; bounds the int16 copies


def decode_pngs(datas) -> list[np.ndarray]:
    """(H, W, 3) uint8 pixels of each PNG, as PIL's
    `Image.open(f).convert("RGB")` gives them: grey is replicated to three
    channels, a palette is looked up and alpha is dropped.

    Reads every colour type at every bit depth the PNG specification allows
    (1, 2, 4, 8 and 16), Adam7-interlaced or not; a file that is not a
    PNG raises NotImplementedError, a malformed one ValueError. Filtered
    8-bit non-interlaced images of one shape are unfiltered together, up to
    64 at a time (`_unfilter`); other images one at a time.
    """
    read = [_read_png(d) for d in datas]
    pixels: list = [None] * len(read)
    groups: dict = {}
    for i, (header, _, raw) in enumerate(read):
        w, h, depth, color, _, _, interlace = header
        bpp = _PNG_CHANNELS[color]
        if depth != 8 or interlace:
            pixels[i] = _png_samples(header, raw)
            continue
        rows = raw.reshape(h, w * bpp + 1)
        if rows[:, 0].any():
            groups.setdefault((h, w, bpp), []).append(i)
        else:  # no row filtered: the port's own PNGs
            pixels[i] = rows[:, 1:].reshape(h, w, bpp)
    for (h, w, bpp), members in groups.items():
        for k in range(0, len(members), _UNFILTER_GROUP):
            part = members[k:k + _UNFILTER_GROUP]
            stack = np.stack([read[i][2].reshape(h, w * bpp + 1) for i in part])
            done = _unfilter(stack[:, :, 0], stack[:, :, 1:].reshape(len(part), h, w, bpp))
            for i, img in zip(part, done):
                pixels[i] = img
    return [to_rgb(*_png_mode(p, r[0][3], r[1], r[0][2])) for p, r in zip(pixels, read)]


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of one PNG (see `decode_pngs`)."""
    return decode_pngs([data])[0]


def image_format(data: bytes) -> str | None:
    """The format of an image file's bytes, told by its first bytes as PIL
    tells it (not by the file's extension): "png", "jpeg", "webp", "bmp",
    "netpbm", "tiff", or None."""
    from .data.webp import is_webp

    if data.startswith(_PNG_SIGNATURE):
        return "png"
    if data.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if is_webp(data):
        return "webp"
    if data.startswith(b"BM"):
        return "bmp"
    if len(data) >= 2 and data[:1] == b"P" and data[1:2] in b"0123456fy":
        return "netpbm"
    if data[:4] in (b"II*\0", b"MM\0*", b"MM*\0", b"II\0*", b"II+\0", b"MM\0+"):
        return "tiff"
    return None


def to_rgb(pixels: np.ndarray, mode: str) -> np.ndarray:
    """(H, W, 3) uint8 of a decoder's pixels in PIL's `mode`, as PIL's
    `convert("RGB")` gives them: "L" (and "1" as 0/255) replicated, "I"
    (int32: "I;16", "I;16S", "I;32S", "I;32N" as PIL holds them) clipped to
    0-255 and replicated, "F" (float32) as Pillow's Convert.c f2l (0 at or
    below 0 and for NaN, 255 at or above 255, else truncated) and
    replicated, "RGBA" without its alpha, "CMYK" by Pillow's Convert.c
    cmyk2rgb (255 - K - C(255 - K)/255, the product rounded as its
    MULDIV255), "LAB" (a and b signed) as LittleCMS's Lab to sRGB transform
    gives it (`data.cielab`)."""
    if mode == "RGB":
        return np.ascontiguousarray(pixels)
    if mode == "RGBA":
        return np.ascontiguousarray(pixels[:, :, :3])
    if mode == "L":
        return np.stack([pixels] * 3, axis=-1)
    if mode == "I":
        return np.repeat(np.clip(pixels, 0, 255).astype(np.uint8)[:, :, None], 3, axis=2)
    if mode == "F":
        v = np.asarray(pixels, np.float32)
        with np.errstate(invalid="ignore"):
            g = np.where(v >= 255, 255, np.where(v > 0, np.trunc(np.where(v > 0, v, 0)), 0))
        return np.repeat(g.astype(np.uint8)[:, :, None], 3, axis=2)
    if mode == "LAB":
        from .data.cielab import lab_to_rgb

        return lab_to_rgb(pixels)
    if mode == "CMYK":
        nk = 255 - pixels[:, :, 3:].astype(np.int32)
        t = pixels[:, :, :3].astype(np.int32) * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    raise ValueError(f"no RGB conversion for mode {mode!r}")


def decode_images(datas) -> list[np.ndarray]:
    """(H, W, 3) uint8 pixels of each image file's bytes, as PIL's
    `Image.open(f).convert("RGB")` gives them, the format told by its first
    bytes (`image_format`): PNGs through `decode_pngs` (together), JPEGs
    through `data.jpeg.decode_jpeg`, WebP files through
    `data.webp.decode_webp`, BMP through `data.bmp.decode_bmp`, PBM, PGM
    and PPM through `data.netpbm.decode_netpbm`, TIFF through
    `data.tiff.decode_tiff`; each decoder's mode to RGB by `to_rgb`. A
    format none of them reads raises NotImplementedError naming ROADMAP.md
    Queue 1 item 13i, a malformed file ValueError."""
    from .data import bmp, jpeg, netpbm, tiff, webp

    datas = [bytes(d) for d in datas]
    kinds = [image_format(d) for d in datas]
    for k in kinds:
        if k is None:
            raise _not_decodable("an image in a format the port does not read")
    pngs = [i for i, k in enumerate(kinds) if k == "png"]
    out: list = [None] * len(datas)
    for i, img in zip(pngs, decode_pngs([datas[i] for i in pngs])):
        out[i] = img
    for i, (d, k) in enumerate(zip(datas, kinds)):
        if k == "webp":
            out[i] = webp.decode_webp(d)
        elif k == "jpeg":
            img = jpeg.decode_jpeg(d)
            out[i] = to_rgb(img, "L" if img.ndim == 2 else {3: "RGB", 4: "CMYK"}[img.shape[2]])
        elif k == "bmp":
            out[i] = to_rgb(*bmp.decode_bmp(d))
        elif k == "netpbm":
            out[i] = to_rgb(*netpbm.decode_netpbm(d))
        elif k == "tiff":
            out[i] = to_rgb(*tiff.decode_tiff(d))
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
