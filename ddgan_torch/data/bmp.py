"""Windows and OS/2 bitmap (BMP) decoding, without PIL.

`decode_bmp(data)` gives `(pixels, mode)` as PIL's `BmpImagePlugin` opens
the file and its unpackers fill the image: "RGB" or "RGBA" (H, W, 3 or 4)
uint8, "L" (H, W) uint8 (PIL's "1" as 0/255, and a palette that is the
grey ramp, which PIL drops), or "RGB" from a palette looked up. It reads
the OS/2 `BITMAPCOREHEADER` (12 bytes) and `BITMAPINFOHEADER` and its
successors (40, 52, 56, 64, 108 and 124 bytes); 1, 4 and 8 bits through a
palette (which may be shorter than 2^bits), 16 (5-5-5), 24 and 32 bits;
BI_RGB, BI_RLE8, BI_RLE4 and the BI_BITFIELDS masks PIL reads; rows bottom-up,
or top-down under a negative height. The RLE decoder follows PIL's step for
step, its quirks included (a delta reads four bytes, an odd RLE4 absolute
run drops its last pixel, the word alignment is to the file's offset), so
that the pixels are PIL's. Layouts PIL does not read either (JPEG or PNG
inside, other masks or depths) raise NotImplementedError naming ROADMAP.md
Queue 1 item 13i; a malformed or truncated file raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils import unpack_bits

# bits -> (mode, raw mode): BmpImagePlugin.BIT2MODE
BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
            24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# (bits, masks) -> raw mode of BI_BITFIELDS: BmpImagePlugin's MASK_MODES
MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
RAW_BITS = {"P;1": 1, "1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}
HEADERS = (12, 40, 52, 56, 64, 108, 124)
MAX_PIXELS = 1 << 28  # a header beyond this is taken as malformed


def _refused(what: str) -> NotImplementedError:
    return NotImplementedError(f"a BMP with {what}: ddgan_torch reads the BMP layouts PIL reads "
                               "(ROADMAP.md Queue 1 item 13i)")


def _u32(data: bytes, pos: int) -> int:
    if pos + 4 > len(data):
        raise ValueError("the BMP file ends inside its header")
    return struct.unpack_from("<I", data, pos)[0]


def _u16(data: bytes, pos: int) -> int:
    if pos + 2 > len(data):
        raise ValueError("the BMP file ends inside its header")
    return struct.unpack_from("<H", data, pos)[0]


def _unpack(rows: np.ndarray, raw: str, w: int) -> np.ndarray:
    """Pixels of (H, row bytes) uint8 rows in PIL's raw mode: (H, W) for
    palette indices and grey, (H, W, 3 or 4) RGB(A) else."""
    h = rows.shape[0]
    if raw in ("P;1", "1", "P;4"):
        idx = unpack_bits(rows, w, RAW_BITS[raw])
        return idx * np.uint8(255) if raw == "1" else idx
    if raw in ("P", "L"):
        return rows[:, :w]
    if raw in ("BGR;15", "BGR;16"):
        px = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
        if raw == "BGR;15":
            r, g, b = (px >> 10) & 31, (px >> 5) & 31, px & 31
            return np.stack([r * 255 // 31, g * 255 // 31, b * 255 // 31], -1).astype(np.uint8)
        r, g, b = (px >> 11) & 31, (px >> 5) & 63, px & 31
        return np.stack([r * 255 // 31, g * 255 // 63, b * 255 // 31], -1).astype(np.uint8)
    n = len(raw)  # byte orders: BGR, BGRX, XBGR, BGXR, ABGR, RGBA, BGRA, BGAR
    px = rows[:, :n * w].reshape(h, w, n)
    order = [raw.index(c) for c in ("RGBA" if "A" in raw else "RGB")]
    return np.ascontiguousarray(px[:, :, order])


def _rle(data: bytes, start: int, w: int, h: int, rle4: bool) -> bytes:
    """PIL's BmpRleDecoder: palette indices, rows in file order."""
    out = bytearray()
    x, pos, need, n = 0, start, w * h, len(data)
    while len(out) < need:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # encoded
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[k % 2] for k in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += b"\0" * (-len(out) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then the two it uses
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise ValueError("a BMP RLE delta runs past the file")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += b"\0" * min(right + up * w, need - len(out))  # PIL's image ends there
            x = len(out) % w
        else:  # absolute
            if rle4:
                chunk = data[pos:pos + byte // 2]
                pos += len(chunk)
                for v in chunk:
                    out += bytes((v >> 4, v & 15))
                short = len(chunk) < byte // 2
            else:
                chunk = data[pos:pos + byte]
                pos += len(chunk)
                out += chunk
                short = len(chunk) < byte
            if short:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < need:
        raise ValueError("the BMP's RLE data ends before its last pixel")
    return bytes(out[:need])


def decode_bmp(data: bytes) -> tuple[np.ndarray, str]:
    """(pixels, mode) of a BMP file, as PIL's `Image.open` gives them; "P"
    files come back looked up, as "RGB"."""
    data = bytes(data)
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset = _u32(data, 10)
    size = _u32(data, 14)
    if size not in HEADERS:
        raise _refused(f"a {size}-byte header")
    if 14 + size > len(data):
        raise ValueError("the BMP file ends inside its header")
    head = data[18:14 + size]
    direction = -1
    if size == 12:
        w, h, bits = _u16(head, 0), _u16(head, 2), _u16(head, 6)
        compression, colors, padding = 0, 0, 3
    else:
        flip = head[7] == 0xFF
        direction = 1 if flip else -1
        w = _u32(head, 0)
        h = 2 ** 32 - _u32(head, 4) if flip else _u32(head, 4)
        bits, compression, colors = _u16(head, 10), _u32(head, 12), _u32(head, 28)
        padding = 4
    pos = 14 + size
    masks = None
    if compression == 3:
        if len(head) >= 48:
            masks = tuple(_u32(head, 36 + 4 * k) for k in range(4 if len(head) >= 52 else 3))
            masks += (0,) * (4 - len(masks))
        else:
            masks = tuple(_u32(data, pos + 4 * k) for k in range(3)) + (0,)
            pos += 12
    colors = colors or (1 << bits if bits < 32 else 0)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    if bits not in BIT2MODE:
        raise _refused(f"{bits} bits a pixel")
    if w == 0 or h == 0 or w * h > MAX_PIXELS:
        raise ValueError(f"a BMP of {w}x{h} pixels")
    mode, raw = BIT2MODE[bits]
    rle = False
    if compression == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in MASK_MODES:
            raise _refused(f"the bitfields {[hex(m) for m in masks]} at {bits} bits")
        raw = MASK_MODES[key]
        mode = "RGBA" if "A" in raw else mode
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        raise _refused(f"compression {compression}")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"a BMP palette of {colors} colours")
        pal = data[pos:pos + padding * colors]
        grey = all(pal[k * padding:k * padding + 3] == bytes([v & 255]) * 3
                   for k, v in enumerate((0, 255) if colors == 2 else range(colors)))
        if grey:
            mode = raw = "1" if colors == 2 else "L"
        else:
            n = len(pal) // padding
            palette = np.frombuffer(pal[:n * padding], np.uint8).reshape(n, padding)[:, 2::-1]
    if rle:
        if mode == "1":
            raise _refused("RLE data under a black-and-white palette (PIL has no raw mode for it)")
        rows = np.frombuffer(_rle(data, offset, w, h, compression == 2), np.uint8).reshape(h, w)
        pixels = rows
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        row_bytes = (RAW_BITS.get(raw, 8 * len(raw)) * w + 7) // 8
        if row_bytes > stride:
            raise _refused(f"a grey palette at {bits} bits (PIL's raw mode overruns the rows)")
        need = (h - 1) * stride + row_bytes
        if offset + need > len(data):
            raise ValueError("the BMP file is truncated")
        body = np.frombuffer(data, np.uint8, min(h * stride, len(data) - offset), offset)
        if body.size < h * stride:
            body = np.concatenate([body, np.zeros(h * stride - body.size, np.uint8)])
        pixels = _unpack(body.reshape(h, stride), raw, w)
    if direction == -1:
        pixels = pixels[::-1]
    if palette is not None:
        # indices past a short palette are black in PIL's lookup
        full = np.zeros((256, 3), np.uint8)
        full[:min(len(palette), 256)] = palette[:256]
        return full[pixels], "RGB"
    if mode in ("1", "L"):
        return np.ascontiguousarray(pixels), "L"
    return np.ascontiguousarray(pixels), mode
