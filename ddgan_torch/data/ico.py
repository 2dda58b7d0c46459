"""Windows icon (ICO) decoding, without PIL.

`decode_ico(data)` gives the RGB pixels of the image PIL's
`IcoImagePlugin` opens: of the directory's entries, the largest (width
times height, 0 meaning 256), and among those the one of least colour depth
(its bits a pixel, else log2 of its colour count, else 256). An entry that
starts with the PNG signature is that PNG (`utils.decode_png`, read to its
end as PIL reads it). Any other is a BMP without its file header (a DIB)
whose height counts the colour bitmap and the AND mask: its upper half (in
file order, the first rows) is read through `bmp.decode_bmp`, with the
pixels where PIL's DIB reader puts them (after the header, the bitfield
masks a 40-byte header keeps after it, and the palette; an RLE absolute
run padded to a word of the ICO file, as PIL pads it). PIL then takes the
alpha from the pixels' fourth bytes (an entry of 32 bits a pixel) or from
the AND mask, which `convert("RGB")` drops; the mask must still be in the
file, or PIL fails, and so does this reader (ValueError). A file PIL cannot
open raises ValueError, a layout `decode_bmp` refuses NotImplementedError.
"""

from __future__ import annotations

import math
import struct

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def is_ico(data: bytes) -> bool:
    return data[:4] == b"\0\0\1\0"


def _entry(data: bytes) -> tuple:
    """(bpp, size, offset) of the directory entry PIL opens."""
    n = struct.unpack_from("<H", data, 4)[0] if len(data) >= 6 else 0
    entries = []
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise ValueError("the ICO directory is truncated")
        w, h, colours = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        entries.append((w * h, depth, bpp, size, offset))
    if not entries:
        raise ValueError("an ICO file without an image")
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    return entries[0][2:]


def _dib_as_bmp(dib: bytes, at: int) -> tuple[bytes, int, int, int]:
    """(a BMP file of the DIB's upper half, the pixels' offset in the DIB,
    width, rows) as PIL's DibImageFile and IcoFile.frame read it; `at` is
    the DIB's offset in the ICO file. PIL aligns an RLE absolute run to a
    word of the file it reads: the BMP's pixels start at an offset of the
    same parity as in the ICO file."""
    if len(dib) < 4:
        raise ValueError("the ICO's bitmap ends inside its header")
    size = struct.unpack_from("<I", dib, 0)[0]
    if len(dib) < size or size < 12:
        raise ValueError("the ICO's bitmap ends inside its header")
    head = bytearray(dib[:size])
    if size == 12:
        w, h, bits = struct.unpack_from("<HHxxH", head, 4)
        compression, colours, padding, flip = 0, 0, 3, False
    else:
        w, field = struct.unpack_from("<II", head, 4)
        flip = head[11] == 0xFF
        h = 2 ** 32 - field if flip else field
        bits, compression, colours = struct.unpack_from("<xxHIxxxxxxxxxxxxI", head, 12)
        padding = 4
    half = int(h / 2)
    if half == 0 or w == 0:
        raise ValueError(f"an ICO bitmap of {w}x{half} pixels")
    if size == 12:
        struct.pack_into("<H", head, 6, half)
    else:
        struct.pack_into("<I", head, 8, 2 ** 32 - half if flip else half)
    pos = size + (12 if compression == 3 and size < 52 else 0)
    if bits <= 8:
        pos += padding * (colours or 1 << bits)
    pad = (at - 14) % 2
    bmp = (b"BM" + struct.pack("<IxxxxI", 14 + pad + len(dib), 14 + pad + pos) + bytes(head)
           + dib[size:pos] + bytes(pad) + dib[pos:])
    return bmp, pos, w, half


def decode_ico(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8: the image PIL opens in an ICO file, as its
    `convert("RGB")` gives it."""
    from ..utils import decode_png, to_rgb
    from .bmp import decode_bmp

    data = bytes(data)
    if not is_ico(data):
        raise ValueError("not an ICO file")
    bpp, size, offset = _entry(data)
    if data[offset:offset + 8] == PNG_SIGNATURE:
        return decode_png(data[offset:])
    bmp, pixels_at, w, h = _dib_as_bmp(data[offset:], offset)
    if bpp == 32:
        mask = data[offset + pixels_at:offset + pixels_at + 4 * w * h][3::4]
        present = len(mask) >= w * h
    else:
        stride = (w + 31) // 32 * 4
        at = offset + size - stride * h  # the mask as the entry's size places it
        # PIL's raw decoder needs the last row's bytes only up to its last pixel
        present = at >= 0 and len(data) - at >= (h - 1) * stride + (w + 7) // 8
    if not present:
        raise ValueError("the ICO entry's mask is not in the file (PIL fails on it)")
    return to_rgb(*decode_bmp(bmp))
