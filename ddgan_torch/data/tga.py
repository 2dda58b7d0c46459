"""Truevision Targa (TGA) decoding, without PIL.

`decode_tga(data)` gives `(pixels, mode)` as PIL's `TgaImagePlugin` opens
the file and its `convert("RGB")` reads it: colour-mapped (type 1, 8-bit
indices), true-colour (type 2: 16-bit 5-5-5 as PIL's "BGRA;15Z", 24 and 32
bits) and grey (type 3: 1, 8 and 16 bits, the last grey and alpha), raw or
run-length coded (types 9, 10, 11); rows bottom-up or top-down, and
mirrored when the descriptor asks; colour maps of 16 (5-5-5), 24 and 32
bits, whose first entry may start past index 0 (the entries before it
black, as are indices past the map).

PIL's quirks are the spec: a grey image (with or without alpha) that
carries a colour map is looked up in it, as PIL's `load` puts the map on
the image; a run packet may not cross a row (PIL's decoder overruns:
ValueError here), a literal packet may. What PIL does not decode (a colour
map on a 1-bit or true-colour image, a 32-bit map, 1-bit RLE, a map
longer than 256 entries, an index mode without a map) raises
NotImplementedError naming ROADMAP.md Queue 1 item 13i; a truncated or
malformed file raises ValueError.

TGA has no magic number. PIL tries its plugins in a fixed order and TGA
late, after every plugin that reads a magic and some that read none:
`is_tga` accepts only a header that `TgaImageFile._open` accepts and that
no plugin tried before it claims (`claimed_before_tga`; IM and IPTC
bytes are told by their first byte and refused). A plugin whose
`_open` ends in SyntaxError, IndexError, TypeError, KeyError, EOFError or
struct.error hands the file on to the next; any other error ends
`Image.open`.
"""

from __future__ import annotations

import struct

import numpy as np

# (image type & 7, depth) -> PIL's raw mode (TgaImagePlugin.MODES)
MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
         (2, 24): "BGR", (2, 32): "BGRA"}
MAX_PIXELS = 1 << 28  # a header beyond this is taken as malformed


def _refused(what: str) -> NotImplementedError:
    return NotImplementedError(f"a TGA with {what}: ddgan_torch reads the TGA layouts PIL reads "
                               "(ROADMAP.md Queue 1 item 13i)")


def header(data: bytes) -> dict | None:
    """The fields of an 18-byte TGA header that PIL's `TgaImageFile._open`
    accepts, else None (it raises SyntaxError there)."""
    if len(data) < 18:
        return None
    id_len, cmap_type, image_type = data[0], data[1], data[2]
    start, size, map_depth = struct.unpack_from("<HHB", data, 3)
    w, h = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        return None
    if image_type not in (1, 2, 3, 9, 10, 11) or flags & 0x30 not in (0, 0x10, 0x20, 0x30):
        return None
    if cmap_type and map_depth not in (16, 24, 32):
        return None
    return dict(id_len=id_len, cmap_type=cmap_type, image_type=image_type, start=start,
                size=size, map_depth=map_depth, w=w, h=h, depth=depth,
                top_down=bool(flags & 0x20), mirrored=bool(flags & 0x10))


def _i16le(data: bytes, pos: int) -> int | None:
    return struct.unpack_from("<H", data, pos)[0] if len(data) >= pos + 2 else None


def _cur_claims(data: bytes) -> bool:
    """CurImagePlugin: the largest of the entries, then the bitmap, whose
    header size must be there to read (else struct.error)."""
    n, pos, best = _i16le(data, 4), 6, b""
    for _ in range(n):
        s = data[pos:pos + 16]
        pos += 16
        if not best:
            best = s
        elif len(s) < 2 or len(best) < 2:
            return False  # IndexError: PIL moves on
        elif s[0] > best[0] and s[1] > best[1]:
            best = s
    if len(best) < 16:
        return False  # TypeError or struct.error
    return struct.unpack_from("<I", best, 12)[0] + 4 <= len(data)


def claimed_before_tga(data: bytes) -> bool:
    """Whether a plugin PIL tries before TGA may open these bytes, or fail
    on them with an error that stops `Image.open` (PIL's order: BMP, DIB,
    GIF, JPEG, PPM, PNG, AVIF, BLP, BUFR, CUR, PCX, DCX, DDS, EPS, FITS,
    FLI, FTEX, GBR, GRIB, HDF5, JPEG2000, ICNS, ICO, IM, IMT, IPTC, MCIDAS,
    MPEG, TIFF, MSP, PCD, PIXAR, PSD, QOI, SGI, SPIDER, SUN, then TGA).
    Only the plugins whose test a TGA header can pass are asked: the others
    need a second byte or a third that a TGA header does not have (GBR a
    zero byte 16, TGA's depth; SPIDER a float at byte 16 whose first byte
    is no TGA depth), or take only colour-mapped bytes without a map, which
    TGA does not decode either (ICO, MPEG). CUR, PCX and FLI are asked as
    PIL asks them. IM (text lines from byte 0) and IPTC (0x1C-led fields)
    are told by their first byte alone: such bytes are not read as TGA,
    even where PIL's plugin hands them on (ROADMAP.md item 13i). IMT,
    which needs text lines naming a width and a height, is not asked."""
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis", b"mif1", b"msf1"):
        return True
    if data[:4] == b"\0\0\2\0" and _cur_claims(data):
        return True
    if data[0] == 10 and data[1] == 0 and len(data) >= 68:  # PCX, unless its box is empty
        x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
        if x1 + 1 > x0 and y1 + 1 > y0:
            return True
    if (_i16le(data, 4) in (0xAF11, 0xAF12) and _i16le(data, 14) in (0, 3)
            and data[20:22] == b"\0\0" and data[42:80] == bytes(38) and data[88:128] == bytes(40)
            and _i16le(data, 6) and _i16le(data, 8) and _i16le(data, 10) and len(data) >= 134):
        return True  # FLI, with frames, a size, and its first chunk's type to read
    if data[0] == 0x1C or (data.lstrip(b"\r")[:1].isalpha() and b"\n" in data[:100]):  # IPTC, IM
        return True
    return data[2048:2052] == b"PCD_"


def is_tga(data: bytes) -> bool:
    """Whether PIL opens these bytes with its TGA plugin."""
    return header(data) is not None and not claimed_before_tga(data)


def _rgb15(v: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 of 16-bit 5-5-5 values (B in the low bits), each
    field scaled as PIL's unpacker scales it (v * 255 / 31, truncated)."""
    v = v.astype(np.int32)
    return np.stack([(v >> s & 31) * 255 // 31 for s in (10, 5, 0)], axis=-1).astype(np.uint8)


def _palette(data: bytes, pos: int, hd: dict) -> tuple[np.ndarray, int]:
    """(the 256-entry RGB lookup, where the pixels start)."""
    step = hd["map_depth"] // 8
    raw = data[pos:pos + step * hd["size"]]
    n = len(raw) // step
    if hd["start"] + n > 256:
        raise _refused(f"a colour map of {hd['start'] + n} entries")
    if step == 2:
        entries = _rgb15(np.frombuffer(raw[:2 * n], "<u2"))
    else:
        entries = np.frombuffer(raw[:step * n], np.uint8).reshape(n, step)[:, 2::-1]
    lut = np.zeros((256, 3), np.uint8)
    lut[hd["start"]:hd["start"] + n] = entries
    return lut, pos + len(raw)


def _rle_rows(data: bytes, pos: int, row_bytes: int, h: int, pixel_bytes: int) -> bytes:
    """The rows of a run-length coded image, as PIL's TgaRleDecode fills
    them: a run packet must fit in its row, a literal packet spills into
    the rows after it; decoding stops when the last row is full."""
    out = bytearray()
    end = len(data)
    while len(out) < row_bytes * h:
        x = len(out) % row_bytes
        if pos >= end:
            raise ValueError("the TGA file is truncated")
        head = data[pos]
        n = pixel_bytes * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + pixel_bytes > end:
                raise ValueError("the TGA file is truncated")
            if x + n > row_bytes:
                raise ValueError("a TGA run packet crosses a row (PIL's decoder overruns)")
            out += data[pos + 1:pos + 1 + pixel_bytes] * (n // pixel_bytes)
            pos += 1 + pixel_bytes
        else:
            if pos + 1 + n > end:
                raise ValueError("the TGA file is truncated")
            out += data[pos + 1:pos + 1 + n]
            pos += 1 + n
    return bytes(out[:row_bytes * h])


def decode_tga(data: bytes) -> tuple[np.ndarray, str]:
    """(pixels, mode) of a TGA file as PIL's `convert("RGB")` reads it:
    "RGB" (colour-mapped files looked up), "RGBA", "L" or "LA"."""
    data = bytes(data)
    hd = header(data)
    if hd is None:
        raise ValueError("not a TGA header PIL accepts")
    w, h, depth, kind = hd["w"], hd["h"], hd["depth"], hd["image_type"]
    if w * h > MAX_PIXELS:
        raise ValueError(f"a TGA of {w}x{h} pixels")
    raw = MODES.get((kind & 7, depth))
    if raw is None:
        raise _refused(f"image type {kind} at {depth} bits (PIL has no raw mode for it)")
    if raw == "P" and not hd["cmap_type"]:
        raise _refused("colour-mapped pixels and no colour map")
    if hd["cmap_type"] and raw not in ("P", "L", "LA"):
        raise _refused(f"a colour map on {raw} pixels (PIL cannot put a palette on them)")
    if hd["cmap_type"] and hd["map_depth"] == 32:
        raise _refused("a 32-bit colour map (PIL has no raw mode for its palette)")
    if kind & 8 and depth == 1:
        raise _refused("run-length coded 1-bit pixels (PIL's decoder reads no bytes a pixel)")
    pos = 18 + hd["id_len"]
    lut = None
    if hd["cmap_type"]:
        lut, pos = _palette(data, pos, hd)
    row_bytes = (w * depth + 7) // 8
    if kind & 8:
        body = _rle_rows(data, pos, row_bytes, h, depth // 8)
    else:
        if pos + row_bytes * h > len(data):
            raise ValueError("the TGA file is truncated")
        body = data[pos:pos + row_bytes * h]
    rows = np.frombuffer(body, np.uint8).reshape(h, row_bytes)
    if not hd["top_down"]:
        rows = rows[::-1]
    if raw == "1":
        pixels = np.where(np.unpackbits(rows, axis=1)[:, :w] == 1, 255, 0).astype(np.uint8)
        mode = "L"
    elif raw in ("P", "L"):
        pixels, mode = rows, "L"
    elif raw == "LA":
        pixels, mode = rows.reshape(h, w, 2)[:, :, 0], "L"
    elif raw == "BGRA;15Z":
        pixels, mode = _rgb15(rows.view("<u2").reshape(h, w)), "RGB"
    else:
        pixels, mode = rows.reshape(h, w, depth // 8)[:, :, 2::-1], "RGB"
    if hd["mirrored"]:
        pixels = pixels[:, ::-1]
    if lut is not None:
        return lut[pixels], "RGB"
    return np.ascontiguousarray(pixels), mode
