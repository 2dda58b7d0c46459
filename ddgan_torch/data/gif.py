"""GIF decoding (87a and 89a, the first frame), without PIL.

`decode_gif(data)` gives `(pixels, mode)` as PIL's `GifImagePlugin` opens
the file at frame 0 and `convert("RGB")` reads it. The image is the
logical screen, grown to hold the first frame if the frame reaches past
it; pixels outside the frame hold the frame's transparent index, else 0.
The frame's colours come from its local table, else the global one; a
table that is the grey ramp (entry i = (i, i, i)) is no table to PIL, and
a frame without one is grey ("L": the index is the level). Quirk kept:
when the local table is the ramp and a global table is not, the image is
"L" to PIL but its palette is the global table, which `convert` looks the
indices up in. Indices past a table are black.

The LZW data is read as PIL's GifDecode.c reads it, by host C++
(`csrc/gif_decode.cpp`, built at first use by `ops/_cxx.py` into
`ddgan_torch/_build/` and called through ctypes): codes LSB first from
the sub-blocks (a zero-length block does not end the stream: the next byte
is read as a block size, as PIL does), minimum code size 0-12, the code
width growing to 12 bits, no entry added once the table holds 4096; a
clear code right after a clear is ignored. Decoding ends when the last
row (of four passes, if interlaced) is full. An end code before that ends
one call of PIL's decoder: PIL then reads the next 64 KiB of the file and
the next call decodes the codes after the end code, or, at the file's
end, it fails ("truncated": ValueError here, as for data that run out).
A code past the next free entry raises ValueError too. A file PIL does
not open (no image descriptor, a frame of no pixels, a minimum code size
past 12) raises NotImplementedError naming ROADMAP.md Queue 1 item 13i.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

MAX_PIXELS = 1 << 28  # a header beyond this is taken as malformed
_ERR_CAP = 256
_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def is_gif(data: bytes) -> bool:
    return data[:6] in (b"GIF87a", b"GIF89a")


def _refused(what: str) -> NotImplementedError:
    return NotImplementedError(f"a GIF with {what}: PIL does not read it, nor does ddgan_torch "
                               "(ROADMAP.md Queue 1 item 13i)")


def _table(data: bytes, pos: int, bits: int) -> tuple[bytes | None, int]:
    """(a colour table of 2^bits entries as PIL keeps it: None where it is
    the grey ramp, where the data go on)."""
    n = 3 << bits
    raw = data[pos:pos + n]
    if len(raw) < n:
        raise ValueError("the GIF file ends inside a colour table")
    ramp = all(raw[i] == raw[i + 1] == raw[i + 2] == i // 3 for i in range(0, n, 3))
    return (None if ramp else raw), pos + n


def _block(data: bytes, pos: int) -> tuple[bytes | None, int]:
    """PIL's `data()`: one sub-block (None at a zero size or the end)."""
    if pos < len(data) and data[pos]:
        return data[pos + 1:pos + 1 + data[pos]], pos + 1 + data[pos]
    return None, pos + 1


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..ops import _cxx

            lib = _cxx.build("gif_decode.cpp")
            lib.ddgan_gif_lzw.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
            lib.ddgan_gif_lzw.restype = ctypes.c_int
            _lib = lib
        return _lib


def _lzw(data: bytes, pos: int, bits: int, count: int) -> bytes:
    """The first `count` indices of the LZW stream at `pos`, as PIL's
    GifDecode.c decodes them (`csrc/gif_decode.cpp`)."""
    out = ctypes.create_string_buffer(count)
    err = ctypes.create_string_buffer(_ERR_CAP)
    if _library().ddgan_gif_lzw(data, len(data), pos, bits, out, count, err, _ERR_CAP):
        raise ValueError(f"malformed GIF: {err.value.decode(errors='replace')}")
    return out.raw


def _rows(h: int, interlace: bool) -> np.ndarray:
    """The frame's row of each decoded row, in decoding order."""
    if not interlace:
        return np.arange(h)
    return np.concatenate([np.arange(s, h, step) for s, step in ((0, 8), (4, 8), (2, 4), (1, 2))])


def decode_gif(data: bytes) -> tuple[np.ndarray, str]:
    """(pixels, mode) of a GIF's first frame as PIL's `convert("RGB")`
    reads it: "RGB" (looked up) or "L"."""
    data = bytes(data)
    if not is_gif(data) or len(data) < 13:
        raise ValueError("not a GIF file")
    w, h = struct.unpack_from("<HH", data, 6)
    flags, pos = data[10], 13
    global_table = None
    if flags & 0x80:
        global_table, pos = _table(data, pos, (flags & 7) + 1)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise _refused("no image descriptor before its end")
        c = data[pos]
        pos += 1
        if c == 0x21:  # an extension: its label, then sub-blocks as PIL skips them
            if pos >= len(data):
                raise _refused("no image descriptor before its end")
            label = data[pos]
            block, pos = _block(data, pos + 1)
            if label == 0xFE:  # a comment: its blocks, and no more
                while block:
                    block, pos = _block(data, pos)
                continue
            if label == 0xF9 and block is not None:
                if len(block) < (4 if block[0] & 1 else 3):
                    raise _refused("a graphic control extension too short for its fields")
                if block[0] & 1:
                    transparency = block[3]
            elif label == 0xFF and block is not None and block.startswith(b"NETSCAPE2.0"):
                block, pos = _block(data, pos)
            # after an empty first block PIL skips on to the next empty one
            while True:
                block, pos = _block(data, pos)
                if not block:
                    break
        elif c == 0x2C:  # the image descriptor
            break
    if pos + 10 > len(data):
        raise ValueError("the GIF file ends inside its image descriptor")
    x0, y0, fw, fh, fflags = struct.unpack_from("<4HB", data, pos)
    pos += 9
    if fflags & 0x80:
        local, pos = _table(data, pos, (fflags & 7) + 1)
        palette = local if local is not None else False
    else:
        palette = global_table
    if pos >= len(data):
        raise ValueError("the GIF file ends inside its image descriptor")
    bits = data[pos]
    pos += 1
    w, h = max(w, x0 + fw), max(h, y0 + fh)
    if fw == 0 or fh == 0:
        raise _refused("a first frame of no pixels")
    if bits > 12:
        raise _refused(f"an LZW minimum code size of {bits}")
    if w * h > MAX_PIXELS:
        raise ValueError(f"a GIF of {w}x{h} pixels")
    frame = np.frombuffer(_lzw(data, pos, bits, fw * fh), np.uint8).reshape(fh, fw)
    image = np.full((h, w), transparency or 0, np.uint8)
    image[y0 + _rows(fh, bool(fflags & 0x40)), x0:x0 + fw] = frame
    lookup = palette if palette else (global_table if palette is False else None)
    if lookup is None:
        return image, "L"
    lut = np.zeros((256, 3), np.uint8)
    entries = np.frombuffer(lookup[:len(lookup) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
    lut[:len(entries)] = entries
    return lut[image], "RGB"
