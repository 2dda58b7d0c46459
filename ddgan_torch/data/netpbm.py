"""Netpbm decoding (PBM, PGM, PPM, and the other magics Pillow opens),
without PIL.

`decode_netpbm(data)` gives `(pixels, mode)` as PIL's `PpmImagePlugin`
opens the file: mode "L" (H, W) uint8 for PBM (1 = black, as 0, else 255)
and for PGM with maxval <= 255; "I" (H, W) int32 for PGM with a larger
maxval; "RGB" (H, W, 3) uint8 for PPM; "F" (H, W) float32 for `Pf` (the
float map: rows bottom-up, little-endian under a negative scale, else
big-endian; the scale must be finite and non-zero); "CMYK" (H, W, 4) for
`P0CMYK` and `PyCMYK`, "RGBA" (H, W, 4) for `PyRGBA`, and for `PyP`, a "P"
image without a palette, "RGB" zeros (PIL's lookup in its empty palette).
A header is a magic number (up to six bytes, ended by whitespace, which a
six-byte magic need not have) and whitespace-separated tokens, with `#`
comments to the end of the line; the raw forms start their samples after
the one whitespace byte that ends the last token, the plain forms (P1-P3)
hold decimal tokens (P1 one character each, whitespace optional) and may
hold comments too. Samples are scaled as PIL scales them: maxval 255 as it
is, P5 at maxval 65535 as the 16-bit values, any other maxval to
round(v / maxval * M) (M 255, or 65535 for mode "I"; Python's round, half
to even), clipped at M. `utils.to_rgb` then converts as `convert("RGB")`
does ("I" clipped at 255). A malformed or truncated file raises
ValueError.
"""

from __future__ import annotations

import numpy as np

from ..utils import unpack_bits

WHITESPACE = b" \t\n\x0b\x0c\r"
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
         b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
BANDS = {"1": 1, "L": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
_TOKEN_MAX = 10
MAX_PIXELS = 1 << 28  # a header beyond this is taken as malformed


def _header(data: bytes) -> tuple[bytes, list, int]:
    """The magic, the header's integer tokens and where the samples start."""
    magic, pos = b"", 0
    while pos < len(data) and len(magic) < 6 and data[pos] not in WHITESPACE:
        magic += data[pos:pos + 1]
        pos += 1
    if len(magic) < 6:
        pos += 1  # the whitespace byte that ends the magic
    if magic not in MODES:
        raise ValueError(f"not a Netpbm file (magic {magic!r})")
    tokens = []
    for k in range(2 if MODES[magic] == "1" else 3):
        token = b""
        while len(token) <= _TOKEN_MAX:
            if pos >= len(data):
                break
            c = data[pos:pos + 1]
            pos += 1
            if c in WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while pos < len(data) and data[pos] not in b"\r\n":
                    pos += 1
                pos += 1
                continue
            token += c
        if not token or len(token) > _TOKEN_MAX:
            raise ValueError("a Netpbm header token is missing or too long")
        try:
            tokens.append(float(token) if k == 2 and magic == b"Pf" else int(token))
        except ValueError:
            raise ValueError(f"a Netpbm header token is not a number: {token!r}") from None
    return magic, tokens, pos


def _plain_tokens(body: bytes) -> bytes:
    """The data of a plain file without its comments (# to \\r or \\n)."""
    out, pos = bytearray(), 0
    while True:
        k = body.find(b"#", pos)
        if k < 0:
            return bytes(out + body[pos:])
        out += body[pos:k]
        ends = [e for e in (body.find(b"\n", k), body.find(b"\r", k)) if e >= 0]
        if not ends:
            return bytes(out)
        pos = min(ends) + 1


def decode_netpbm(data: bytes) -> tuple[np.ndarray, str]:
    """(pixels, mode) of a Netpbm file, as PIL's `Image.open` gives them."""
    data = bytes(data)
    magic, tokens, pos = _header(data)
    w, h = tokens[0], tokens[1]
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise ValueError(f"Netpbm image of {w}x{h} pixels")
    mode = MODES[magic]
    bands = BANDS.get(mode, 1)
    count = w * h * bands
    body = data[pos:]
    if mode == "F":
        scale = tokens[2]
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError("the Pf scale must be finite and non-zero")
        if len(body) < 4 * count:
            raise ValueError("the Netpbm file is truncated")
        samples = np.frombuffer(body, "<f4" if scale < 0 else ">f4", count)
        return samples.astype(np.float32).reshape(h, w)[::-1].copy(), "F"
    if mode == "1":
        if magic == b"P4":
            stride = (w + 7) // 8
            if len(body) < stride * h:
                raise ValueError("the Netpbm file is truncated")
            bits = unpack_bits(np.frombuffer(body, np.uint8, stride * h).reshape(h, stride), w, 1)
        else:
            digits = b"".join(_plain_tokens(body).split())[:count]
            if len(digits) < count:
                raise ValueError("the Netpbm file is truncated")
            bits = np.frombuffer(digits, np.uint8).reshape(h, w) - ord("0")
            if bits.max(initial=0) > 1:
                raise ValueError("a plain PBM sample that is not 0 or 1")
        return np.where(bits == 1, 0, 255).astype(np.uint8), "L"
    maxval = tokens[2]
    if not 0 < maxval < 65536:
        raise ValueError("maxval must be greater than 0 and less than 65536")
    if maxval > 255 and mode == "L":
        mode = "I"
    out_max = 65535 if mode == "I" else 255
    if magic in (b"P2", b"P3"):
        parts = _plain_tokens(body).split()[:count]
        if len(parts) < count:
            raise ValueError("the Netpbm file is truncated")
        if any(len(t) > _TOKEN_MAX for t in parts):
            raise ValueError("a Netpbm sample token is too long")
        try:
            values = np.array([int(t) for t in parts], np.int64)
        except ValueError:
            raise ValueError("a plain Netpbm sample is not a number") from None
        if values.min(initial=0) < 0 or values.max(initial=0) > maxval:
            raise ValueError(f"a plain Netpbm sample outside 0..{maxval}")
        scale = True
    else:
        wide = maxval > 255
        if len(body) < count * (2 if wide else 1):
            raise ValueError("the Netpbm file is truncated")
        values = np.frombuffer(body, ">u2" if wide else np.uint8, count).astype(np.int64)
        scale = maxval != 255 and not (maxval == 65535 and mode == "I")
    if scale:
        values = np.minimum(out_max, np.round(values / maxval * out_max)).astype(np.int64)
    if mode == "I":
        return values.reshape(h, w).astype(np.int32), "I"
    if mode == "P":  # no palette: PIL looks every index up in an empty one
        return np.zeros((h, w, 3), np.uint8), "RGB"
    pixels = values.astype(np.uint8)
    return (pixels.reshape(h, w, bands), mode) if bands > 1 else (pixels.reshape(h, w), "L")
