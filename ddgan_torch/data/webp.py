"""WebP decoding with libwebp's arithmetic, without PIL.

`decode_webp(data)` gives the (H, W, 3) uint8 pixels that PIL's
`Image.open(f).convert("RGB")` gives for a WebP file, bit for bit: lossy
key frames (RFC 6386) through libwebp's fancy chroma upsampling and its
14-bit YUV -> RGB, lossless images (RFC 9649) with every transform, the
colour cache and meta prefix codes, and the container's simple and
extended (`VP8X`) layouts. The alpha plane is skipped: PIL decodes to
non-premultiplied RGBA and `convert("RGB")` drops it. An animation gives
its frame 0 on a canvas cleared to black, as PIL's first frame. A
malformed or truncated file raises ValueError naming the chunk.
`decode_webp_planes(data)` gives a lossy image's cropped Y, U and V planes
before the output stage, to hold the VP8 core apart from it.

The decoder is C++ (`ddgan_torch/csrc/webp_decode.cpp`, a plain C
interface), for the reason `data/jpeg.py` gives: entropy decoding is
bit-serial. It is built with the host C++ compiler at first use into
`ddgan_torch/_build/` (`ops/_cxx.py`) and called through ctypes, which
releases the GIL, so the loader's prefetch threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lib = None
_lib_lock = threading.Lock()
_ERR_CAP = 256


def is_webp(data: bytes) -> bool:
    """Whether `data` starts as a WebP file does (RIFF....WEBP)."""
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..ops import _cxx

            lib = _cxx.build("webp_decode.cpp")
            dims = ctypes.POINTER(ctypes.c_int64)
            lib.ddgan_webp_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, dims,
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.ddgan_webp_decode.restype = ctypes.c_int
            lib.ddgan_webp_decode_yuv.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, dims, ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.ddgan_webp_decode_yuv.restype = ctypes.c_int
            lib.ddgan_webp_table.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t]
            lib.ddgan_webp_table.restype = ctypes.c_size_t
            _lib = lib
        return _lib


def _check(rc: int, err) -> None:
    if rc == 2:
        raise ValueError(f"malformed WebP: {err.value.decode(errors='replace')}")


def decode_webp(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a WebP file, as PIL's
    `Image.open(f).convert("RGB")` decodes it."""
    data = bytes(data)
    lib = _library()
    dims = (ctypes.c_int64 * 2)()
    err = ctypes.create_string_buffer(_ERR_CAP)
    _check(lib.ddgan_webp_decode(data, len(data), None, 0, dims, err, _ERR_CAP), err)
    out = np.empty((int(dims[0]), int(dims[1]), 3), np.uint8)
    _check(lib.ddgan_webp_decode(data, len(data), out.ctypes.data, out.nbytes, dims, err,
                                 _ERR_CAP), err)
    return out


def decode_webp_planes(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The Y (H, W) and U, V ((H+1)//2, (W+1)//2) uint8 planes of a lossy
    WebP's image (frame 0 of an animation), cropped, before upsampling."""
    data = bytes(data)
    lib = _library()
    dims = (ctypes.c_int64 * 2)()
    err = ctypes.create_string_buffer(_ERR_CAP)
    _check(lib.ddgan_webp_decode_yuv(data, len(data), None, None, None, dims, err, _ERR_CAP), err)
    h, w = int(dims[0]), int(dims[1])
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    _check(lib.ddgan_webp_decode_yuv(data, len(data), y.ctypes.data, u.ctypes.data,
                                     v.ctypes.data, dims, err, _ERR_CAP), err)
    return y, u, v


def table(name: str) -> bytes:
    """The bytes of one of the decoder's constant tables (RFC 6386's
    probabilities and quantizer steps, RFC 9649's distance map), as the
    tests compare them with libwebp's."""
    buf = ctypes.create_string_buffer(4096)
    n = _library().ddgan_webp_table(name.encode(), buf, len(buf))
    if n == 0:
        raise KeyError(name)
    return buf.raw[:n]
