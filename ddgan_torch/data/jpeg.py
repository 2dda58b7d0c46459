"""Baseline JPEG decoding with libjpeg-turbo's arithmetic, without PIL.

`decode_jpeg(data)` gives the pixels that PIL's `Image.open(f)` gives for
the files it reads: an (H, W) uint8 array for a grey JPEG ("L"), an
(H, W, 3) one for a YCbCr JPEG ("RGB"). It reads SOF0 / SOF1 8-bit
Huffman-coded files with 8- or 16-bit DQT tables, restart markers, 1 or 3
components and 4:4:4, 4:2:2 or 4:2:0 sampling, at any size, and computes
libjpeg-turbo's ISLOW IDCT, its fancy upsampling and its YCbCr -> RGB
tables, so its pixels equal PIL's bit for bit. A progressive,
arithmetic-coded, 12-bit, CMYK or otherwise laid-out file raises
NotImplementedError naming ROADMAP.md Queue 1 item 13; a malformed file
raises ValueError.

The decoder is C++ (`ddgan_torch/csrc/jpeg_decode.cpp`, a plain C
interface): entropy decoding is bit-serial, a q95 256² 4:2:0 image holds
~10^5 coefficients. It is built with the host C++ compiler at first use
into `ddgan_torch/_build/` (`ops/_cxx.py`) and called through ctypes,
which releases the GIL, so the loader's prefetch threads decode in
parallel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

SOI = b"\xff\xd8\xff"  # the first bytes of every JPEG file

_lib = None
_lib_lock = threading.Lock()
_ERR_CAP = 256


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..ops import _cxx

            lib = _cxx.build("jpeg_decode.cpp")
            lib.ddgan_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.ddgan_jpeg_decode.restype = ctypes.c_int
            _lib = lib
        return _lib


def _call(data: bytes, out: np.ndarray | None) -> tuple[int, int, int]:
    dims = (ctypes.c_int64 * 3)()
    err = ctypes.create_string_buffer(_ERR_CAP)
    ptr = None if out is None else out.ctypes.data
    cap = 0 if out is None else out.nbytes
    rc = _library().ddgan_jpeg_decode(data, len(data), ptr, cap, dims, err, _ERR_CAP)
    msg = err.value.decode(errors="replace")
    if rc == 1:
        raise NotImplementedError(
            f"{msg}: ddgan_torch decodes baseline JPEGs only (8-bit, Huffman-coded, grey or "
            "YCbCr at 4:4:4, 4:2:2 or 4:2:0); other images need an image decoder "
            "(ROADMAP.md Queue 1 item 13).")
    if rc == 2:
        raise ValueError(f"malformed JPEG: {msg}")
    return int(dims[0]), int(dims[1]), int(dims[2])


def decode_jpeg(data: bytes) -> np.ndarray:
    """(H, W) grey or (H, W, 3) RGB uint8 pixels of a baseline JPEG, as
    PIL's `Image.open` decodes them."""
    data = bytes(data)
    h, w, c = _call(data, None)
    out = np.empty((h, w, c), np.uint8)
    _call(data, out)
    return out[:, :, 0] if c == 1 else out
