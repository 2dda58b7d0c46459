"""JPEG decoding with libjpeg-turbo's arithmetic, without PIL.

`decode_jpeg(data)` gives the pixels that PIL's `Image.open(f)` gives for
the files it reads: an (H, W) uint8 array for a grey JPEG ("L"), an
(H, W, 3) one for a YCbCr or RGB-coded JPEG ("RGB"), an (H, W, 4) one for
a CMYK or YCCK JPEG ("CMYK", inverted as PIL's "CMYK;I" raw mode gives it;
`utils.to_rgb` converts it as `convert("RGB")` does). It reads 8-bit
files coded sequentially or progressively, with Huffman or arithmetic
coding (SOF0, SOF1, SOF2, SOF9, SOF10), any scan script, 8- or 16-bit DQT
tables, DAC conditioning, restart markers, 1, 3 or 4 components and
any integral sampling ratios (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, 4:1:0,
3x1, ...), at any size, and computes libjpeg-turbo's entropy decoders, its
ISLOW IDCT, its upsampling (fancy h2v1, h2v2 and h1v2, box replication for
other ratios) and its colour conversions, so its pixels equal PIL's bit
for bit; and lossless files (SOF3, 8-bit, every component at 1x1,
predictors 1-7, any point transform), with no colour conversion as
libjpeg-turbo decodes them. Arithmetic-coded lossless, hierarchical and
12-bit files, non-integral sampling ratios (libjpeg refuses them too),
subsampled lossless files, and a progressive file whose scans leave a
low coefficient unrefined (libjpeg-turbo smooths its blocks) raise NotImplementedError naming ROADMAP.md Queue 1 item 13i; a
malformed file raises ValueError.

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
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.ddgan_jpeg_decode.restype = ctypes.c_int
            lib.ddgan_jpeg_aritab.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t]
            lib.ddgan_jpeg_aritab.restype = ctypes.c_size_t
            _lib = lib
        return _lib


_COLOURS = {"file": 0, "raw": 1, "ycbcr": 2, "box": 3}


def _call(data: bytes, out: np.ndarray | None, colour: str = "file") -> tuple[int, int, int]:
    dims = (ctypes.c_int64 * 3)()
    err = ctypes.create_string_buffer(_ERR_CAP)
    ptr = None if out is None else out.ctypes.data
    cap = 0 if out is None else out.nbytes
    rc = _library().ddgan_jpeg_decode(data, len(data), ptr, cap, dims, _COLOURS[colour], err,
                                      _ERR_CAP)
    msg = err.value.decode(errors="replace")
    if rc == 1:
        raise NotImplementedError(
            f"{msg}: ddgan_torch decodes 8-bit sequential and progressive JPEGs, Huffman- or "
            "arithmetic-coded, grey, YCbCr, RGB, CMYK or YCCK at integral sampling ratios, and "
            "8-bit Huffman-coded lossless ones; this one needs an image decoder (ROADMAP.md "
            "Queue 1 item 13i).")
    if rc == 2:
        raise ValueError(f"malformed JPEG: {msg}")
    return int(dims[0]), int(dims[1]), int(dims[2])


def decode_jpeg(data: bytes, colour: str = "file") -> np.ndarray:
    """(H, W) grey, (H, W, 3) RGB or (H, W, 4) CMYK uint8 pixels of a JPEG,
    as PIL's `Image.open` decodes them; `colour` "raw" gives the
    components as they are and "ycbcr" converts three to RGB whatever the
    file's markers say, as libtiff's JPEG codec asks of a TIFF strip;
    "box" gives them as they are with each component replicated to full
    size (libjpeg's raw data, as libtiff's old-style JPEG codec gives it)."""
    data = bytes(data)
    h, w, c = _call(data, None, colour)
    out = np.empty((h, w, c), np.uint8)
    _call(data, out, colour)
    return out[:, :, 0] if c == 1 else out


def aritab() -> list[int]:
    """The decoder's copy of T.81 Table D.2 in jaricom.c's packing (114
    entries), as the tests hold it against libjpeg's `jpeg_aritab`."""
    out = (ctypes.c_int64 * 114)()
    _library().ddgan_jpeg_aritab(out, 114)
    return list(out)
