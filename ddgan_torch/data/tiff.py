"""TIFF decoding, without PIL.

`decode_tiff(data)` gives `(pixels, mode)` of a TIFF's first image (frame
0, as `Image.open` gives it), the samples as PIL's `TiffImagePlugin`
unpacks them and `utils.to_rgb` ready to convert them as `convert("RGB")`
does: "L" (H, W) uint8, "I" (H, W) int32 (16-bit grey, "I;16"), "RGB"
(H, W, 3) uint8, or "CMYK" (H, W, 4) uint8. It reads:

  * `II` and `MM` byte order, strips or tiles, PlanarConfiguration 1 and 2;
  * compression 1 (none), 5 (LZW, in the TIFF 6.0 form and the older one
    libtiff still reads), 8 and 32946 (Deflate) and 32773 (PackBits);
    predictor 1 and 2;
  * photometric 0 (min-is-white, inverted as PIL inverts it: not at 16
    bits), 1, 2 (RGB), 3 (palette, the colormap's 16-bit entries divided
    by 256 as PIL does) and 5 (CMYK), at 1, 2, 4, 8 and 16 bits as PIL's
    OPEN_INFO table has them; ExtraSamples: unassociated alpha and
    unspecified samples are dropped, associated alpha ("RGBa") is
    un-premultiplied as PIL's unpacker does (v * 255 // a) when the
    samples are interleaved or planar;
  * the Orientation tag, applied as PIL's `ImageOps.exif_transpose`, which
    its TIFF loader calls.

PIL decodes uncompressed files itself and compressed ones through libtiff;
where the two differ (an uncompressed planar file), this follows the one
PIL takes. The LZW and PackBits decoders and predictor 2 are C++
(`ddgan_torch/csrc/tiff_decode.cpp`, a plain C interface, built with the
host C++ compiler at first use into `ddgan_torch/_build/`, `ops/_cxx.py`,
and called through ctypes, which releases the GIL); Deflate is inflated
by Python's zlib. Tag parsing and the layout of samples are numpy.

JPEG-in-TIFF (6, 7), the CCITT codecs (2-4), other codecs, BigTIFF,
floating-point or signed samples, YCbCr, CIELAB and fill order 2 raise
NotImplementedError naming ROADMAP.md Queue 1 item 13i; a malformed or
truncated file raises ValueError.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

from ..utils import unpack_bits

_lib = None
_lib_lock = threading.Lock()
_ERR_CAP = 256
_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I"}  # the integer types
COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
REFUSED_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                        6: "old-style JPEG", 7: "JPEG"}


def _refused(what: str) -> NotImplementedError:
    return NotImplementedError(f"a TIFF with {what}: ddgan_torch does not read it "
                               "(ROADMAP.md Queue 1 item 13i)")


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..ops import _cxx

            lib = _cxx.build("tiff_decode.cpp")
            lib.ddgan_tiff_decode.argtypes = [
                ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t]
            lib.ddgan_tiff_decode.restype = ctypes.c_int
            lib.ddgan_tiff_unpredict.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
            lib.ddgan_tiff_unpredict.restype = ctypes.c_int
            _lib = lib
        return _lib


def _tags(data: bytes) -> tuple[str, dict]:
    """The byte order ("<" or ">") and the first IFD's tags as tuples of
    ints (ASCII and rationals are skipped: none is needed here)."""
    head = data[:4]
    if head[:2] == b"II":
        e = "<"
    elif head[:2] == b"MM":
        e = ">"
    else:
        raise ValueError("not a TIFF file")
    if struct.unpack_from(e + "H", data, 2)[0] == 43:
        raise _refused("the BigTIFF layout")
    if len(data) < 8:
        raise ValueError("the TIFF file ends inside its header")
    (ifd,) = struct.unpack_from(e + "I", data, 4)
    if ifd + 2 > len(data):
        raise ValueError("the TIFF's first IFD lies past the file")
    (count,) = struct.unpack_from(e + "H", data, ifd)
    if ifd + 2 + 12 * count > len(data):
        raise ValueError("the TIFF's first IFD runs past the file")
    tags = {}
    for k in range(count):
        tag, typ, n, = struct.unpack_from(e + "HHI", data, ifd + 2 + 12 * k)
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize(fmt) * n
        at = ifd + 2 + 12 * k + 8
        if size > 4:
            (at,) = struct.unpack_from(e + "I", data, at)
        if at + size > len(data):
            raise ValueError(f"TIFF tag {tag} points past the file")
        tags[tag] = struct.unpack_from(e + fmt * n, data, at)
    return e, tags


def _mode(e: str, photo: int, bps: tuple, extra: tuple) -> tuple[str, str]:
    """(PIL mode, what the samples become) of a layout PIL's OPEN_INFO
    table has, with sample format 1 and fill order 1."""
    n = len(bps)
    if photo in (0, 1) and n == 1:
        bits = bps[0]
        if bits in (1, 2, 4, 8):
            return ("1" if bits == 1 else "L"), ("inverted" if photo == 0 else "grey")
        if bits == 16 and not (photo == 0 and e == ">"):
            return "I;16", "grey"
    if photo == 1 and bps == (8, 8) and extra == (2,):
        return "LA", "grey"
    if photo == 2 and n >= 3 and len(set(bps)) == 1 and bps[0] in (8, 16):
        bits, tail = bps[0], extra
        if bits == 8:
            if n == 3 and tail == ():
                return "RGB", "rgb"
            if n == 4 and tail in ((), (2,), (999,)):
                return "RGBA", "rgb"
            if n == 4 and tail == (0,):
                return "RGB", "rgb"
            if n == 4 and tail == (1,):
                return "RGBA", "rgba_premultiplied"
            if n in (5, 6) and tail[1:] == (0,) * (n - 4) and tail[:1] in ((0,), (1,), (2,)):
                return ("RGBA" if tail[0] else "RGB"), (
                    "rgba_premultiplied" if tail[0] == 1 else "rgb")
        elif n == 3 and tail == ():
            return "RGB", "rgb"
        elif n == 4 and tail in ((), (0,), (1,), (2,)):
            return ("RGB" if tail == (0,) else "RGBA"), (
                "rgba_premultiplied" if tail == (1,) else "rgb")
    if photo == 3:
        if n == 1 and bps[0] in (1, 2, 4, 8):
            return "P", "palette"
        if bps == (8, 8) and extra in ((0,), (2,)):
            return "P", "palette"
    if photo == 5 and extra[1:] == (0,) * len(extra[1:]):
        if bps in ((8,) * 4, (8,) * 5, (8,) * 6) and extra == (0,) * (n - 4):
            return "CMYK", "cmyk"
        if bps == (16,) * 4 and extra == ():
            return "CMYK", "cmyk"
    raise _refused(f"photometric {photo}, bits {bps} and extra samples {extra} "
                   "(a layout PIL's TIFF table does not read either, or not yet read here)")


def _inflate(chunk: bytes, size: int) -> bytes:
    try:
        d = zlib.decompressobj()
        out = d.decompress(chunk, size)
    except zlib.error as err:
        raise ValueError(f"a TIFF Deflate strip does not inflate: {err}") from None
    if len(out) < size:
        raise ValueError("the TIFF Deflate strip ends before it is full")
    return out


def _decompress(compression: int, chunk: bytes, size: int) -> bytes:
    if compression == 1:
        if len(chunk) < size:
            raise ValueError("the TIFF file is truncated")
        return chunk[:size]
    if compression in (8, 32946):
        return _inflate(chunk, size)
    out = ctypes.create_string_buffer(size)
    err = ctypes.create_string_buffer(_ERR_CAP)
    rc = _library().ddgan_tiff_decode(compression, chunk, len(chunk), out, size, err, _ERR_CAP)
    if rc != 0:
        raise ValueError(f"malformed TIFF: {err.value.decode(errors='replace')}")
    return out.raw


def _samples(raw: bytes, rows: int, cols: int, spp: int, bits: int, e: str,
             predictor: int) -> np.ndarray:
    """(rows, cols, spp) samples of one decoded strip or tile: uint8, or
    uint16 at 16 bits; 1-, 2- and 4-bit samples unpacked, MSB first."""
    if bits == 16:
        a = np.frombuffer(raw, e + "u2", rows * cols * spp).astype(np.uint16)
    elif bits == 8:
        a = np.frombuffer(raw, np.uint8, rows * cols * spp).copy()
    else:
        stride = (cols * spp * bits + 7) // 8
        a = unpack_bits(np.frombuffer(raw, np.uint8, rows * stride).reshape(rows, stride),
                        cols * spp, bits)
    if predictor == 2:
        rc = _library().ddgan_tiff_unpredict(a.ctypes.data, bits, rows, cols * spp, spp)
        if rc != 0:
            raise ValueError("predictor 2 on samples it does not take")
    return a.reshape(rows, cols, spp)


_ORIENT = {
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.swapaxes(0, 1), 6: lambda a: a[::-1].swapaxes(0, 1),
    7: lambda a: a[::-1, ::-1].swapaxes(0, 1), 8: lambda a: a[:, ::-1].swapaxes(0, 1),
}


def decode_tiff(data: bytes) -> tuple[np.ndarray, str]:
    """(pixels, mode) of a TIFF's first image, ready for `utils.to_rgb`."""
    data = bytes(data)
    e, tags = _tags(data)

    def one(tag: int, default=None):
        v = tags.get(tag)
        return default if not v else v[0]

    if 0xBC01 in tags:
        raise _refused("Windows Media Photo data")
    compression = one(259, 1)
    if compression not in COMPRESSIONS:
        raise _refused(f"compression {compression} "
                       f"({REFUSED_COMPRESSIONS.get(compression, 'another codec')})")
    photo = one(262, 0)
    if one(266, 1) != 1:
        raise _refused("fill order 2")
    w, h = one(256), one(257)
    if w is None or h is None:
        raise ValueError("a TIFF without its dimensions")
    if w <= 0 or h <= 0:
        raise ValueError(f"a TIFF of {w}x{h} pixels")
    if w * h > 1 << 28:
        raise ValueError(f"a TIFF of {w}x{h} pixels is larger than the reader takes")
    fmt = tags.get(339, (1,))
    if len(fmt) > 1 and min(fmt) == max(fmt) == 1:
        fmt = (1,)
    if tuple(fmt) != (1,):
        raise _refused(f"sample format {fmt} (signed or floating-point samples)")
    bps = tuple(tags.get(258, (1,)))
    extra = tuple(tags.get(338, ()))
    spp = one(277, 1)
    if spp > 6:
        raise ValueError(f"a TIFF of {spp} samples a pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError("the TIFF's BitsPerSample does not match its SamplesPerPixel")
    if photo in (6, 8) or photo > 5:
        raise _refused(f"photometric {photo}")
    mode, kind = _mode(e, photo, bps, extra)
    bits = bps[0]
    planar = one(284, 1)
    predictor = one(317, 1)
    if predictor not in (1, 2):
        raise _refused(f"predictor {predictor}")
    if compression not in (5, 8, 32946):
        predictor = 1  # PIL's raw decoder and libtiff's PackBits codec ignore the tag
    elif predictor == 2 and bits not in (8, 16):
        raise _refused(f"predictor 2 on {bits}-bit samples (libtiff refuses it too)")
    if planar == 2 and spp > 1 and 0 in extra:
        raise _refused("planar samples with an unspecified extra sample (PIL fails on them)")
    if planar == 2 and spp > 1 and compression == 1 and (bits != 8 or kind not in ("rgb", "cmyk")):
        raise _refused("uncompressed planar samples in a layout PIL's raw decoder misreads")
    planes = spp if planar == 2 and spp > 1 else 1
    per = 1 if planes > 1 else spp  # samples a pixel within one plane
    if 273 in tags:
        offsets, counts = tags[273], tags.get(279)
        th, tw = min(one(278, h) or h, h), w
    elif 324 in tags:
        offsets, counts = tags[324], tags.get(325)
        tw, th = one(322), one(323)
        if not tw or not th or tw * th > 1 << 28:
            raise ValueError(f"a tiled TIFF with tiles of {tw}x{th}")
    else:
        raise ValueError("a TIFF without strip or tile offsets")
    if counts is None and compression != 1:
        raise ValueError("a compressed TIFF without its byte counts")
    across, down = -(-w // tw), -(-h // th)
    if len(offsets) < across * down * planes:
        raise ValueError(f"the TIFF holds {len(offsets)} strips or tiles, "
                         f"{across * down * planes} expected")
    if compression != 1 and len(counts) < across * down * planes:
        raise ValueError(f"the TIFF holds {len(counts)} byte counts for "
                         f"{across * down * planes} strips or tiles")
    if compression == 1 and 273 in tags and th == h and planes == 1:
        offsets = offsets[-1:]  # PIL reads one strip covering the image at the last offset
    dtype = np.uint16 if bits == 16 else np.uint8
    img = np.zeros((h, w, spp), dtype)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * th, tx * tw
                rows = th if 324 in tags else min(th, h - y0)
                size = rows * ((tw * per * bits + 7) // 8)
                off = offsets[k]
                end = off + counts[k] if counts is not None and compression != 1 else len(data)
                if off > len(data):
                    raise ValueError("a TIFF strip or tile lies past the file")
                raw = _decompress(compression, data[off:min(end, len(data))], size)
                block = _samples(raw, rows, tw, per, bits, e, predictor)
                yy, xx = min(rows, h - y0), min(tw, w - x0)
                img[y0:y0 + yy, x0:x0 + xx, p:p + per] = block[:yy, :xx]
                k += 1
    pixels, out_mode = _convert(img, kind, bits, tags)
    orientation = one(274, 1)
    if orientation in _ORIENT:
        pixels = np.ascontiguousarray(_ORIENT[orientation](pixels))
    return pixels, out_mode


def _convert(img: np.ndarray, kind: str, bits: int, tags: dict) -> tuple[np.ndarray, str]:
    if kind in ("grey", "inverted"):
        v = img[:, :, 0]
        if bits == 16:
            return v.astype(np.int32), "I"
        scale = {1: 255, 2: 85, 4: 17, 8: 1}[bits]
        v = v.astype(np.uint8) * np.uint8(scale)
        return (255 - v if kind == "inverted" else v).astype(np.uint8), "L"
    if kind == "palette":
        cmap = tags.get(320)
        n = 1 << bits
        if cmap is None or len(cmap) < 3 * n:
            raise ValueError("a palette TIFF without a full colormap")
        pal = (np.asarray(cmap[:3 * n], np.int64) // 256).astype(np.uint8).reshape(3, n).T
        return pal[img[:, :, 0]], "RGB"
    top = (img >> 8).astype(np.uint8) if bits == 16 else img
    if kind == "cmyk":
        return np.ascontiguousarray(top[:, :, :4]), "CMYK"
    rgb = top[:, :, :3]
    if kind == "rgba_premultiplied":
        a = top[:, :, 3:4].astype(np.int32)
        un = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, un)).astype(np.uint8)
    return np.ascontiguousarray(rgb), "RGB"
