"""TIFF decoding, without PIL.

`decode_tiff(data)` gives `(pixels, mode)` of a TIFF's first image (frame
0, as `Image.open` gives it), the samples as PIL's `TiffImagePlugin`
unpacks them and `utils.to_rgb` ready to convert them as `convert("RGB")`
does: "L" (H, W) uint8, "I" (H, W) int32 (16-bit grey, "I;16"; signed
16- and 32-bit samples; unsigned 32-bit ones in `II` order, as PIL's
"I;32N"), "F" (H, W) float32, "RGB" (H, W, 3) uint8, or "CMYK" (H, W, 4)
uint8. It reads:

  * `II` and `MM` byte order, classic TIFF and BigTIFF (8-byte offsets,
    tag types LONG8, SLONG8 and IFD8), strips or tiles, PlanarConfiguration
    1 and 2, FillOrder 1 and 2 (libtiff reverses the bits of each stored
    byte before it decodes, as PIL's raw modes "...R" do for uncompressed
    data; JPEG data is never reversed);
  * compression 1 (none), 2 (CCITT Modified Huffman), 3 (CCITT T.4, 1-D and
    2-D), 4 (CCITT T.6), 5 (LZW, in the TIFF 6.0 form and the older one
    libtiff still reads), 6 (old-style JPEG with a whole JPEGInterchangeFormat
    stream), 7 (JPEG: JPEGTables spliced in front of each strip or tile,
    each decoded on its own and cropped), 8 and 32946 (Deflate), 32773
    (PackBits) and 34925 (LZMA); predictor 1, 2 (8, 16 and 32 bits) and 3
    (libtiff's floating-point differencing);
  * photometric 0 (min-is-white, inverted as PIL inverts it: not at 16
    bits or in float), 1, 2 (RGB), 3 (palette, the colormap's 16-bit
    entries divided by 256 as PIL does), 5 (CMYK), 6 (YCbCr, when
    JPEG-compressed: converted to RGB by the JPEG decoder as libtiff's
    JPEGCOLORMODE_RGB does, at any YCbCrSubSampling) and 8 (CIELAB, as
    PIL's "LAB", which `utils.to_rgb` converts as LittleCMS does, through
    `data/cielab.py`; planar, a and b with their top bit flipped, as PIL's
    plane unpackers leave them), at 1, 2, 4, 8, 16
    and 32 bits and sample formats 1 (unsigned), 2 (signed) and 3 (IEEE
    float) as PIL's OPEN_INFO table has them; ExtraSamples: unassociated
    alpha and unspecified samples are dropped, associated alpha ("RGBa")
    is un-premultiplied as PIL's unpacker does (v * 255 // a) when the
    samples are interleaved or planar;
  * YCbCr that PIL reads through libtiff's TIFFRGBAImage (old-style JPEG,
    and YCbCr data units under a codec other than JPEG, in strips, at
    subsampling 1x1, 2x1, 2x2, 4x1, 4x2, 1x2 and 4x4): each chroma sample
    repeated over its block, then tif_color.c's TIFFYCbCrtoRGB with the
    file's YCbCrCoefficients and ReferenceBlackWhite;
  * the Orientation tag, applied as PIL's `ImageOps.exif_transpose`, which
    its TIFF loader calls.

PIL decodes uncompressed files itself and compressed ones through libtiff;
where the two differ, this follows the one PIL takes: an uncompressed
planar file, and a compressed `MM` file of signed 16- or 32-bit or float
samples, which libtiff hands over in the machine's (little-endian) order
and PIL then unpacks as big-endian. The LZW, PackBits and CCITT decoders
and predictor 2 are C++ (`ddgan_torch/csrc/tiff_decode.cpp`, a plain C
interface, built with the host C++ compiler at first use into
`ddgan_torch/_build/`, `ops/_cxx.py`, and called through ctypes, which
releases the GIL); JPEG strips go through `data/jpeg.py`; Deflate and LZMA
are inflated by Python's zlib and lzma. Tag parsing, predictor 3 and the
layout of samples are numpy.

Zstd (50000) and other codecs, old-style JPEG without a whole
JPEGInterchangeFormat stream, uncompressed YCbCr (PIL's raw reader
misreads it), tiled YCbCr other than JPEG, 4x4 YCbCr at an odd count of
blocks across (libtiff reads its strips short), 12-bit JPEG strips, a
big-endian BigTIFF (PIL
cannot open it) and layouts PIL's table does not hold raise
NotImplementedError naming ROADMAP.md Queue 1 item 13i; a malformed or
truncated file raises ValueError.
"""

from __future__ import annotations

import ctypes
import lzma
import struct
import threading
import zlib

import numpy as np

from ..utils import unpack_bits

_lib = None
_lib_lock = threading.Lock()
_ERR_CAP = 256
# the integer types (BYTE and UNDEFINED kept as bytes), with BigTIFF's 8-byte ones
_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 13: "I", 16: "Q", 17: "q",
          18: "Q"}
COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW",
                6: "old-style JPEG", 7: "JPEG", 8: "Deflate", 32946: "Deflate", 32773: "PackBits",
                34925: "LZMA"}
REFUSED_COMPRESSIONS = {50000: "Zstd"}
_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))  # each byte's bits reversed
# (photometric, bits) of the FillOrder 2 layouts in PIL's OPEN_INFO table
_FILL_ORDER_2 = {(p, (b,)) for p in (0, 1, 3) for b in (1, 2, 4, 8)} | {(2, (8, 8, 8))}


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
            lib.ddgan_tiff_fax.argtypes = [
                ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_size_t]
            lib.ddgan_tiff_fax.restype = ctypes.c_int
            _lib = lib
        return _lib


def _tags(data: bytes) -> tuple[str, dict]:
    """The byte order ("<" or ">") and the first IFD's tags of a classic
    TIFF or a BigTIFF: tuples of ints, bytes for BYTE and UNDEFINED (ASCII
    and rationals are skipped: none is needed here)."""
    head = data[:4]
    if head[:2] == b"II":
        e = "<"
    elif head[:2] == b"MM":
        e = ">"
    else:
        raise ValueError("not a TIFF file")
    if len(data) < 8:
        raise ValueError("the TIFF file ends inside its header")
    if struct.unpack_from(e + "H", data, 2)[0] == 43:  # BigTIFF
        if e == ">":
            raise _refused("the big-endian BigTIFF layout (PIL reads its version at the wrong "
                           "byte and cannot open it)")
        if len(data) < 16:
            raise ValueError("the BigTIFF file ends inside its header")
        size, _, ifd = struct.unpack_from(e + "HHQ", data, 4)
        if size != 8:
            raise ValueError(f"a BigTIFF with offsets of {size} bytes")
        nfmt, entry, inline, ofmt = "Q", 20, 8, "Q"
    else:
        (ifd,) = struct.unpack_from(e + "I", data, 4)
        nfmt, entry, inline, ofmt = "H", 12, 4, "I"
    first = struct.calcsize(nfmt)
    if ifd + first > len(data):
        raise ValueError("the TIFF's first IFD lies past the file")
    (count,) = struct.unpack_from(e + nfmt, data, ifd)
    if ifd + first + entry * count > len(data):
        raise ValueError("the TIFF's first IFD runs past the file")
    tags = {}
    for k in range(count):
        base = ifd + first + entry * k
        tag, typ = struct.unpack_from(e + "HH", data, base)
        (n,) = struct.unpack_from(e + ofmt, data, base + 4)
        if typ not in _TYPES and typ not in (5, 11):
            continue
        fmt = {5: "II", 11: "f"}.get(typ) or _TYPES[typ]
        size = struct.calcsize(fmt) * n
        at = base + 4 + inline
        if size > inline:
            (at,) = struct.unpack_from(e + ofmt, data, at)
        if at + size > len(data):
            raise ValueError(f"TIFF tag {tag} points past the file")
        v = data[at:at + size] if typ in (1, 7) else struct.unpack_from(e + fmt * n, data, at)
        if typ == 5:  # RATIONAL, as libtiff reads one into a float
            v = tuple(float(np.float32(a) / np.float32(b)) if b else 0.0
                      for a, b in zip(v[::2], v[1::2]))
        tags[tag] = v
    return e, tags


def _mode(e: str, photo: int, bps: tuple, extra: tuple, fmt: tuple,
          fill: int) -> tuple[str, str]:
    """(PIL mode, what the samples become) of a layout PIL's OPEN_INFO
    table has."""
    n = len(bps)
    if fill != 1 and not (fill == 2 and extra == () and fmt == (1,) and (
            (photo, bps) in _FILL_ORDER_2 or (photo, bps, e) == (1, (16,), "<"))):
        raise _refused(f"fill order {fill} with photometric {photo} and bits {bps} "
                       "(a layout PIL's TIFF table does not read)")
    if fmt != (1,):
        if fmt == (2,) and photo == 1 and extra == () and bps in ((8,), (16,), (32,)):
            return ("L", "grey") if bps == (8,) else ("I", "signed")  # signed bytes read as L
        if fmt == (3,) and photo in (0, 1) and bps == (32,) and extra == ():
            return "F", "float"
        raise _refused(f"sample format {fmt} with photometric {photo} and bits {bps} "
                       "(a layout PIL's TIFF table does not read)")
    if (photo, bps, extra, e) == (1, (32,), (), "<"):
        return "I", "unsigned32"  # PIL's "I;32N": the bits as a signed int32
    if (photo, bps, extra) == (8, (8, 8, 8), ()):
        return "LAB", "lab"  # PIL's raw mode "LAB": a and b as the file's signed bytes
    if photo == 6 and extra == ():
        if bps == (8,):
            return "L", "grey"
        if bps == (8, 8, 8):
            return "RGB", "rgb"
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


def _unxz(chunk: bytes, size: int) -> bytes:
    try:
        out = lzma.LZMADecompressor().decompress(chunk, size)
    except lzma.LZMAError as err:
        raise ValueError(f"a TIFF LZMA strip does not decompress: {err}") from None
    if len(out) < size:
        raise ValueError("the TIFF LZMA strip ends before it is full")
    return out


def _decompress(compression: int, chunk: bytes, size: int) -> bytes:
    if compression == 1:
        if len(chunk) < size:
            raise ValueError("the TIFF file is truncated")
        return chunk[:size]
    if compression in (8, 32946):
        return _inflate(chunk, size)
    if compression == 34925:
        return _unxz(chunk, size)
    out = ctypes.create_string_buffer(size)
    err = ctypes.create_string_buffer(_ERR_CAP)
    rc = _library().ddgan_tiff_decode(compression, chunk, len(chunk), out, size, err, _ERR_CAP)
    if rc != 0:
        raise ValueError(f"malformed TIFF: {err.value.decode(errors='replace')}")
    return out.raw


def _unfax(compression: int, chunk: bytes, rows: int, cols: int, options: int) -> bytes:
    """A CCITT strip or tile as packed 1-bit rows, 1 for black."""
    size = rows * ((cols + 7) // 8)
    out = ctypes.create_string_buffer(size)
    err = ctypes.create_string_buffer(_ERR_CAP)
    rc = _library().ddgan_tiff_fax(compression, chunk, len(chunk), out, size, cols, rows, options,
                                   err, _ERR_CAP)
    if rc != 0:
        raise ValueError(f"malformed TIFF: {err.value.decode(errors='replace')}")
    return out.raw


def _jpeg_sampling(stream: bytes) -> list:
    """[(h, v), ...] of each component in a JPEG stream's frame header."""
    pos = 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF:
        marker = stream[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            n = stream[pos + 9] if pos + 10 <= len(stream) else 0
            comps = stream[pos + 10:pos + 10 + 3 * n]
            return [(comps[k + 1] >> 4, comps[k + 1] & 15) for k in range(0, len(comps) - 2, 3)]
        if marker == 0xDA:
            break
        pos += 2 + int.from_bytes(stream[pos + 2:pos + 4], "big")
    raise ValueError("a TIFF JPEG strip without a frame header")


def _unjpeg(stream: bytes, colour: str, rows: int, cols: int, per: int,
            last_strip: bool) -> np.ndarray:
    """A JPEG strip or tile (the JPEGTables already in front) as libtiff's
    JPEG codec gives it: decoded on its own, so its upsampling replicates
    its own edges, and cropped to the strip or tile."""
    from . import jpeg

    px = jpeg.decode_jpeg(stream, colour=colour)
    px = px.reshape(px.shape[0], px.shape[1], -1)
    if px.shape[2] != per:
        raise ValueError(f"a TIFF JPEG strip of {px.shape[2]} components, {per} expected")
    if px.shape[0] < rows or px.shape[1] != cols or (px.shape[0] > rows and not last_strip):
        raise ValueError(f"a TIFF JPEG strip of {px.shape[1]}x{px.shape[0]} pixels, "
                         f"{cols}x{rows} expected")
    return px[:rows]


def _unpredict_float(raw: bytes, rows: int, cols: int, spp: int) -> np.ndarray:
    """(rows, cols, spp) float32 of predictor 3 data (tif_predict.c fpAcc):
    each row's bytes summed along the row `spp` apart, then its byte planes
    (most significant first) put back together as little-endian float32s,
    the machine's order."""
    wc = cols * spp
    a = np.frombuffer(raw, np.uint8, rows * wc * 4).reshape(rows, -1, spp)
    a = np.cumsum(a, axis=1, dtype=np.uint8).reshape(rows, 4, wc)
    return np.ascontiguousarray(a[:, ::-1].transpose(0, 2, 1)).view("<f4").reshape(rows, cols, spp)


def _samples(raw: bytes, rows: int, cols: int, spp: int, bits: int, e: str,
             predictor: int, kind: str = "grey") -> np.ndarray:
    """(rows, cols, spp) samples of one decoded strip or tile, their true
    values: uint8, uint16 (int16 if signed) at 16 bits, int32 or float32 at
    32 bits; 1-, 2- and 4-bit samples unpacked, MSB first."""
    if predictor == 3:
        return _unpredict_float(raw, rows, cols, spp)
    if bits in (16, 32):
        t = np.uint16 if bits == 16 else np.uint32
        a = np.frombuffer(raw, np.dtype(t).newbyteorder(e), rows * cols * spp).astype(t)
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
    if kind == "float":
        a = a.view(np.float32)
    elif kind in ("signed", "unsigned32"):
        a = a.view(np.int16 if bits == 16 else np.int32)
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
    fill = one(266, 1)
    w, h = one(256), one(257)
    if w is None or h is None:
        raise ValueError("a TIFF without its dimensions")
    if w <= 0 or h <= 0:
        raise ValueError(f"a TIFF of {w}x{h} pixels")
    if w * h > 1 << 28:
        raise ValueError(f"a TIFF of {w}x{h} pixels is larger than the reader takes")
    fmt = tuple(tags.get(339, (1,)))
    if len(fmt) > 1 and min(fmt) == max(fmt) == 1:
        fmt = (1,)
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
    planar = one(284, 1)
    if photo == 6 and spp == 3 and compression == 1:
        raise _refused("uncompressed YCbCr samples (PIL's raw reader misreads them)")
    if compression == 6 or (photo == 6 and spp == 3 and compression != 7):
        return _ycbcr_as_rgba(data, e, tags, compression, bps, spp, fill), "RGB"
    if photo > 6 and photo != 8:
        raise _refused(f"photometric {photo}")
    mode, kind = _mode(e, photo, bps, extra, fmt, fill)
    bits = bps[0]
    predictor = one(317, 1)
    if compression in (5, 8, 32946, 34925):
        if predictor not in (1, 2, 3):
            raise _refused(f"predictor {predictor}")
        if predictor == 2 and bits not in (8, 16, 32):
            raise _refused(f"predictor 2 on {bits}-bit samples (libtiff refuses it too)")
        if predictor == 3 and kind != "float":
            raise ValueError("predictor 3 on samples that are not float (libtiff refuses it)")
    else:
        predictor = 1  # PIL's raw decoder and libtiff's other codecs ignore the tag
    if compression in (2, 3, 4) and (bits != 1 or spp != 1):
        raise ValueError(f"CCITT compression on {spp} samples of {bits} bits (libtiff refuses it)")
    if compression == 7 and bits != 8:
        raise _refused(f"a JPEG-compressed TIFF of {bits}-bit samples")
    if compression == 7 and photo == 6 and planar != 1:
        raise _refused("planar YCbCr JPEG (libtiff hands PIL the YCbCr samples unconverted)")
    if fill == 2 and compression == 1 and (photo, bits) in ((3, 1), (3, 2), (3, 4), (0, 8)):
        raise _refused("uncompressed fill order 2 samples PIL has no raw mode for")
    if planar == 2 and spp > 1 and 0 in extra:
        raise _refused("planar samples with an unspecified extra sample (PIL fails on them)")
    if planar == 2 and kind == "lab":
        kind = "lab planar"  # PIL's plane unpackers copy a and b without the sign flip
    if planar == 2 and spp > 1 and compression == 1 and (
            bits != 8 or kind not in ("rgb", "cmyk", "lab planar")):
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
    # libtiff hands PIL these in the machine's order, which PIL unpacks in the file's
    misread = compression != 1 and e == ">" and kind in ("signed", "float")
    tables, colour, sampling = bytes(tags.get(347, b"")), "raw", None
    if tables.endswith(b"\xff\xd9"):
        tables = tables[:-2]
    if compression == 7 and photo == 6:
        colour = "ycbcr"  # libtiff's JPEGCOLORMODE_RGB, which PIL asks for
    dtype = {"float": np.float32, "signed": np.int16 if bits == 16 else np.int32,
             "unsigned32": np.int32}.get(kind, np.uint16 if bits == 16 else np.uint8)
    img = np.zeros((h, w, spp), dtype)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * th, tx * tw
                rows = th if 324 in tags else min(th, h - y0)
                off = offsets[k]
                end = off + counts[k] if counts is not None and compression != 1 else len(data)
                if off > len(data):
                    raise ValueError("a TIFF strip or tile lies past the file")
                chunk = data[off:min(end, len(data))]
                if fill == 2 and compression != 7:
                    chunk = chunk.translate(_REVERSED)
                if compression == 7:
                    stream = tables + (chunk[2:] if tables and chunk[:2] == b"\xff\xd8" else chunk)
                    got = _jpeg_sampling(stream)
                    if sampling is None:  # JPEGFixupTags: the first strip's, where no tag says
                        sub = tuple(tags.get(530, ()))[:2] or (tuple(got[0]) if got else (1, 1))
                        sampling = ([sub] + [(1, 1)] * (per - 1) if colour == "ycbcr"
                                    else [(1, 1)] * per)
                    if got != sampling:
                        raise ValueError(f"a TIFF JPEG strip sampled {got}; libtiff expects "
                                         f"{sampling}")
                    block = _unjpeg(stream, colour, rows, tw, per, 273 in tags and ty == down - 1)
                else:
                    if compression in (2, 3, 4):
                        opts = one(292, 0) if compression == 3 else 0
                        raw = _unfax(compression, chunk, rows, tw, opts)
                    else:
                        size = rows * ((tw * per * bits + 7) // 8)
                        raw = _decompress(compression, chunk, size)
                    block = _samples(raw, rows, tw, per, bits, e, predictor, kind)
                yy, xx = min(rows, h - y0), min(tw, w - x0)
                img[y0:y0 + yy, x0:x0 + xx, p:p + per] = block[:yy, :xx]
                k += 1
    if misread:
        img = img.byteswap()
    pixels, out_mode = _convert(img, kind, bits, tags)
    orientation = one(274, 1)
    if orientation in _ORIENT:
        pixels = np.ascontiguousarray(_ORIENT[orientation](pixels))
    return pixels, out_mode


def _ycbcr_tables(tags: dict) -> tuple:
    """tif_color.c TIFFYCbCrToRGBInit's tables (Cr_r, Cb_b, Cr_g, Cb_g, Y)
    from YCbCrCoefficients (529) and ReferenceBlackWhite (532), or their
    defaults, in libtiff's float32 and 16-bit fixed-point arithmetic."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in (tuple(tags.get(529, ())) + (0.299, 0.587, 0.114)[
        len(tags.get(529, ())):])[:3])
    rbw = [f32(v) for v in (tuple(tags.get(532, ())) + (0, 255, 128, 255, 128, 255)[
        len(tags.get(532, ())):])[:6]]
    if not all(np.isfinite(v) for v in (lr, lg, lb, *rbw)) or lg == 0:
        raise ValueError("a YCbCr TIFF with NaN coefficients or a zero green luma")

    def fix(x) -> int:  # FIX(CLAMP(x, 0, 2))
        x = f32(0) if not x >= 0 else (f32(2) if x > 2 else x)
        return int(float(f32(x) * f32(65536)) + 0.5)

    f1, f3 = f32(2) - f32(2) * lr, f32(2) - f32(2) * lb
    d1, d2, d3, d4 = fix(f1), -fix(lr * f1 / lg), fix(f3), -fix(lb * f3 / lg)

    def code2v(c, rb, rw, cr) -> int:  # Code2V, then CLAMPw to +-4096 and int32
        den = f32(rw - rb) if rw - rb != 0 else f32(1)
        v = f32(f32(c - int(rb)) * f32(cr)) / den
        return int(min(max(v, f32(-4096)), f32(4096)))

    x = range(-128, 128)
    cr = np.array([code2v(i, rbw[4] - f32(128), rbw[5] - f32(128), 127) for i in x], np.int64)
    cb = np.array([code2v(i, rbw[2] - f32(128), rbw[3] - f32(128), 127) for i in x], np.int64)
    y = np.array([code2v(i + 128, rbw[0], rbw[1], 255) for i in x], np.int64)
    return ((d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr, d4 * cb + 32768, y)


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, tags: dict) -> np.ndarray:
    """tif_color.c TIFFYCbCrtoRGB of full-size uint8 planes."""
    cr_r, cb_b, cr_g, cb_g, ytab = _ycbcr_tables(tags)
    yv = ytab[y]
    rgb = np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16), yv + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# TIFFRGBAImage's YCbCr cases (tif_getimage.c PickContigCase): (h, v) sampling
_RGBA_SAMPLINGS = {(4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)}


def _ycbcr_as_rgba(data: bytes, e: str, tags: dict, compression: int, bps: tuple, spp: int,
                   fill: int) -> np.ndarray:
    """(H, W, 3) of a YCbCr TIFF that PIL reads through libtiff's
    TIFFRGBAImage (TiffDecode.c _decodeAsRGBA): old-style JPEG (6), or
    YCbCr samples compressed other than with JPEG. Each strip's data units
    (h * v luma samples, then Cb and Cr) or the old-style JPEG stream
    (decoded with each component box-replicated, as libjpeg's raw data
    puts it, no colour conversion) give full-size planes, each chroma
    sample repeated over its block as tif_getimage.c's putcontig8bitYCbCr
    functions repeat it, converted by TIFFYCbCrtoRGB."""
    def one(tag: int, default=None):
        v = tags.get(tag)
        return default if not v else v[0]

    w, h = one(256), one(257)
    if compression == 6:
        spp = one(277, 3)
    if bps[:1] != (8,) or spp != 3 or one(284, 1) != 1 or fill != 1 or tags.get(338):
        raise _refused(f"YCbCr {'old-style JPEG' if compression == 6 else 'samples'} other "
                       "than 8-bit, interleaved, three samples (PIL's TIFFRGBAImage path)")
    if one(274, 1) != 1:
        raise _refused("YCbCr read through TIFFRGBAImage with an Orientation tag (libtiff "
                       "flips it before PIL transposes it)")
    if 273 not in tags:
        raise _refused("tiled YCbCr without JPEG compression")
    if compression == 6:
        from . import jpeg

        at, n = one(513), one(514)
        if not at or not n or data[at:at + 2] != b"\xff\xd8":
            raise _refused("old-style JPEG without a whole JPEGInterchangeFormat stream")
        stream = data[at:at + n]
        sampling = _jpeg_sampling(stream)
        if len(sampling) != 3 or sampling[1:] != [(1, 1), (1, 1)] or \
                tuple(sampling[0]) not in _RGBA_SAMPLINGS:
            raise _refused(f"old-style JPEG sampled {sampling} (TIFFRGBAImage has no case)")
        sh, sv = sampling[0]
        if (sh, sv) == (4, 4) and -(-w // 4) % 2:
            raise _refused("4x4 YCbCr at an odd count of blocks across (libtiff reads its "
                           "strips short)")
        px = jpeg.decode_jpeg(stream, colour="box")
        if px.shape[0] < h or px.shape[1] < w:
            raise ValueError(f"an old-style JPEG of {px.shape[1]}x{px.shape[0]} in a TIFF of "
                             f"{w}x{h}")
        px = px[:h, :w]
        return _ycbcr_to_rgb(px[:, :, 0], px[:, :, 1], px[:, :, 2], tags)
    sh, sv = (tuple(tags.get(530, ())) + (2, 2)[len(tags.get(530, ())):])[:2]
    if (sh, sv) not in _RGBA_SAMPLINGS:
        raise _refused(f"YCbCr subsampling {(sh, sv)} (TIFFRGBAImage has no case for it)")
    if (sh, sv) == (4, 4) and -(-w // 4) % 2:
        raise _refused("4x4 YCbCr at an odd count of blocks across (libtiff reads its strips "
                       "short)")
    if one(317, 1) != 1:
        raise _refused("a predictor on subsampled YCbCr samples")
    across = -(-w // sh)
    unit = sh * sv + 2
    rps = min(one(278, h) or h, h)
    offsets, counts = tags[273], tags.get(279)
    y_plane = np.zeros((-(-h // sv) * sv, across * sh), np.uint8)
    c_planes = np.zeros((2, -(-h // sv), across), np.uint8)
    for k, y0 in enumerate(range(0, h, rps)):
        if counts is None or k >= len(offsets) or k >= len(counts):
            raise ValueError("a YCbCr TIFF without a strip's offset or byte count")
        blocks = -(-min(rps, h - y0) // sv)
        size = blocks * across * unit
        off = offsets[k]
        if off > len(data):
            raise ValueError("a TIFF strip or tile lies past the file")
        raw = _decompress(compression, data[off:min(off + counts[k], len(data))], size)
        u = np.frombuffer(raw, np.uint8, size).reshape(blocks, across, unit)
        b0 = y0 // sv
        y_plane[b0 * sv:(b0 + blocks) * sv] = u[:, :, :sh * sv].reshape(
            blocks, across, sv, sh).transpose(0, 2, 1, 3).reshape(blocks * sv, across * sh)
        c_planes[:, b0:b0 + blocks] = u[:, :, sh * sv:].transpose(2, 0, 1)
    cb, cr = (np.repeat(np.repeat(c, sv, 0), sh, 1)[:h, :w] for c in c_planes)
    return _ycbcr_to_rgb(y_plane[:h, :w], cb, cr, tags)


def _convert(img: np.ndarray, kind: str, bits: int, tags: dict) -> tuple[np.ndarray, str]:
    if kind in ("signed", "unsigned32"):
        return img[:, :, 0].astype(np.int32), "I"
    if kind == "float":
        return np.ascontiguousarray(img[:, :, 0]), "F"
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
    if kind == "lab":
        return np.ascontiguousarray(top[:, :, :3]), "LAB"
    if kind == "lab planar":
        return top[:, :, :3] ^ np.array([0, 128, 128], np.uint8), "LAB"
    rgb = top[:, :, :3]
    if kind == "rgba_premultiplied":
        a = top[:, :, 3:4].astype(np.int32)
        un = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, un)).astype(np.uint8)
    return np.ascontiguousarray(rgb), "RGB"
