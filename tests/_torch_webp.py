"""Helpers for the tests of the port's WebP decoder: seeded images, the
matrix of WebP files the decoder is held to, and libwebp itself through
ctypes. `chip_smoke.py` loads this file by path for the same matrix.

libwebp is the library that Pillow bundles (`pillow.libs/libwebp-*.so*`,
which needs its `libsharpyuv` loaded first with RTLD_GLOBAL), else the
system's (`ctypes.util.find_library("webp")`). Through it the tests write
what PIL's `save` cannot select (the simple loop filter, the sharpness, the
segment and token partition counts, the noise shaping, the alpha filter),
read a lossy file's Y/U/V planes (`WebPDecodeYUV`) and read libwebp's
constant tables from its bytes. `load()` gives None where no libwebp loads,
and the tests that need it skip with that reason.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os

import numpy as np

WEBP_ENCODER_ABI_VERSION = 0x020F  # libwebp checks the major byte only


def field(seed: int, h: int, w: int, channels: int = 3, noise: float = 18.0) -> np.ndarray:
    """A smooth field per channel, with noise in every third 24-pixel tile
    and a flat rectangle in the lower right: busy, smooth and empty
    macroblocks, so that the 4x4 and 16x16 predictions, the skip flag and
    both filters occur."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    busy = (xx // 24 + yy // 24) % 3 == 0
    planes = []
    for _ in range(channels):
        a, b, phase = rs.uniform(0.02, 0.3, 3)
        planes.append(127 + 100 * np.sin(a * xx + phase) * np.cos(b * yy) * np.where(busy, 1, 0.2)
                      + rs.normal(0, noise, (h, w)) * busy)
    out = np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)
    out[h // 2:, w // 2:] = rs.randint(0, 256, channels)
    return out


def few_colours(seed: int, h: int, w: int, n: int) -> np.ndarray:
    """An RGB image of at most n colours, in blobs (a palette image)."""
    rs = np.random.RandomState(seed)
    palette = rs.randint(0, 256, (n, 3)).astype(np.uint8)
    index = (field(seed, h, w, 1, noise=30.0)[:, :, 0].astype(np.int64) * n) // 256
    return palette[np.clip(index, 0, n - 1)]


class WebPConfig(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float if name in ("quality", "target_PSNR") else ctypes.c_int)
                for name in (
                    "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
                    "segments", "sns_strength", "filter_strength", "filter_sharpness",
                    "filter_type", "autofilter", "alpha_compression", "alpha_filtering",
                    "alpha_quality", "pass_", "show_compressed", "preprocessing", "partitions",
                    "partition_limit", "emulate_jpeg_size", "thread_level", "low_memory",
                    "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin",
                    "qmax")] + [("_reserved", ctypes.c_uint32 * 32)]


class WebPPicture(ctypes.Structure):
    _fields_ = [
        ("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
        ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
        ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3),
        ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
        ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
        ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
        ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
        ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p), ("pad5", ctypes.c_void_p),
        ("pad6", ctypes.c_uint32 * 8), ("memory_", ctypes.c_void_p),
        ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2),
        ("_reserved", ctypes.c_uint32 * 32),
    ]


class WebPAuxStats(ctypes.Structure):
    """What the encoder used: macroblock kinds, segments, lossless features."""
    _fields_ = [
        ("coded_size", ctypes.c_int), ("PSNR", ctypes.c_float * 5),
        ("block_count", ctypes.c_int * 3),  # intra 4x4, intra 16x16, skipped
        ("header_bytes", ctypes.c_int * 2), ("residual_bytes", ctypes.c_int * 12),
        ("segment_size", ctypes.c_int * 4), ("segment_quant", ctypes.c_int * 4),
        ("segment_level", ctypes.c_int * 4), ("alpha_data_size", ctypes.c_int),
        ("layer_data_size", ctypes.c_int),
        ("lossless_features", ctypes.c_uint32),  # predictor, cross-colour, subtract-green, palette
        ("histogram_bits", ctypes.c_int), ("transform_bits", ctypes.c_int),
        ("cache_bits", ctypes.c_int), ("palette_size", ctypes.c_int),
        ("_reserved", ctypes.c_uint32 * 32),
    ]


class WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 8)]


_loaded: list = []


def libwebp_path() -> str | None:
    """The file of the libwebp that `load` opens."""
    lib = load()
    return None if lib is None else lib._name


def load() -> ctypes.CDLL | None:
    if not _loaded:
        _loaded.append(_load())
    return _loaded[0]


def _load() -> ctypes.CDLL | None:
    candidates = []
    try:
        import PIL

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        for sharp in sorted(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))):
            ctypes.CDLL(sharp, mode=ctypes.RTLD_GLOBAL)
        candidates += sorted(glob.glob(os.path.join(libs, "libwebp-*.so*")))
    except (ImportError, OSError):
        pass
    found = ctypes.util.find_library("webp")
    if found:
        candidates.append(found)
    for path in candidates:
        try:
            lib = ctypes.CDLL(path)
            lib.WebPEncode, lib.WebPDecodeYUV  # the entries the tests call
        except (OSError, AttributeError):
            continue
        _declare(lib)
        return lib
    return None


def _declare(lib) -> None:
    lib.WebPConfigInitInternal.argtypes = [ctypes.POINTER(WebPConfig), ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int]
    lib.WebPValidateConfig.argtypes = [ctypes.POINTER(WebPConfig)]
    lib.WebPPictureInitInternal.argtypes = [ctypes.POINTER(WebPPicture), ctypes.c_int]
    for name in ("WebPPictureImportRGB", "WebPPictureImportRGBA"):
        getattr(lib, name).argtypes = [ctypes.POINTER(WebPPicture), ctypes.c_void_p, ctypes.c_int]
    lib.WebPPictureFree.argtypes = [ctypes.POINTER(WebPPicture)]
    lib.WebPPictureFree.restype = None
    lib.WebPMemoryWriterInit.argtypes = [ctypes.POINTER(WebPMemoryWriter)]
    lib.WebPMemoryWriterInit.restype = None
    lib.WebPEncode.argtypes = [ctypes.POINTER(WebPConfig), ctypes.POINTER(WebPPicture)]
    lib.WebPDecodeYUV.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + [
        ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.POINTER(ctypes.c_void_p)] * 2 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.WebPDecodeYUV.restype = ctypes.c_void_p
    lib.WebPFree.argtypes = [ctypes.c_void_p]
    lib.WebPFree.restype = None
    lib.WebPGetDecoderVersion.restype = ctypes.c_int


def version() -> str:
    v = load().WebPGetDecoderVersion()
    return f"{v >> 16}.{(v >> 8) & 0xff}.{v & 0xff}"


def encode(pixels: np.ndarray, *, quality: float = 75.0, method: int = 4,
           **fields) -> tuple[bytes, WebPAuxStats]:
    """A WebP file of (H, W, 3) RGB or (H, W, 4) RGBA uint8 pixels, written by
    libwebp's WebPEncode with its default config and `fields` set on it
    (`WebPConfig`'s names: filter_type, filter_sharpness, segments, ...),
    and the encoder's statistics of it."""
    lib = load()
    config = WebPConfig()
    if not lib.WebPConfigInitInternal(ctypes.byref(config), 0, quality, WEBP_ENCODER_ABI_VERSION):
        raise RuntimeError("WebPConfigInit failed")
    # the layout check: libwebp's defaults where this structure puts them
    assert (config.method, config.segments, config.filter_strength, config.qmax) == (4, 4, 60, 100)
    config.method = method
    for name, value in fields.items():
        if not hasattr(config, name) or name.startswith("_"):
            raise KeyError(name)
        setattr(config, name, value)
    if not lib.WebPValidateConfig(ctypes.byref(config)):
        raise ValueError(f"libwebp refuses the config {fields}")
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = pixels.shape
    pic = WebPPicture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), WEBP_ENCODER_ABI_VERSION):
        raise RuntimeError("WebPPictureInit failed")
    pic.use_argb = int(bool(config.lossless))
    pic.width, pic.height = w, h
    writer = WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    stats = WebPAuxStats()
    pic.stats = ctypes.cast(ctypes.pointer(stats), ctypes.c_void_p)
    try:
        importer = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
        if not importer(ctypes.byref(pic), pixels.ctypes.data, w * c):
            raise RuntimeError("WebPPictureImport failed")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
        pic.custom_ptr = ctypes.cast(ctypes.pointer(writer), ctypes.c_void_p)
        if not lib.WebPEncode(ctypes.byref(config), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed with error {pic.error_code}")
        data = ctypes.string_at(writer.mem, writer.size)
        assert stats.coded_size == len(data)  # the layout check of WebPAuxStats
        return data, stats
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPFree(writer.mem)


def decode_yuv(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """libwebp's cropped Y, U and V planes of a lossy file (WebPDecodeYUV)."""
    lib = load()
    w, h, stride, uv_stride = (ctypes.c_int() for _ in range(4))
    u, v = ctypes.c_void_p(), ctypes.c_void_p()
    y = lib.WebPDecodeYUV(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(u),
                          ctypes.byref(v), ctypes.byref(stride), ctypes.byref(uv_stride))
    if not y:
        raise ValueError("WebPDecodeYUV failed")
    try:
        def plane(ptr, rows, cols, step):
            raw = np.frombuffer(ctypes.string_at(ptr, step * (rows - 1) + cols), np.uint8)
            return np.lib.stride_tricks.as_strided(raw, (rows, cols), (step, 1)).copy()

        uh, uw = (h.value + 1) // 2, (w.value + 1) // 2
        return (plane(y, h.value, w.value, stride.value), plane(u.value, uh, uw, uv_stride.value),
                plane(v.value, uh, uw, uv_stride.value))
    finally:
        lib.WebPFree(y)


def library_bytes() -> bytes:
    """The bytes of the libwebp file that `load` opened."""
    with open(libwebp_path(), "rb") as f:
        return f.read()


class _BoolDecoder:
    """RFC 6386's boolean decoder (section 7.3), to read a frame header."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value, self.range, self.count = (data[0] << 8) | data[1], 255, 0

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            self.range -= split
            self.value -= split << 8
            out = 1
        else:
            self.range = split
            out = 0
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
        return out

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v


def vp8_header(data: bytes) -> dict:
    """The segment, filter and partition fields of the first 'VP8 ' chunk's
    frame header (RFC 6386 section 9.2-9.5)."""
    at = data.index(b"VP8 ") + 8
    bd = _BoolDecoder(data[at + 10:])
    bd.literal(2)  # colour space, clamping
    segmentation = bd.literal(1)
    if segmentation:
        update_map = bd.literal(1)
        if bd.literal(1):
            bd.literal(1)
            for bits in (7,) * 4 + (6,) * 4:
                if bd.literal(1):
                    bd.literal(bits + 1)
        if update_map:
            for _ in range(3):
                if bd.literal(1):
                    bd.literal(8)
    simple, level, sharpness = bd.literal(1), bd.literal(6), bd.literal(3)
    if bd.literal(1) and bd.literal(1):
        for _ in range(8):
            if bd.literal(1):
                bd.literal(7)
    return {"segmentation": segmentation, "simple": simple, "level": level,
            "sharpness": sharpness, "partitions": 1 << bd.literal(2)}


# ---------------------------------------------------------------------------
# The matrix of files: PIL writes them (the reference's own writer), and
# libwebp's WebPEncode writes what PIL cannot select.

SIZES = [(1, 1), (2, 3), (7, 5), (16, 16), (17, 33), (341, 256), (256, 341), (40, 1100)]  # (H, W)
QUALITIES = [0, 10, 50, 75, 90, 100]
METHODS = [0, 4, 6]


def pil_save(image, **save) -> bytes:
    """WebP bytes of a PIL image or a uint8 array, as PIL's `save` writes them."""
    import io

    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    buf = io.BytesIO()
    image.save(buf, "WEBP", **save)
    return buf.getvalue()


def lossy_file(size: tuple[int, int], quality: int, method: int) -> bytes:
    return pil_save(field(quality + size[1], *size), quality=quality, method=method)


def with_alpha(rgb: np.ndarray) -> np.ndarray:
    """RGBA whose alpha holds ~30% zeros and random levels elsewhere."""
    rs = np.random.RandomState(rgb.shape[1])
    alpha = np.where(rs.rand(*rgb.shape[:2]) < 0.3, 0, rs.randint(1, 256, rgb.shape[:2]))
    return np.concatenate([rgb, alpha[:, :, None].astype(np.uint8)], -1)


# mode -> (what the image holds, PIL's save options for it)
MODES = {
    "L": ("L", {}),
    "RGB": ("RGB", {}),
    "RGBA": ("RGBA", {}),
    "RGBA-exact": ("RGBA", {"exact": True}),
    "icc": ("RGB", {"icc_profile": b"\x01\x02not a real profile" * 5}),
    "exif-xmp": ("RGB", {"exif": b"Exif\0\0II*\0" + bytes(21),
                         "xmp": b"<x:xmpmeta>seeded</x:xmpmeta>"}),
    "RGBA-icc-exif-xmp": ("RGBA", {"icc_profile": b"icc" * 9,
                                   "exif": b"Exif\0\0MM\0*" + bytes(20), "xmp": b"<x/>"}),
}


def mode_file(mode: str, lossless: bool) -> bytes:
    kind, save = MODES[mode]
    rgb = field(len(mode), 29, 37)
    pixels = rgb[:, :, 0] if kind == "L" else with_alpha(rgb) if kind == "RGBA" else rgb
    return pil_save(pixels, quality=80, lossless=lossless, **save)


LOSSLESS_METHODS = [0, 3, 6]
LOSSLESS_QUALITIES = [0, 50, 100]


def lossless_file(method: int, quality: int) -> bytes:
    return pil_save(field(method + quality, 53, 61), lossless=True, quality=quality,
                    method=method)


PALETTE_COLOURS = [2, 3, 4, 16, 200]  # bundling 8, 4, 4, 2 and 1 indices a byte
PALETTE_METHODS = [0, 6]


def palette_file(colours: int, method: int) -> bytes:
    return pil_save(few_colours(colours, 45, 67, colours), lossless=True, quality=70,
                    method=method)


def _bordered(seed: int) -> np.ndarray:
    """RGBA with a transparent black border: the encoder crops frame 0 to the
    rest, which then lies at an offset on the canvas."""
    rgba = np.zeros((40, 52, 4), np.uint8)
    rgba[6:30, 10:44, :3] = field(seed, 24, 34)
    rgba[6:30, 10:44, 3] = 255
    return rgba


# kind -> (frames, PIL's save options)
ANIMATIONS = {
    "lossy": (lambda: [field(1 + i, 33, 45) for i in range(3)], {"quality": 70}),
    "lossless": (lambda: [field(4 + i, 33, 45) for i in range(2)], {"lossless": True}),
    "allow_mixed": (lambda: [field(6 + i, 33, 45) for i in range(3)],
                    {"allow_mixed": True, "quality": 60}),
    "offset": (lambda: [_bordered(8), _bordered(9)], {"quality": 75}),
}


def animation_file(kind: str) -> bytes:
    from PIL import Image

    make, save = ANIMATIONS[kind]
    frames = [Image.fromarray(f) for f in make()]
    return pil_save(frames[0], save_all=True, append_images=frames[1:], duration=40, **save)


def le24(v: int) -> bytes:
    return v.to_bytes(3, "little")


def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + len(payload).to_bytes(4, "little") + payload + b"\0" * (len(payload) & 1)


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def payload(data: bytes, tag: bytes) -> bytes:
    """The payload of the first chunk `tag`."""
    at = data.index(tag)
    return data[at + 8:at + 8 + int.from_bytes(data[at + 4:at + 8], "little")]


def built_animation() -> tuple[bytes, bytes]:
    """An ANIM/ANMF file built around a still lossy bitstream: a 16x10 frame at
    (4, 2) on a 30x20 canvas, and the still file."""
    still = pil_save(field(11, 10, 16), quality=85)
    anmf = le24(2) + le24(1) + le24(15) + le24(9) + le24(100) + b"\x02"
    vp8x = bytes([0x02, 0, 0, 0]) + le24(29) + le24(19)
    data = riff(chunk(b"VP8X", vp8x), chunk(b"ANIM", bytes(6)),
                chunk(b"ANMF", anmf + chunk(b"VP8 ", payload(still, b"VP8 "))))
    return data, still


ENCODER_CASES = (
    [{"filter_type": t, "filter_sharpness": s} for t in (0, 1) for s in range(8)]
    + [{"filter_strength": 0}, {"filter_strength": 100, "filter_type": 0}, {"autofilter": 1}]
    + [{"segments": s} for s in (1, 2, 3, 4)]
    # libwebp honours `partitions` at methods 0-2 or with low_memory only
    + [{"partitions": p, "method": 2} for p in (0, 1, 2, 3)]
    + [{"partitions": 3, "low_memory": 1, "filter_type": 0}]
    + [{"sns_strength": s} for s in (0, 100)]
    + [{"alpha_filtering": a, "exact": e, "rgba": True} for a in (0, 1, 2) for e in (0, 1)]
)
ENCODER_QUALITIES = [5, 60, 95]


def encoder_file(case: dict, quality: int) -> tuple[bytes, WebPAuxStats]:
    """A 70x90 field (RGBA where the case says "rgba") through WebPEncode."""
    case = dict(case)
    rgba = case.pop("rgba", False)
    pixels = field(7 * quality, 70, 90)
    return encode(with_alpha(pixels) if rgba else pixels, quality=quality, **case)


def _valid() -> bytes:
    return pil_save(field(3, 20, 24), quality=80)


def _lossless() -> bytes:
    return pil_save(field(5, 20, 24), lossless=True)


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + le24(w - 1) + le24(h - 1))


def _unpadded_odd() -> bytes:
    """A VP8 chunk of odd size whose pad byte is missing at the end."""
    vp8 = payload(_valid(), b"VP8 ")
    vp8 = vp8 if len(vp8) % 2 else vp8 + b"\0"
    data = riff(chunk(b"VP8 ", vp8))[:-1]
    return data[:4] + (len(data) - 8).to_bytes(4, "little") + data[8:]


def _with_byte(data: bytes, at: int, value: int) -> bytes:
    return data[:at] + bytes([value]) + data[at + 1:]


# kind -> a malformed or truncated file
BROKEN = {
    "truncated-header": lambda: _valid()[:10],
    "truncated-half": lambda: _valid()[: len(_valid()) // 2],
    "truncated-last-byte": lambda: _valid()[:-1],
    "riff-size-too-large": lambda: _valid()[:4] + len(_valid()).to_bytes(4, "little") + _valid()[8:],
    "not-webp": lambda: _valid()[:8] + b"WEBQ" + _valid()[12:],
    "unknown-first-chunk": lambda: riff(chunk(b"ABCD", b"xy"),
                                        chunk(b"VP8 ", payload(_valid(), b"VP8 "))),
    "bad-start-code": lambda: riff(chunk(b"VP8 ", _with_byte(payload(_valid(), b"VP8 "), 5, 0x2B))),
    "inter-frame": lambda: riff(chunk(b"VP8 ", _with_byte(payload(_valid(), b"VP8 "), 0,
                                                         payload(_valid(), b"VP8 ")[0] | 1))),
    "token-data-cut": lambda: riff(chunk(b"VP8 ", payload(_valid(), b"VP8 ")[:-40])),
    "canvas-disagrees": lambda: riff(_vp8x(0, 21, 20), chunk(b"VP8 ", payload(_valid(), b"VP8 "))),
    "vp8x-reserved-bits": lambda: riff(_vp8x(1, 24, 20), chunk(b"VP8 ", payload(_valid(), b"VP8 "))),
    "anmf-before-anim": lambda: riff(
        _vp8x(2, 24, 20),
        chunk(b"ANMF", bytes(6) + le24(23) + le24(19) + bytes(4)
              + chunk(b"VP8 ", payload(_valid(), b"VP8 "))),
        chunk(b"ANIM", bytes(6))),
    "odd-chunk-unpadded": _unpadded_odd,
    "lossless-version": lambda: riff(chunk(b"VP8L", _with_byte(
        payload(_lossless(), b"VP8L"), 4, payload(_lossless(), b"VP8L")[4] | 0x20))),
    "lossless-cut": lambda: riff(chunk(b"VP8L", payload(_lossless(), b"VP8L")[:60])),
    "lossless-signature": lambda: riff(chunk(b"VP8L", _with_byte(payload(_lossless(), b"VP8L"), 0, 0x2E))),
}


def matrix() -> list[tuple[str, bytes]]:
    """(label, bytes) of every well-formed file of the matrix: the lossy
    sizes x qualities x methods, the modes and metadata chunks, the
    lossless fields and palettes, the animations, and (where libwebp loads)
    the encoder cases."""
    files = [(f"lossy {h}x{w} q{q} m{m}", lossy_file((h, w), q, m))
             for h, w in SIZES for q in QUALITIES for m in METHODS]
    files += [(f"{mode} {'lossless' if ll else 'lossy'}", mode_file(mode, ll))
              for mode in MODES for ll in (False, True)]
    files += [(f"lossless m{m} q{q}", lossless_file(m, q))
              for m in LOSSLESS_METHODS for q in LOSSLESS_QUALITIES]
    files += [(f"palette {n} m{m}", palette_file(n, m))
              for n in PALETTE_COLOURS for m in PALETTE_METHODS]
    files += [(f"animation {kind}", animation_file(kind)) for kind in ANIMATIONS]
    files.append(("animation built", built_animation()[0]))
    if load() is not None:
        files += [(f"encoder {case} q{q}", encoder_file(case, q)[0])
                  for case in ENCODER_CASES for q in ENCODER_QUALITIES]
    return files
