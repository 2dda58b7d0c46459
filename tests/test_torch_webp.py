"""The port's WebP decoder (`ddgan_torch.data.webp`, C++ built with the host
compiler at first use) against PIL, bit for bit: `decode_webp(data)` must
equal `Image.open(f).convert("RGB")` with no tolerance.

The files are the matrix of `tests/_torch_webp.py`, written by PIL and, for
what PIL's `save` cannot select, by libwebp's own encoder through ctypes:
lossy at qualities 0-100 and methods 0, 4 and 6 over sizes from 1x1 to one
side past 1024; "L", "RGB" and "RGBA" (VP8X + ALPH, `exact` on and off)
with ICC, EXIF and XMP chunks; the simple and the normal loop filter at
every sharpness, no filter, 1-4 segments, 1-8 token partitions, noise
shaping and the alpha filters; lossless at several methods and qualities
on natural fields (predictor, cross-colour, subtract-green, colour cache)
and on images of 2, 3, 4, 16 and 200 colours (every bundling width); frame
0 of animations, one of them offset on its canvas and one with
`allow_mixed`. The cropped Y/U/V planes are held against libwebp's
`WebPDecodeYUV`, the constant tables against their bytes in libwebp, and
malformed or truncated files must raise ValueError.
"""

import io
import struct
import threading

import numpy as np
import pytest
from PIL import Image

import _torch_webp as lw
from ddgan_torch.data import webp
from ddgan_torch.data.webp import decode_webp, decode_webp_planes
from ddgan_torch.utils import decode_images, encode_png

needs_libwebp = pytest.mark.skipif(lw.load() is None, reason="no libwebp loads through ctypes")


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _assert_pil(data: bytes) -> np.ndarray:
    want = _pil_rgb(data)
    got = decode_webp(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _chunks(data: bytes) -> list[bytes]:
    """The fourccs of the top-level chunks."""
    out, at = [], 12
    while at + 8 <= len(data):
        size = struct.unpack("<I", data[at + 4:at + 8])[0]
        out.append(data[at:at + 4])
        at += 8 + size + (size & 1)
    return out


@pytest.mark.parametrize("method", lw.METHODS)
@pytest.mark.parametrize("quality", lw.QUALITIES)
@pytest.mark.parametrize("size", lw.SIZES, ids=[f"{h}x{w}" for h, w in lw.SIZES])
def test_lossy_matrix_equals_pil(size, quality, method):
    data = lw.lossy_file(size, quality, method)
    assert _chunks(data) == [b"VP8 "]
    _assert_pil(data)


@pytest.mark.parametrize("lossless", [False, True], ids=["lossy", "lossless"])
@pytest.mark.parametrize("mode", list(lw.MODES))
def test_modes_and_metadata_chunks_equal_pil(mode, lossless):
    data = lw.mode_file(mode, lossless)
    kind, save = lw.MODES[mode]
    kinds = _chunks(data)
    assert (b"VP8L" if lossless else b"VP8 ") in kinds  # EXIF and XMP follow the image
    if (kind == "RGBA" and not lossless) or save.keys() - {"exact"}:
        assert kinds[0] == b"VP8X"  # a lossless image carries its own alpha
    assert (b"ALPH" in kinds) == (kind == "RGBA" and not lossless)
    for key, tag in (("icc_profile", b"ICCP"), ("exif", b"EXIF"), ("xmp", b"XMP ")):
        assert (tag in kinds) == (key in save)
    _assert_pil(data)


def _case_id(case):
    return "-".join(f"{k}{v}" for k, v in case.items())


@needs_libwebp
@pytest.mark.parametrize("quality", lw.ENCODER_QUALITIES)
@pytest.mark.parametrize("case", lw.ENCODER_CASES, ids=[_case_id(c) for c in lw.ENCODER_CASES])
def test_encoder_options_equal_pil(case, quality):
    """Files of libwebp's WebPEncode with what PIL cannot select; the frame
    header read back (RFC 6386's boolean decoder in the helper) shows the
    filter, the sharpness and the partition count asked for."""
    data, stats = lw.encoder_file(case, quality)
    header = lw.vp8_header(data)
    if header["level"]:
        assert header["simple"] == (case.get("filter_type", 1) == 0)
        assert header["sharpness"] == case.get("filter_sharpness", 0)
    if case.get("filter_strength", 1) == 0:
        assert header["level"] == 0
    if "partitions" in case:
        assert header["partitions"] == 1 << case["partitions"]
    if "segments" in case:
        assert sum(n > 0 for n in stats.segment_size) <= case["segments"]
        assert header["segmentation"] == (case["segments"] > 1)
    assert (b"ALPH" in _chunks(data)) == ("rgba" in case)
    _assert_pil(data)


@needs_libwebp
def test_the_lossy_cases_cover_every_macroblock_kind_and_filter():
    """Across the encoder cases: 4x4 and 16x16 predicted macroblocks and
    skipped ones, 1-4 segments in use, both filters and none."""
    kinds, segments, filters = np.zeros(3, int), set(), set()
    for case in lw.ENCODER_CASES:
        for quality in lw.ENCODER_QUALITIES:
            data, stats = lw.encoder_file(case, quality)
            kinds += np.array(stats.block_count)
            segments.add(sum(n > 0 for n in stats.segment_size))
            header = lw.vp8_header(data)
            filters.add("off" if header["level"] == 0 else "simple" if header["simple"] else "normal")
    assert (kinds > 0).all()
    assert segments == {1, 2, 3, 4}
    assert filters == {"off", "simple", "normal"}


@pytest.mark.parametrize("quality", lw.LOSSLESS_QUALITIES)
@pytest.mark.parametrize("method", lw.LOSSLESS_METHODS)
def test_lossless_natural_fields_equal_pil(method, quality):
    data = lw.lossless_file(method, quality)
    assert _chunks(data) == [b"VP8L"]
    _assert_pil(data)


@needs_libwebp
def test_lossless_cases_cover_every_transform_and_the_colour_cache():
    """libwebp's statistics of the natural-field cases, written through
    WebPEncode: the predictor, cross-colour and subtract-green transforms
    and a colour cache occur."""
    features, cache = 0, 0
    for method in lw.LOSSLESS_METHODS:
        for quality in lw.LOSSLESS_QUALITIES:
            data, stats = lw.encode(lw.field(method + quality, 53, 61), quality=quality,
                                    method=method, lossless=1)
            _assert_pil(data)
            features |= stats.lossless_features
            cache = max(cache, stats.cache_bits)
    assert features & 0b0111 == 0b0111 and cache > 0


@pytest.mark.parametrize("method", lw.PALETTE_METHODS)
@pytest.mark.parametrize("colours", lw.PALETTE_COLOURS)
def test_lossless_palettes_equal_pil(colours, method):
    """Colour indexing, bundling 8, 4 or 2 indices a byte (2, 3-4, 5-16
    colours) or none (200); the palette transform is the first one read."""
    data = lw.palette_file(colours, method)
    bits = int.from_bytes(lw.payload(data, b"VP8L")[5:7], "little")
    assert bits & 1 and (bits >> 1) & 3 == 3  # a transform, colour indexing
    pixels = lw.few_colours(colours, 45, 67, colours)
    assert ((bits >> 3) & 0xff) + 1 == len(np.unique(pixels.reshape(-1, 3), axis=0))
    _assert_pil(data)


@pytest.mark.parametrize("kind", list(lw.ANIMATIONS))
def test_animation_frame0_equals_pil(kind):
    data = lw.animation_file(kind)
    assert {b"ANIM", b"ANMF"} <= set(_chunks(data))
    got = _assert_pil(data)
    if kind == "offset":
        anmf = lw.payload(data, b"ANMF")
        x, y = 2 * int.from_bytes(anmf[0:3], "little"), 2 * int.from_bytes(anmf[3:6], "little")
        assert (x, y) != (0, 0) and not got[:y].any() and not got[:, :x].any()


def test_a_frame_at_an_offset_of_a_built_animation_equals_pil():
    """An ANIM/ANMF file built around a still lossy bitstream: a 16x10 frame at
    (4, 2) on a 30x20 canvas, the rest transparent black."""
    data, still = lw.built_animation()
    got = _assert_pil(data)
    np.testing.assert_array_equal(got[2:12, 4:20], decode_webp(still))
    assert got.sum() == got[2:12, 4:20].sum()


PLANE_CASES = [((1, 1), {}), ((7, 5), {"filter_type": 0}), ((17, 33), {"filter_sharpness": 5}),
               ((256, 341), {}), ((65, 48), {"filter_type": 0, "segments": 1}),
               ((33, 66), {"partitions": 3, "method": 2})]


@needs_libwebp
@pytest.mark.parametrize("size,case", PLANE_CASES, ids=[f"{h}x{w}" for (h, w), _ in PLANE_CASES])
def test_planes_equal_libwebp_decode_yuv(size, case):
    """The VP8 core apart from the output stage: cropped Y, U and V."""
    data, _ = lw.encode(lw.field(size[0], *size), quality=40, **case)
    for got, want in zip(decode_webp_planes(data), lw.decode_yuv(data)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# table -> (a row as it stands in libwebp, the bytes from the table's start
# to it), or None for a short table found whole
TABLES = {
    "coeffs_proba0": (bytes([253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128]), 33),
    "coeffs_update_proba": (bytes([176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255]), 33),
    "bmodes_proba": (bytes([231, 120, 48, 89, 115, 113, 120, 152, 112]), 0),
    "dc_table": (bytes([4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17]), 0),
    "ac_table": (struct.pack("<16H", *range(4, 20)), 0),
    "code_to_plane": (bytes([0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1A]), 0),
    "zigzag": None, "bands": None, "cat3": None, "cat4": None, "cat5": None, "cat6": None,
    "code_length_order": None,
}


@needs_libwebp
@pytest.mark.parametrize("name", list(TABLES))
def test_tables_equal_libwebps_bytes(name):
    """Each constant table against libwebp's: at an anchor row located by
    content, or (the short tables) found whole."""
    lib = lw.library_bytes()
    ours = webp.table(name)
    if TABLES[name] is None:
        assert ours in lib
        return
    anchor, back = TABLES[name]
    starts = []
    at = lib.find(anchor)
    while at >= 0:
        starts.append(at - back)
        at = lib.find(anchor, at + 1)
    assert starts, f"the anchor row of {name} is not in {lw.libwebp_path()}"
    assert any(lib[s:s + len(ours)] == ours for s in starts)


@pytest.mark.parametrize("kind", list(lw.BROKEN))
def test_malformed_files_raise_value_error(kind):
    data = lw.BROKEN[kind]()
    with pytest.raises(ValueError, match="malformed WebP"):
        decode_webp(data)
    with pytest.raises(Exception):  # and PIL refuses them too
        _pil_rgb(data)


def test_decode_images_reads_webp_beside_png_and_jpeg():
    """`utils.decode_images` routes RIFF....WEBP to the WebP decoder in a
    mixed batch; grey WebP comes back as RGB, as `.convert("RGB")` gives."""
    rgb = lw.field(2, 19, 23)
    jpeg = io.BytesIO()
    Image.fromarray(rgb).save(jpeg, "JPEG", quality=90)
    datas = [lw.pil_save(rgb, quality=70), encode_png(rgb), jpeg.getvalue(),
             lw.pil_save(rgb[:, :, 0], lossless=True)]
    for got, data in zip(decode_images(datas), datas):
        np.testing.assert_array_equal(got, _pil_rgb(data))


def test_threads_decode_alike():
    """The library call releases the GIL: four threads decode together and
    agree with one thread."""
    datas = [lw.pil_save(lw.field(i, 64, 80), quality=60 + i, lossless=i % 3 == 0)
             for i in range(12)]
    want = [decode_webp(d) for d in datas]
    got = [None] * len(datas)

    def work(k):
        for i in range(k, len(datas), 4):
            got[i] = decode_webp(datas[i])

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
