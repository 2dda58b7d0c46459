"""The port's JPEG decoder (`ddgan_torch.data.jpeg`, C++ built with the
host compiler at first use) against PIL, bit for bit, on JPEGs that PIL
writes into tmp_path: quality 50, 75, 95 and 100; 4:4:4, 4:2:2, 4:2:0 and
grey; sizes 1x1, 7x9, 17x33 and 255x257 (not multiples of the MCU);
optimized Huffman tables; restart markers; 16-bit DQT tables. Then the
matrix of `tests/_torch_imagewriters.py:jpeg_matrix`: progressive files
(PIL's scan script) in every layout and size; arithmetic-coded ones,
sequential and progressive, re-encoded from PIL's baseline files by
`tests/_torch_jpeg_arith.py` (which PIL decodes to the baseline pixels);
restart markers and DAC conditioning; CMYK, YCCK and RGB-coded files; the
decoder's Qe table against libjpeg's `jpeg_aritab`. Then the sampling
layouts PIL cannot write, coded by `_torch_imagewriters.jpeg_encode`:
4:4:0, true 4:1:1, 4:1:0, 3x1, 1x3 and mixed chroma ratios (libjpeg's
h1v2 fancy upsampling and its box replication), Huffman- and
arithmetic-coded; and the colour spaces libtiff asks of a JPEG-in-TIFF
strip; lossless files (SOF3) at every predictor and point transform,
with restarts and a scan a component. Files it does not read
(arithmetic-coded lossless, hierarchical, 12-bit, non-integral sampling
ratios, progressive scans libjpeg would smooth) raise
NotImplementedError naming ROADMAP.md Queue 1 item 13i; broken files
raise ValueError.
"""

import functools
import io
import struct

import numpy as np
import pytest
from PIL import Image

import _torch_imagewriters as W
import _torch_jpeg_arith as A
from ddgan_torch.data.jpeg import decode_jpeg
from ddgan_torch.utils import decode_images

SIZES = [(1, 1), (7, 9), (17, 33), (255, 257)]  # (H, W)
QUALITIES = [50, 75, 95, 100]
LAYOUTS = W.JPEG_LAYOUTS
smooth_field = W.smooth_field  # a smooth field per channel plus noise


def _jpeg(tmp_path, layout: str, h: int, w: int, seed: int, **save) -> bytes:
    rs = np.random.RandomState(seed)
    if layout == "L":
        im = Image.fromarray(smooth_field(rs, h, w, 1)[:, :, 0])
    else:
        im = Image.fromarray(smooth_field(rs, h, w, 3))
        save.setdefault("subsampling", LAYOUTS[layout])
    path = tmp_path / f"{layout.replace(':', '')}_{h}x{w}.jpg"
    im.save(path, "JPEG", **save)
    return path.read_bytes()


def _assert_pil(data: bytes) -> np.ndarray:
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_matrix_equals_pil(tmp_path, layout, quality, size):
    data = _jpeg(tmp_path, layout, *size, seed=quality + size[1], quality=quality)
    got = _assert_pil(data)
    assert got.ndim == (2 if layout == "L" else 3)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("save", [dict(optimize=True), dict(restart_marker_blocks=1),
                                  dict(restart_marker_rows=1)],
                         ids=["optimize", "restart_blocks", "restart_rows"])
def test_optimized_tables_and_restart_markers_equal_pil(tmp_path, layout, save):
    data = _jpeg(tmp_path, layout, 37, 45, seed=3, quality=85, **save)
    if "optimize" not in save:
        assert data.count(b"\xff\xdd") == 1 and b"\xff\xd1" in data  # DRI, then RSTn
    _assert_pil(data)


def _dqt_16bit(data: bytes) -> bytes:
    """The same file with each DQT table written at 16-bit precision."""
    out, p = bytearray(data[:2]), 2
    while data[p + 1] != 0xDA:  # up to the first scan
        (length,) = struct.unpack(">H", data[p + 2:p + 4])
        seg = data[p + 4:p + 2 + length]
        if data[p + 1] == 0xDB:
            body = bytearray()
            for k in range(0, len(seg), 65):
                assert seg[k] >> 4 == 0
                body += bytes([0x10 | seg[k] & 15])
                body += b"".join(struct.pack(">H", v) for v in seg[k + 1:k + 65])
            out += b"\xff\xdb" + struct.pack(">H", len(body) + 2) + body
        else:
            out += data[p:p + 2 + length]
        p += 2 + length
    return bytes(out + data[p:])


@pytest.mark.parametrize("layout", ["4:2:0", "L"])
def test_16bit_quantization_tables_equal_pil(tmp_path, layout):
    data = _jpeg(tmp_path, layout, 23, 31, seed=5, quality=60)
    wide = _dqt_16bit(data)
    assert len(wide) > len(data)
    np.testing.assert_array_equal(_assert_pil(wide), decode_jpeg(data))


@pytest.mark.parametrize("what, make", [
    ("progressive", lambda im: (im, dict(progressive=True))),
    ("progressive grey", lambda im: (im.convert("L"), dict(progressive=True))),
    ("CMYK", lambda im: (im.convert("CMYK"), {})),
    ("RGB-coded", lambda im: (im, dict(keep_rgb=True))),
])
def test_layouts_once_refused_equal_pil(what, make):
    im, save = make(Image.fromarray(smooth_field(np.random.RandomState(0), 16, 16, 3)))
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=80, **save)
    _assert_pil(buf.getvalue())


@functools.cache
def _sampling_matrix() -> tuple:
    return tuple(W.jpeg_sampling_matrix(Image, A))


@pytest.mark.parametrize("layout", list(W.JPEG_SAMPLINGS))
def test_sampling_layouts_equal_pil(layout):
    """Each layout at sizes 1x1 to 64x80 and q80 / q95 (a size not a
    multiple of the MCU replicates the component's last real row and
    column, as jdsample.c's context rows do)."""
    cases = [(label, d) for label, d in _sampling_matrix()
             if label.startswith(f"jpeg sampling {layout} q")]
    assert len(cases) == 2 * len(W.JPEG_SAMPLING_SIZES)
    for label, data in cases:
        np.testing.assert_array_equal(_assert_pil(data), decode_images([data])[0], err_msg=label)


@pytest.mark.parametrize("layout", ["4:4:0", "4:1:1"])
@pytest.mark.parametrize("kind", ["sequential", "progressive"])
def test_arithmetic_sampling_layouts_equal_pil(layout, kind):
    cases = [(label, d) for label, d in _sampling_matrix()
             if label.startswith(f"jpeg sampling {layout} arithmetic {kind}")]
    assert cases
    for label, data in cases:
        _assert_pil(data)


@pytest.mark.parametrize("layout", ["4:2:0", "4:2:2", "4:4:4", "L"])
def test_raw_colour_equals_pil_ycbcr_draft(tmp_path, layout):
    """colour="raw" (libjpeg's JCS_UNKNOWN, as libtiff asks for an RGB or
    grey JPEG-in-TIFF strip) gives the upsampled components unconverted:
    what PIL gives when it drafts a YCbCr JPEG as "YCbCr"."""
    data = _jpeg(tmp_path, layout, 21, 35, seed=3, quality=85)
    im = Image.open(io.BytesIO(data))
    if layout != "L":
        im.draft("YCbCr", im.size)
        assert im.mode == "YCbCr"
    np.testing.assert_array_equal(decode_jpeg(data, colour="raw"), np.asarray(im))


def test_ycbcr_colour_converts_whatever_the_markers_say(tmp_path):
    """colour="ycbcr" (libtiff's JPEGCOLORMODE_RGB) converts a file that
    would be taken as RGB-coded (an Adobe marker with transform 0) as the
    same components under a JFIF marker are converted."""
    data = _jpeg(tmp_path, "4:2:0", 19, 27, seed=4, quality=85)
    assert data[2:4] == b"\xff\xe0"  # JFIF, which jdapimin.c reads before Adobe
    rest = data[4 + int.from_bytes(data[4:6], "big"):]
    adobe = data[:2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00" + rest
    assert not np.array_equal(decode_jpeg(adobe), decode_jpeg(data))
    np.testing.assert_array_equal(decode_jpeg(adobe, colour="ycbcr"), decode_jpeg(data))
    with pytest.raises(ValueError, match="YCbCr asked of a JPEG of 1 components"):
        decode_jpeg(_jpeg(tmp_path, "L", 8, 8, seed=5), colour="ycbcr")


def test_more_than_ten_blocks_an_mcu_is_malformed():
    """libjpeg's D_MAX_BLOCKS_IN_MCU: an interleaved scan of 2x2 + 2x2 +
    2x2 blocks is refused by both decoders."""
    data = W.jpeg_encode(smooth_field(np.random.RandomState(2), 16, 16, 3), [(2, 2)] * 3,
                         W.jpeg_tables(Image, 80))
    with pytest.raises(OSError):
        np.asarray(Image.open(io.BytesIO(data)))
    with pytest.raises(ValueError, match="sampling factors too large"):
        decode_jpeg(data)


@functools.cache
def _lossless_matrix() -> tuple:
    return tuple(W.jpeg_lossless_matrix(Image))


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_equals_pil(predictor):
    """Each predictor at point transforms 0 and 2, grey and RGB, with
    restarts and with a scan a component: libjpeg-turbo's undifferencing
    modulo 2^16 and its shift back into 8 bits, and no colour conversion."""
    cases = [(label, d) for label, d in _lossless_matrix()
             if label.startswith(f"jpeg lossless predictor {predictor} ")]
    assert len(cases) == 18
    for label, data in cases:
        _assert_pil(data)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_images([data])[0], want, err_msg=label)


@pytest.mark.parametrize("what", [k for k in W.once_refused(Image) if k.startswith("jpeg")])
def test_files_once_refused_equal_pil(what):
    _assert_pil(W.once_refused(Image)[what])


@pytest.mark.parametrize("what", [k for k in W.refused(Image) if k.startswith("jpeg")])
def test_files_it_does_not_read_raise_naming_item_13(what):
    with pytest.raises(NotImplementedError, match="item 13i"):
        decode_jpeg(W.refused(Image)[what])


@functools.cache
def _matrix() -> tuple:
    return tuple(W.jpeg_matrix(Image, A))


def _matrix_equals_pil(prefix: str) -> None:
    cases = [(label, d) for label, d in _matrix() if label.startswith(prefix)]
    assert cases
    for label, data in cases:
        want = np.asarray(Image.open(io.BytesIO(data)))
        got = decode_jpeg(data)
        assert got.dtype == np.uint8 and got.shape == want.shape, label
        np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_progressive_matrix_equals_pil(layout):
    _matrix_equals_pil(f"jpeg progressive {layout} ")


@pytest.mark.parametrize("kind", ["sequential", "progressive"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_arithmetic_matrix_equals_pil(kind, layout):
    """Every size, restart markers every 2 MCUs, DAC conditioning."""
    _matrix_equals_pil(f"jpeg arithmetic {kind} {layout} ")


@pytest.mark.parametrize("kind", ["CMYK", "YCCK", "RGB-coded"])
def test_cmyk_ycck_and_rgb_coded_equal_pil(kind):
    """CMYK and YCCK come back as PIL's "CMYK" (Adobe inverted), which
    `decode_images` converts as `convert("RGB")` does; RGB-coded files
    (Adobe transform 0, or IDs 'R', 'G', 'B') take no colour transform."""
    _matrix_equals_pil(f"jpeg {kind} ")
    for label, data in _matrix():
        if label.startswith(f"jpeg {kind} "):
            np.testing.assert_array_equal(
                decode_images([data])[0], np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_arithmetic_files_decode_in_pil_to_the_baseline_pixels(tmp_path):
    """The test writer's proof: libjpeg decodes its arithmetic-coded files
    (sequential and progressive, restarts, DAC) to the pixels of the
    baseline file whose coefficients they re-encode."""
    for layout in LAYOUTS:
        data = _jpeg(tmp_path, layout, 23, 41, seed=9, quality=90)
        want = np.asarray(Image.open(io.BytesIO(data)))
        for kw in (dict(), dict(progressive=True), dict(restart=1), dict(progressive=True,
                                                                         restart=3, dac=True)):
            arith = A.to_arithmetic(data, **kw)
            assert (b"\xff\xca" if kw.get("progressive") else b"\xff\xc9") in arith
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(arith))), want)


def test_qe_table_is_libjpegs_jpeg_aritab():
    """The decoder's T.81 Table D.2 against `jpeg_aritab` of the libjpeg
    that PIL bundles (912 bytes: 114 longs), read through ctypes."""
    import ctypes
    import glob
    import os

    import PIL

    from ddgan_torch.data import jpeg

    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                  "libjpeg*.so*"))
    if not libs:
        pytest.skip("this PIL bundles no libjpeg to hold the table against")
    table = (ctypes.c_long * 114).in_dll(ctypes.CDLL(libs[0]), "jpeg_aritab")
    assert ctypes.sizeof(table) == 912
    assert jpeg.aritab() == list(table) == A.QE


def test_broken_files_raise_value_error(tmp_path):
    data = _jpeg(tmp_path, "4:2:0", 16, 16, seed=1, quality=80)
    arith = A.to_arithmetic(data, progressive=True)
    for broken in (b"", b"\xff\xd8\xff\xe0", data[:len(data) // 2], b"\x89PNG" + data[4:],
                   arith[:len(arith) // 2],
                   *[v for k, v in W.broken(Image).items() if k.startswith("jpeg")]):
        with pytest.raises(ValueError, match="malformed JPEG"):
            decode_jpeg(broken)


def test_threads_decode_alike(tmp_path):
    """The loader's prefetch threads call the decoder at once (ctypes
    releases the GIL): every result equals the one-thread decode."""
    from concurrent.futures import ThreadPoolExecutor

    datas = [_jpeg(tmp_path, layout, 40, 48, seed=i, quality=90)
             for i, layout in enumerate(["4:2:0", "4:2:2", "L", "4:4:4"] * 4)]
    want = [decode_jpeg(d) for d in datas]
    with ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(decode_jpeg, datas))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
