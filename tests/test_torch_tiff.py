"""The port's TIFF reader (`ddgan_torch.data.tiff`, tag parsing in numpy,
LZW / PackBits / CCITT / predictor 2 in C++ built with the host compiler
at first use, Deflate and LZMA through zlib and lzma, JPEG strips through
the port's JPEG decoder) against PIL's `Image.open(f).convert("RGB")`,
bit for bit: every layout of `tests/_torch_imagewriters.py`'s
`TIFF_LAYOUTS` (photometric 0, 1, 2, 3 and 5 at 1, 2, 4, 8 and 16 bits,
associated and unassociated alpha) in `II` and `MM` order, compressions
1, 5, 8, 32946 and 32773, predictor 1 and 2, one strip, several strips
or tiles, planar 1 and 2; the Orientation tag; LZW in both bit orders
through table resets; PIL's own files. Then `tiff_more_matrix`: CCITT
Modified Huffman, T.4 1-D and 2-D (with and without fill bits) and T.6
as libtiff writes them through PIL, random rows among them; JPEG-in-TIFF
(PIL's, and YCbCr at 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 in strips and
tiles); LZMA; BigTIFF; float (predictor 3), signed and unsigned 32-bit
samples in both byte orders; fill order 2. Layouts it does not read raise
NotImplementedError naming ROADMAP.md item 13i, malformed files ValueError.
"""

import functools
import io

import numpy as np
import pytest
from PIL import Image

import _torch_imagewriters as W
from ddgan_torch.data import tiff
from ddgan_torch.utils import decode_images


@functools.cache
def _matrix() -> tuple:
    return tuple(W.tiff_matrix(Image))


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _check(cases) -> None:
    assert cases
    got = decode_images([d for _, d in cases])
    for (label, data), img in zip(cases, got):
        want = _pil(data)
        assert img.dtype == np.uint8 and img.shape == want.shape, label
        np.testing.assert_array_equal(img, want, err_msg=label)


@pytest.mark.parametrize("layout", [name for name, *_ in W.TIFF_LAYOUTS])
def test_layout_equals_pil_in_every_storage(layout):
    _check([(label, d) for label, d in _matrix() if label.startswith(f"tiff {layout} ")])


@pytest.mark.parametrize("group", ["orientation", "LZW", "PIL"])
def test_orientation_lzw_forms_and_pil_files_equal_pil(group):
    _check([(label, d) for label, d in _matrix() if label.startswith(f"tiff {group} ")])


def test_lzw_packbits_and_predictor_in_cxx_match_numpy():
    """The C++ codecs alone: LZW in both forms and PackBits give back the
    bytes coded; predictor 2 equals a cumulative sum along each row."""
    rs = np.random.RandomState(0)
    raw = bytes(rs.randint(0, 4, 20000).astype(np.uint8)) + bytes(range(256)) * 9
    for coded, scheme in ((W.lzw(raw), 5), (W.lzw(raw, old=True), 5), (W.packbits(raw), 32773)):
        assert tiff._decompress(scheme, coded, len(raw)) == raw
        with pytest.raises(ValueError, match="malformed TIFF"):
            tiff._decompress(scheme, coded[:len(coded) // 3], len(raw))
    for bits, dt in ((8, np.uint8), (16, np.uint16)):
        a = rs.randint(0, 1 << bits, (5, 7, 3)).astype(dt)
        diff = W.predict(a, bits).astype(dt)
        e = "<" if bits == 16 else ""
        got = tiff._samples(diff.astype(e + "u2").tobytes() if bits == 16 else diff.tobytes(),
                            5, 7, 3, bits, "<", 2)
        np.testing.assert_array_equal(got, a)


@functools.cache
def _more() -> tuple:
    return tuple(W.tiff_more_matrix(Image))


@pytest.mark.parametrize("group", W.TIFF_MORE_GROUPS)
def test_codecs_containers_and_samples_equal_pil(group):
    _check([(label, d) for label, d in _more() if label.startswith(f"tiff {group}")])


@pytest.mark.parametrize("label", [k for k in W.once_refused(Image) if k.startswith("tiff")])
def test_layouts_once_refused_equal_pil(label):
    _check([(label, W.once_refused(Image)[label])])


@pytest.mark.parametrize("coding", W.CCITT_CODINGS, ids=[c[0] for c in W.CCITT_CODINGS])
def test_ccitt_random_rows_equal_pil(coding):
    """Random bilevel images of 1-40 rows and 1-300 columns, any density,
    in strips of 1-6 rows or with fill order 2, as libtiff codes them:
    the ends of rows, where 2-D coding has its edge cases."""
    name, comp, info = coding
    rs = np.random.RandomState(len(name))
    cases = []
    for k in range(60):
        h, w = rs.randint(1, 41), rs.randint(1, 301)
        a = rs.rand(h, w) > rs.rand() if k % 3 else W.bilevel(rs, h, w, "dense blocks")
        extra = ({}, {266: 2}, {278: int(rs.randint(1, 7))})[k % 3]
        im = Image.fromarray((a * 255).astype(np.uint8)).convert("1")
        cases.append((f"{name} {h}x{w} {extra}",
                      W.pil_tiff(Image, im, compression=comp, tiffinfo={**info, **extra})))
    _check(cases)


def test_float_and_32_bit_predictors_match_numpy():
    """Predictor 3 (libtiff's fpAcc) undoes the writer's fpDiff, and
    predictor 2 on 32-bit samples in C++ equals a cumulative sum."""
    rs = np.random.RandomState(1)
    f = (rs.randn(5, 7, 3) * 1e3).astype(np.float32)
    np.testing.assert_array_equal(tiff._unpredict_float(W.predict_float(f), 5, 7, 3), f)
    u = rs.randint(0, 1 << 32, (5, 7, 2), dtype=np.uint64).astype(np.uint32)
    diff = W.predict(u, 32)
    got = tiff._samples(diff.astype("<u4").tobytes(), 5, 7, 2, 32, "<", 2, "unsigned32")
    np.testing.assert_array_equal(got, u.view(np.int32))


@pytest.mark.parametrize("label", [k for k in W.refused(Image) if k.startswith("tiff")])
def test_layouts_it_does_not_read_raise_naming_item_13i(label):
    with pytest.raises(NotImplementedError, match="item 13i"):
        decode_images([W.refused(Image)[label]])


@pytest.mark.parametrize("label", [k for k in W.broken(Image) if k.startswith("tiff")])
def test_malformed_files_raise_value_error(label):
    with pytest.raises(ValueError):
        decode_images([W.broken(Image)[label]])


def test_threads_decode_alike():
    """ctypes releases the GIL: the loader's threads decode at once."""
    from concurrent.futures import ThreadPoolExecutor

    datas = [d for label, d in _matrix() if "compression 5" in label][:48]
    want = decode_images(datas)
    with ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(lambda d: decode_images([d])[0], datas))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
