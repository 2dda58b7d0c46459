"""The port's TIFF reader (`ddgan_torch.data.tiff`, tag parsing in numpy,
LZW / PackBits / predictor 2 in C++ built with the host compiler at first
use, Deflate through zlib) against PIL's `Image.open(f).convert("RGB")`,
bit for bit: every layout of `tests/_torch_imagewriters.py`'s
`TIFF_LAYOUTS` (photometric 0, 1, 2, 3 and 5 at 1, 2, 4, 8 and 16 bits,
associated and unassociated alpha) in `II` and `MM` order, compressions
1, 5, 8, 32946 and 32773, predictor 1 and 2, one strip, several strips
or tiles, planar 1 and 2; the Orientation tag; LZW in both bit orders
through table resets; PIL's own files. Layouts it does not read raise
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
