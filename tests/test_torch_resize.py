"""The port's copy of PIL's 8-bit resampler (`ddgan_torch.data.resize`)
against PIL itself, bit for bit: both filters the JAX package uses
(bilinear: `transforms.Resize`, the FID's resize; bicubic, PIL's default:
`Luna16Dataset2`, `nii_to_png_simple`), on "L" and "RGB" images of every
size from 1 to 300, shrinking and enlarging, and the crop-and-resize of
`Luna16Dataset2`.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from ddgan_torch.data import resize as tresize
from ddgan_torch.data.datasets import Luna16Dataset2, crop

PIL_FILTER = {tresize.BILINEAR: Image.BILINEAR, tresize.BICUBIC: Image.BICUBIC}
FILTERS = sorted(PIL_FILTER)


def _image(seed: int, h: int, w: int, rgb: bool) -> np.ndarray:
    """Noise over a smooth ramp: every pixel value and sharp edges occur."""
    rs = np.random.RandomState(seed)
    shape = (h, w, 3) if rgb else (h, w)
    ramp = np.add.outer(np.linspace(0, 255, h), np.linspace(0, 255, w))
    ramp = ramp[:, :, None] if rgb else ramp
    return np.clip(ramp / 2 + rs.randint(-90, 90, shape), 0, 255).astype(np.uint8)


def _assert_pil(img: np.ndarray, size, resample: str) -> None:
    want = np.asarray(Image.fromarray(img).resize(size, PIL_FILTER[resample]))
    got = tresize.resize(img, size, resample)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


side = st.integers(min_value=1, max_value=300)


@pytest.mark.parametrize("resample", FILTERS)
@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(h=side, w=side, out_h=side, out_w=side, rgb=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_any_size_equals_pil(resample, h, w, out_h, out_w, rgb, seed):
    _assert_pil(_image(seed, h, w, rgb), (out_w, out_h), resample)


@pytest.mark.parametrize("resample", FILTERS)
@pytest.mark.parametrize("shape, size", [
    ((256, 256), (64, 64)),            # LUNA16 slices to the shipped config's 64²
    ((288, 320, 3), (284, 256)),       # do_resize at 256²: the soak's 320x288 JPEGs
    ((140, 180), (64, 64)),            # Luna16Dataset2's crop to 64²
    ((1, 1, 3), (300, 1)),             # enlarge a pixel
    ((300, 7), (1, 300)),              # shrink one axis to 1, enlarge the other
    ((17, 33, 3), (33, 17)),           # the same size: a copy
    ((9, 9), (9, 4)),                  # only the vertical pass
    ((9, 9, 3), (4, 9)),               # only the horizontal pass
])
def test_sizes_of_the_call_sites_equal_pil(resample, shape, size):
    _assert_pil(_image(len(shape) + size[0], *shape[:2], len(shape) == 3), size, resample)


def test_the_same_size_is_a_copy():
    img = _image(0, 5, 6, True)
    out = tresize.resize(img, (6, 5), tresize.BICUBIC)
    np.testing.assert_array_equal(out, img)
    out[0, 0, 0] ^= 1
    assert out[0, 0, 0] != img[0, 0, 0]


def test_fixed_point_weights_sum_to_one():
    """Each output pixel's weights sum to 2^22 within the rounding of each
    of its taps, for both filters, shrinking and enlarging."""
    for resample in FILTERS:
        for n_in, n_out in ((256, 64), (64, 256), (7, 300), (300, 7)):
            xmin, count, kk = tresize.coefficients(n_in, n_out, resample)
            assert (xmin >= 0).all() and (xmin + count <= n_in).all()
            total = kk.sum(axis=1)
            assert (np.abs(total - (1 << tresize.PRECISION_BITS)) <= count).all()


@pytest.mark.parametrize("shape", [(256, 256), (64, 70), (150, 300), (30, 30)])
def test_luna16_crop_and_bicubic_equal_pil(shape):
    """`Luna16Dataset2`'s `.crop((40, 60, 220, 200)).resize((64, 64))`,
    slices smaller than the box too (PIL fills the outside with zeros)."""
    img = _image(sum(shape), *shape, False)
    want = np.asarray(Image.fromarray(img).crop(Luna16Dataset2.CROP_BOX).resize((64, 64)))
    cropped = crop(img, Luna16Dataset2.CROP_BOX)
    np.testing.assert_array_equal(cropped, np.asarray(
        Image.fromarray(img).crop(Luna16Dataset2.CROP_BOX)))
    np.testing.assert_array_equal(tresize.resize(cropped, (64, 64), tresize.BICUBIC), want)


@pytest.mark.parametrize("bad", [
    dict(img=np.zeros((4, 4), np.float32)), dict(img=np.zeros((4, 4, 4), np.uint8)),
    dict(size=(0, 3)), dict(resample="lanczos")])
def test_refuses_what_pil_would_not_give(bad):
    kw = dict(img=np.zeros((4, 4), np.uint8), size=(2, 2), resample=tresize.BILINEAR)
    kw.update(bad)
    with pytest.raises(ValueError):
        tresize.resize(**kw)
