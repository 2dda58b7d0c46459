"""The port's CIELAB conversion (`ddgan_torch.data.cielab.lab_to_rgb`, the
arithmetic of LittleCMS's optimised Lab to sRGB transform that PIL's
`convert("RGB")` of an "LAB" image runs) against PIL over every one of the
2^24 (L, a, b) byte triples, and CIELAB TIFFs (photometric 8) through
`utils.decode_images` against PIL's `Image.open(f).convert("RGB")`,
bit for bit."""

import io

import numpy as np
import pytest
from PIL import Image

import _torch_imagewriters as W
from ddgan_torch.data.cielab import lab_to_rgb
from ddgan_torch.utils import decode_images, to_rgb


@pytest.mark.parametrize("l_high", [0, 1, 2, 3])
def test_every_lab_triple_equals_pil(l_high):
    """A quarter of the cube a case: L's top two bits fixed, every a and b."""
    v = np.arange(1 << 22, dtype=np.int64) + (l_high << 22)
    lab = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    lab = lab.reshape(1024, 4096, 3)
    want = np.asarray(Image.frombytes("LAB", (4096, 1024), lab.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(lab_to_rgb(lab), want)
    np.testing.assert_array_equal(to_rgb(lab, "LAB"), want)


@pytest.mark.parametrize("comp", [1, 5, 8, 32773, 34925])
def test_cielab_tiffs_equal_pil(comp):
    rs = np.random.RandomState(comp)
    for kw in ({}, dict(rows_per_strip=3), dict(tile=(16, 16)), dict(order="MM")):
        raw = rs.randint(0, 256, (19, 21, 3)).astype(np.uint8)
        data = W.tiff(raw, photometric=8, compression=comp, **kw)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_images([data])[0], want, err_msg=str(kw))


@pytest.mark.parametrize("comp", [1, 5, 34925])
def test_planar_cielab_equals_pil(comp):
    """PIL's plane unpackers ("L", "A", "B" of mode "LAB") copy a and b
    without the sign flip of its interleaved "LAB" unpacker."""
    rs = np.random.RandomState(comp)
    for kw in ({}, dict(rows_per_strip=2), dict(tile=(16, 16))):
        raw = rs.randint(0, 256, (7, 9, 3)).astype(np.uint8)
        data = W.tiff(raw, photometric=8, planar=2, compression=comp, **kw)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_images([data])[0], want, err_msg=str(kw))
