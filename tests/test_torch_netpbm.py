"""The port's PBM/PGM/PPM reader (`ddgan_torch.data.netpbm`, through
`utils.decode_images`) against PIL's `Image.open(f).convert("RGB")`, bit
for bit: P1-P6, plain and raw, at maxvals 1, 15, 255, 1000 and 65535,
with comments and mixed whitespace in the header and in plain data, and
PIL's own files (`tests/_torch_imagewriters.py`); PIL's scaling of odd
maxvals; other magics raise NotImplementedError naming ROADMAP.md item
13i, malformed files ValueError.
"""

import functools
import io

import numpy as np
import pytest
from PIL import Image

import _torch_imagewriters as W
from ddgan_torch.data.netpbm import decode_netpbm
from ddgan_torch.utils import decode_images


@functools.cache
def _matrix() -> tuple:
    return tuple(W.netpbm_matrix(Image))


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("group", ["P1", "P2", "P3", "P4", "P5", "P6", "PIL"])
def test_matrix_equals_pil(group):
    cases = [(label, d) for label, d in _matrix() if f" {group} " in label + " "]
    assert len(cases) >= 3
    for label, data in cases:
        got = decode_images([data])[0]
        want = _pil(data)
        assert got.dtype == np.uint8 and got.shape == want.shape, label
        np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("magic, maxval, values, want", [
    ("P5", 15, [0, 1, 8, 15], [0, 17, 136, 255]),
    ("P2", 15, [0, 1, 8, 15], [0, 17, 136, 255]),
    ("P5", 1000, [0, 1, 4, 500], [0, 66, 255, 255]),
    ("P2", 1000, [0, 1, 4, 500], [0, 66, 255, 255]),
    ("P6", 1000, [0, 1, 4, 500], [0, 0, 1, 128]),
])
def test_maxvals_scale_as_pil(magic, maxval, values, want):
    """A maxval below 255 is rescaled to 0-255; a grey maxval above 255
    gives mode "I" (scaled to 65535, clipped at 255 by convert); a colour
    one is rescaled to 0-255 (round half to even, as Python's round)."""
    px = np.array(values).reshape(1, 4)
    if magic == "P6":
        px = np.repeat(px[:, :, None], 3, axis=2)
    data = W.netpbm(px, magic, maxval)
    got = decode_images([data])[0][:, :, 0].ravel().tolist()
    assert got == want == _pil(data)[:, :, 0].ravel().tolist()
    if magic in ("P2", "P5") and maxval > 255:
        assert decode_netpbm(data)[1] == "I" and Image.open(io.BytesIO(data)).mode == "I"


def test_comments_and_whitespace_everywhere():
    data = b"P2 # grey\n# a comment line\r3\x0b2\t# dims\n 7\n0 1 #c\n2\n3 4\r5 # end\n"
    np.testing.assert_array_equal(decode_images([data])[0], _pil(data))
    pbm = b"P1\n# bits\n4 2\n0101\n1 0 # x\n1 0\n"
    np.testing.assert_array_equal(decode_images([pbm])[0], _pil(pbm))
    # a comment and its line end go, gluing the tokens around them, as in PIL:
    # "1#c\n2" is one token, 12, so this file holds one sample of two
    glued = b"P2\n2 1\n255\n1#c\n2\n"
    with pytest.raises(ValueError):
        _pil(glued)
    with pytest.raises(ValueError):
        decode_images([glued])


@pytest.mark.parametrize("label", [k for k in W.refused(Image) if k.startswith("netpbm")])
def test_layouts_it_does_not_read_raise_naming_item_13i(label):
    with pytest.raises(NotImplementedError, match="item 13i"):
        decode_images([W.refused(Image)[label]])


@pytest.mark.parametrize("label", [k for k in W.broken(Image) if k.startswith("netpbm")])
def test_malformed_files_raise_value_error(label):
    with pytest.raises(ValueError):
        decode_images([W.broken(Image)[label]])
