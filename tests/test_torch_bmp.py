"""The port's BMP reader (`ddgan_torch.data.bmp`, through
`utils.decode_images`) against PIL's `Image.open(f).convert("RGB")`, bit
for bit: the OS/2 and v3-v5 headers, bottom-up and top-down rows, 1, 4
and 8 bits through palettes of 2, 3 and 2^bits colours, RLE8 and RLE4,
16 (5-5-5), 24 and 32 bits, every BI_BITFIELDS layout PIL reads, grey
palettes, and PIL's own files (`tests/_torch_imagewriters.py`); PIL's RLE
quirks; layouts it does not read raise NotImplementedError naming
ROADMAP.md item 13i, malformed files ValueError.
"""

import functools
import io

import numpy as np
import pytest
from PIL import Image

import _torch_imagewriters as W
from ddgan_torch.data.bmp import decode_bmp
from ddgan_torch.utils import decode_images, to_rgb

GROUPS = ["12 bottom-up", "40 bottom-up", "40 top-down", "108 bottom-up", "108 top-down",
          "124 bottom-up", "124 top-down", "grey", "PIL"]


@functools.cache
def _matrix() -> tuple:
    return tuple(W.bmp_matrix(Image))


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("group", GROUPS)
def test_matrix_equals_pil(group):
    keys = ("black and white", "grey ramp") if group == "grey" else (f" {group}",)
    cases = [(label, d) for label, d in _matrix() if any(k in label for k in keys)]
    assert len(cases) >= 2
    for label, data in cases:
        got = decode_images([data])[0]
        want = _pil(data)
        assert got.dtype == np.uint8 and got.shape == want.shape, label
        np.testing.assert_array_equal(got, want, err_msg=label)


def test_rle_quirks_follow_pil():
    """PIL's RLE decoder: a delta reads four bytes and skips right + up *
    width pixels, an odd RLE4 absolute run drops its last pixel, an
    encoded run past the row is cut, the word alignment is the file's."""
    pal = np.random.RandomState(0).randint(0, 256, (16, 3))
    head = W.bmp(np.zeros((4, 6), np.int64), 4, palette=pal, compression=2)
    offset = int.from_bytes(head[10:14], "little")
    bodies = [
        bytes([3, 0x12, 0, 2, 9, 9, 2, 1, 0, 0, 0, 3, 0x45, 0x60, 0, 0, 4, 0x78, 0, 1]),
        bytes([9, 0x12, 0, 0, 0, 5, 0x12, 0x34, 0x56, 0, 0, 0, 6, 0x9A, 0, 1]),
        bytes([0, 3, 0x12, 0x34, 0, 0, 0, 1]),
    ]
    for body in bodies:
        for rle8 in (False, True):
            data = bytearray(head[:offset] + body)
            if rle8:
                data[30:34] = (1).to_bytes(4, "little")
                data[28:30] = (8).to_bytes(2, "little")
            data[2:6] = len(data).to_bytes(4, "little")
            try:
                want = _pil(bytes(data))
            except (OSError, ValueError):
                with pytest.raises(ValueError):
                    decode_images([bytes(data)])
                continue
            np.testing.assert_array_equal(decode_images([bytes(data)])[0], want)


def test_rle_delta_past_the_last_pixel_ends_the_image_as_pil():
    """A delta that skips past the image's last pixel ends it, as PIL's,
    with no more memory than the image: a 4096-wide RLE8 file whose delta
    asks for 255 rows more than its 2."""
    pal = np.random.RandomState(1).randint(0, 256, (4, 3))
    head = W.bmp(np.zeros((2, 4096), np.int64), 8, palette=pal, compression=1)
    offset = int.from_bytes(head[10:14], "little")
    data = bytearray(head[:offset] + bytes([3, 2, 0, 2, 9, 9, 7, 255, 4, 1, 0, 1]))
    data[2:6] = len(data).to_bytes(4, "little")
    got = decode_images([bytes(data)])[0]
    assert got.shape == (2, 4096, 3)
    np.testing.assert_array_equal(got, _pil(bytes(data)))


def test_short_palettes_and_modes():
    """Indices past a short palette read black; a grey palette comes back
    as PIL's "L" or "1" would give it; 32-bit alpha layouts drop alpha."""
    rs = np.random.RandomState(1)
    idx = np.arange(16).reshape(2, 8)
    data = W.bmp(idx, 4, palette=rs.randint(0, 256, (3, 3)))
    got, mode = decode_bmp(data)
    assert mode == "RGB" and not got[0, 3:].any()
    np.testing.assert_array_equal(got, _pil(data))
    grey = W.bmp(rs.randint(0, 256, (3, 4)), 8, palette=np.repeat(np.arange(256)[:, None], 3, 1))
    pixels, mode = decode_bmp(grey)
    assert mode == "L" and Image.open(io.BytesIO(grey)).mode == "L"
    np.testing.assert_array_equal(to_rgb(pixels, mode), _pil(grey))


@pytest.mark.parametrize("label", [k for k in W.refused(Image) if k.startswith("bmp")])
def test_layouts_it_does_not_read_raise_naming_item_13i(label):
    with pytest.raises(NotImplementedError, match="item 13i"):
        decode_images([W.refused(Image)[label]])


@pytest.mark.parametrize("label", [k for k in W.broken(Image) if k.startswith("bmp")])
def test_malformed_files_raise_value_error(label):
    with pytest.raises(ValueError):
        decode_images([W.broken(Image)[label]])
