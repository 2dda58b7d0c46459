"""The port's GIF reader (`ddgan_torch.data.gif`, through
`utils.decode_images`) against PIL's `Image.open(f).convert("RGB")`, bit
for bit: the first frame of GIF87a and 89a files at LZW minimum code sizes
2-8 and 12, global, local and no colour tables (the grey ramp, which PIL
drops, and its global-table quirk), interlaced, inside and past the
logical screen, with transparency, clear codes, one-byte sub-blocks and
extensions, and PIL's own files (`tests/_torch_imagewriters.py`); streams
with flipped bits, cut short or with early end codes, where the two must
agree on the pixels or both fail; files PIL does not open raise
NotImplementedError naming ROADMAP.md item 13i, malformed ones ValueError.
"""

import functools
import io

import numpy as np
import pytest
from PIL import Image

import _torch_imagewriters as W
from ddgan_torch.data.gif import decode_gif
from ddgan_torch.utils import decode_images, image_format

GROUPS = ["global table", "local table interlaced", "no table", "larger screen",
          "past its screen", "ramp", "short table", "extensions", "table full", "PIL"]


@functools.cache
def _matrix() -> tuple:
    return tuple(W.gif_matrix(Image))


def _pil(data: bytes):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("group", GROUPS)
def test_matrix_equals_pil(group):
    cases = [(label, d) for label, d in _matrix() if group in label]
    assert cases
    for label, data in cases:
        assert image_format(data) == "gif", label
        got = decode_images([data])[0]
        want = _pil(data)
        assert got.dtype == np.uint8 and got.shape == want.shape, label
        np.testing.assert_array_equal(got, want, err_msg=label)


def test_ramp_local_table_under_a_global_one_is_looked_up_in_the_global():
    """PIL's quirk: a local table that is the grey ramp makes the frame
    "L", yet the image keeps the global table, which convert uses."""
    idx = np.array([[0, 1, 2, 3]], np.uint8)
    table = np.array([[9, 8, 7], [6, 5, 4], [3, 2, 1], [0, 1, 2]])
    data = W.gif(idx, 2, global_table=table, local_table=np.repeat(np.arange(4)[:, None], 3, 1))
    assert decode_gif(data)[1] == "RGB"
    np.testing.assert_array_equal(decode_images([data])[0][0], table)
    np.testing.assert_array_equal(_pil(data)[0], table)


def test_an_end_code_past_64k_of_data_is_read_on():
    """An end code before the image is full ends one call of PIL's decoder;
    with more than 64 KiB of the file left it decodes the codes after it,
    else it fails (ValueError here)."""
    rs = np.random.RandomState(4)
    idx = rs.randint(0, 256, (300, 320)).astype(np.uint8)
    codes = W.gif_codes(idx.reshape(-1), 8)
    k = len(codes) // 3  # an end code, at the width of its place, within the first 64 KiB
    data = W.gif(idx, 8, global_table=rs.randint(0, 256, (256, 3)),
                 codes=codes[:k] + [(257, codes[k][1])] + codes[k:])
    assert len(data) > 65536 + 20000 and k * 9 // 8 < 60000
    np.testing.assert_array_equal(decode_images([data])[0], _pil(data))
    small = W.gif_codes(idx[:20].reshape(-1), 8)
    short = W.gif(idx[:20], 8, codes=small[:100] + [(257, small[100][1])] + small[100:])
    with pytest.raises(OSError):
        _pil(short)
    with pytest.raises(ValueError, match="end before"):
        decode_images([short])


@pytest.mark.parametrize("seed", range(4))
def test_damaged_streams_agree_with_pil(seed):
    """Valid files with bits flipped in the LZW data, cut short, or split
    into random sub-blocks: the port gives PIL's pixels, or fails
    (ValueError or NotImplementedError) where PIL does."""
    rs = np.random.RandomState(seed)
    agreed = read = 0
    for _ in range(60):
        h, w = rs.randint(1, 24, 2)
        bits = int(rs.choice([2, 3, 4, 8]))
        idx = rs.randint(0, 1 << bits, (h, w)).astype(np.uint8)
        data = bytearray(W.gif(idx, bits, global_table=rs.randint(0, 256, (1 << bits, 3)),
                               block=int(rs.randint(1, 256)), interlace=bool(rs.rand() < 0.3)))
        start = data.index(b",") + 11 + 3 * (1 << bits)
        for _ in range(int(rs.randint(0, 4)) if len(data) > start + 2 else 0):
            k = int(rs.randint(start, len(data) - 1))
            data[k] ^= 1 << int(rs.randint(0, 8))
        if rs.rand() < 0.3 and len(data) > start:
            data = data[:int(rs.randint(start, len(data)))]
        data = bytes(data)
        try:
            want = _pil(data)
        except Exception:  # noqa: BLE001  (PIL fails in many ways)
            want = None
        try:
            got = decode_images([data])[0]
        except (ValueError, NotImplementedError):
            got = None
        assert (got is None) == (want is None), (seed, h, w, bits)
        if got is not None:
            np.testing.assert_array_equal(got, want)
            read += 1
        agreed += 1
    assert agreed == 60 and read >= 10


@pytest.mark.parametrize("label", [k for k in W.refused(Image) if k.startswith("gif")])
def test_files_pil_does_not_open_raise_naming_item_13i(label):
    with pytest.raises(NotImplementedError, match="item 13i"):
        decode_images([W.refused(Image)[label]])


@pytest.mark.parametrize("label", [k for k in W.broken(Image) if k.startswith("gif")])
def test_malformed_files_raise_value_error(label):
    with pytest.raises(ValueError):
        decode_images([W.broken(Image)[label]])
