"""The port's TGA reader (`ddgan_torch.data.tga`, through
`utils.decode_images`) against PIL's `Image.open(f).convert("RGB")`, bit
for bit: colour-mapped, true-colour and grey images at every depth PIL
reads, raw and RLE, at each of the four origins, under 16- and 24-bit
colour maps that start past entry 0, grey images under a map (PIL looks
them up), and PIL's own files (`tests/_torch_imagewriters.py`); random
headers and packet streams, where the two must agree on the pixels or
both fail; TGA has no magic, so the bytes other PIL plugins take first
(or, for IM and IPTC, may take) are not TGA; layouts PIL does not read raise NotImplementedError naming
ROADMAP.md item 13i, malformed files ValueError.
"""

import functools
import io
import struct

import numpy as np
import pytest
from PIL import Image

import _torch_imagewriters as W
from ddgan_torch.data import tga
from ddgan_torch.utils import decode_images, image_format


@functools.cache
def _matrix() -> tuple:
    return tuple(W.tga_matrix(Image))


def _pil(data: bytes):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("kind", [1, 2, 3, 9, 10, 11, "PIL"])
def test_matrix_equals_pil(kind):
    cases = [(label, d) for label, d in _matrix()
             if (f"tga type {kind} " in label if kind != "PIL" else "PIL" in label)]
    assert len(cases) >= 10
    for label, data in cases:
        assert image_format(data) == "tga", label
        got = decode_images([data])[0]
        want = _pil(data)
        assert got.dtype == np.uint8 and got.shape == want.shape, label
        np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("seed", range(4))
def test_random_files_agree_with_pil(seed):
    """Random headers (types, depths, maps of 8-32 bits, descriptor bits,
    ID fields), rows, RLE packets (runs across rows now and then), cut or
    padded bodies: the port gives PIL's pixels, or fails where PIL does
    (or leaves the bytes to another format, as PIL's plugin order does)."""
    rs = np.random.RandomState(seed)
    read = 0
    for _ in range(150):
        kind = int(rs.choice([1, 2, 3, 9, 10, 11, 0, 4]))
        depth = int(rs.choice([1, 8, 15, 16, 24, 32]))
        w, h = int(rs.randint(1, 9)), int(rs.randint(1, 6))
        map_depth = int(rs.choice([16, 24, 32, 15]))
        cmap = (rs.randint(0, 256, int(rs.randint(1, 20)) * max(map_depth // 8, 1))
                .astype(np.uint8).tobytes() if rs.rand() < 0.5 else None)
        row_bytes = (w * depth + 7) // 8
        raw = rs.randint(0, 256 if rs.rand() < 0.7 else 24, row_bytes * h).astype(np.uint8)
        body = raw.tobytes()
        if kind & 8 and depth >= 8:
            body = W.tga_rle(body, depth // 8, w, rs, cross=rs.rand() < 0.2)
        if rs.rand() < 0.1:
            body = body[:int(rs.randint(0, len(body) + 1))]
        data = W.tga(body, w, h, kind, depth, cmap=cmap, map_start=int(rs.choice([0, 3, 250])),
                     map_depth=map_depth, flags=int(rs.choice([0, 0x10, 0x20, 0x30, 0x08])),
                     ident=rs.randint(0, 256, int(rs.choice([0, 3, 10]))).astype(np.uint8)
                     .tobytes())
        try:
            want = _pil(data)
        except Exception:  # noqa: BLE001  (PIL fails in many ways)
            want = None
        try:
            got = decode_images([data])[0]
        except (ValueError, NotImplementedError):
            got = None
        assert (got is None) == (want is None), (kind, depth, w, h, cmap is not None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
            read += 1
    assert read >= 10


def test_bytes_another_plugin_takes_first_are_not_tga():
    """A header TGA's `_open` accepts, but PIL's CUR, PCX or FLI plugin,
    tried before TGA, opens (or fails on) it: not TGA here either. Bytes
    that IM might read (text lines from byte 0) are refused, even where
    IM finds no key it knows and PIL's TGA plugin reads them."""
    px = bytes(range(48))
    base = W.tga(px, 4, 4, 2, 24)
    assert image_format(base) == "tga"
    cur = bytearray(base)
    cur[4:6] = struct.pack("<H", 1)  # CUR: one cursor entry, its bitmap at 16
    cur[18:22] = struct.pack("<I", 16)
    pcx = W.tga(px, 4, 4, 2, 24, ident=bytes(10)) + bytes(40)  # PCX: version 0, a box
    fli = bytearray(W.tga(bytes(144), 4, 3, 3, 8))
    fli[4:8] = struct.pack("<HH", 0xAF11, 1)  # FLI: magic, a frame, a size, zeros as it asks
    fli[8:12] = struct.pack("<HH", 4, 3)
    for data in (bytes(cur), pcx, bytes(fli)):
        assert tga.header(data) is not None
        assert tga.claimed_before_tga(data)
        try:
            taken = Image.open(io.BytesIO(data)).format
        except Exception as e:  # noqa: BLE001  (the plugin before TGA fails on it)
            taken = type(e).__name__
        assert taken != "TGA"
        with pytest.raises(NotImplementedError, match="item 13i"):
            decode_images([data])
    # IM reads "key: value" lines from byte 0: here one with no key it knows
    handed_on = W.tga(px, 4, 4, 2, 24, ident=b"Name: x\n" + bytes(57))
    assert Image.open(io.BytesIO(handed_on)).format == "TGA"
    assert image_format(handed_on) is None
    with pytest.raises(NotImplementedError, match="item 13i"):
        decode_images([handed_on])


@pytest.mark.parametrize("label", [k for k in W.refused(Image) if k.startswith("tga")])
def test_layouts_it_does_not_read_raise_naming_item_13i(label):
    with pytest.raises(NotImplementedError, match="item 13i"):
        decode_images([W.refused(Image)[label]])


@pytest.mark.parametrize("label", [k for k in W.broken(Image) if k.startswith("tga")])
def test_malformed_files_raise_value_error(label):
    with pytest.raises(ValueError):
        decode_images([W.broken(Image)[label]])
