"""The port's ICO reader (`ddgan_torch.data.ico`, through
`utils.decode_images`) against PIL's `Image.open(f).convert("RGB")`, bit
for bit: the entry PIL picks (the largest, of those the least colour
depth) holding a PNG (RGBA, RGB, P, L) or a BMP without its file header at
1, 4, 8, 16, 24 and 32 bits (OS/2 and 40-byte headers, RLE8 with PIL's
word alignment to the ICO file, bitfields) with its AND mask, beside
decoys, and PIL's own files (`tests/_torch_imagewriters.py`); random
directories (sizes of 256 as 0, colour counts, zero bit depths), masks cut
short and files cut, where the two must agree or both fail; malformed
files raise ValueError.
"""

import functools
import io

import numpy as np
import pytest
from PIL import Image

import _torch_imagewriters as W
from ddgan_torch.utils import decode_images, image_format


@functools.cache
def _matrix() -> tuple:
    return tuple(W.ico_matrix(Image))


def _pil(data: bytes):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("group", ["PNG", "DIB", "PIL"])
def test_matrix_equals_pil(group):
    cases = [(label, d) for label, d in _matrix() if f"ico {group} " in label]
    assert len(cases) >= 3
    for label, data in cases:
        assert image_format(data) == "ico", label
        got = decode_images([data])[0]
        want = _pil(data)
        assert got.dtype == np.uint8 and got.shape == want.shape, label
        np.testing.assert_array_equal(got, want, err_msg=label)


def test_rle_runs_align_to_the_ico_file():
    """An RLE8 bitmap at an odd offset in the ICO file: PIL pads each
    absolute run to a word of the file, so the same bitmap reads two ways
    at two offsets; the port reads both as PIL does."""
    rs = np.random.RandomState(5)
    idx = rs.randint(0, 256, (8, 10))
    dib = W.ico_dib(W.bmp(idx, 8, palette=rs.randint(0, 256, (256, 3)), compression=1))
    decoy = (W.ico_dib(W.bmp(rs.randint(0, 256, (1, 1, 3)).astype(np.uint8), 24)) + b"\0",
             1, 1, 24, 0)  # 49 bytes
    even, odd = W.ico([(dib, 10, 8, 8, 0)]), W.ico([decoy, (dib, 10, 8, 8, 0)])
    assert (6 + 16) % 2 == 0 and (6 + 32 + len(decoy[0])) % 2 == 1
    for data in (even, odd):
        np.testing.assert_array_equal(decode_images([data])[0], _pil(data))
    assert not np.array_equal(_pil(even), _pil(odd))


@pytest.mark.parametrize("seed", range(3))
def test_random_directories_agree_with_pil(seed):
    rs = np.random.RandomState(seed)
    read = 0
    for _ in range(60):
        entries = []
        for _ in range(int(rs.randint(1, 4))):
            w, h = (int(v) for v in rs.choice([1, 3, 8, 16], 2))
            kind = str(rs.choice(["png", "1", "4", "8", "24", "32", "rle8", "os2"]))
            rgb = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
            if kind == "png":
                buf = io.BytesIO()
                Image.fromarray(rgb).convert(str(rs.choice(["RGB", "RGBA", "P", "L"]))).save(
                    buf, "PNG")
                payload, bpp = buf.getvalue(), 32
            else:
                bits = {"rle8": 8, "os2": 8}.get(kind) or int(kind)
                if bits <= 8:
                    idx = rs.randint(0, 1 << bits, (h, w))
                    if kind == "rle8":
                        idx = np.repeat(idx[:, ::2], 2, axis=1)[:, :w]
                    bmp = W.bmp(idx, bits, palette=rs.randint(0, 256, (int(rs.choice(
                        [2, 1 << bits])), 3)), compression=int(kind == "rle8"),
                        header=12 if kind == "os2" else 40)
                else:
                    bmp = W.bmp(rgb, bits)
                payload = W.ico_dib(bmp, mask_rows=None if rs.rand() < 0.85 else int(
                    rs.randint(0, h)))
                bpp = bits if rs.rand() < 0.8 else int(rs.choice([0, 32, 8]))
            dw, dh = (w, h) if rs.rand() < 0.8 else (int(v) for v in rs.choice([256, 2, 16], 2))
            entries.append((payload, dw, dh, bpp, int(rs.choice([0, 0, 2, 16, 255]))))
        data = W.ico(entries)
        if rs.rand() < 0.1:
            data = data[:int(rs.randint(6, len(data) + 1))]
        try:
            want = _pil(data)
        except Exception:  # noqa: BLE001  (PIL fails in many ways)
            want = None
        try:
            got = decode_images([data])[0]
        except (ValueError, NotImplementedError):
            got = None
        if want is not None and got is None and data[-12:] != W.ico(entries)[-12:]:
            continue  # a PNG cut in its last chunks: PIL reads it, the port's PNG reader not
        assert (got is None) == (want is None), [e[1:] for e in entries]
        if got is not None:
            np.testing.assert_array_equal(got, want)
            read += 1
    assert read >= 30


@pytest.mark.parametrize("label", [k for k in W.broken(Image) if k.startswith("ico")])
def test_malformed_files_raise_value_error(label):
    with pytest.raises(ValueError):
        decode_images([W.broken(Image)[label]])
