"""The port's evaluation (`ddgan_torch.eval`: FID, IS, the folder wrappers)
and its image readers (`ddgan_torch.utils.decode_png{,s}`,
`decode_images` over PNG and JPEG) against the JAX package's
`ddgan_tpu.eval` and PIL, on the same numpy-seeded inputs.

The Fréchet distance must equal the JAX package's to 1e-10 relative on the
same statistics, through its eps retry and its imaginary-component check;
FID over two PNG directories at dims 64 (block 0 of the same seeded random
Inception) to 1e-4; the PNG reader equals PIL's `convert("RGB")` bit for bit.
Tests may import PIL; the port may not.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image
from scipy import linalg

from ddgan_tpu.eval import fid as jfid
from ddgan_tpu.eval import inception_score as jis
from ddgan_tpu.eval import simple_metrics as jsimple

from ddgan_torch.eval import fid, inception, inception_score, simple_metrics
from ddgan_torch.utils import decode_images, decode_png, decode_pngs, encode_png

import _torch_imagewriters as W
from _torch_port import one_torch_thread  # noqa: F401


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


# --------------------------------------------------------------------------
# decode_png
def _smooth(rs, h, w, c) -> np.ndarray:
    """Image-like pixels, so PIL's adaptive filter picks rows of every kind."""
    x = np.cumsum(np.cumsum(rs.randint(-3, 4, (h, w, c)), 0), 1) + rs.randint(0, 256, (1, 1, c))
    return (x % 256).astype(np.uint8)


def _pil_image(mode: str, rs, h: int, w: int) -> Image.Image:
    if mode == "P":  # a full 256-colour palette keeps PIL at bit depth 8
        im = Image.fromarray(rs.randint(0, 256, (h, w)).astype(np.uint8), "P")
        im.putpalette(rs.randint(0, 256, 768).astype(np.uint8).tolist())
        return im
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    arr = _smooth(rs, h, w, c)
    return Image.fromarray(arr[:, :, 0] if c == 1 else arr, mode)


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_decode_png_equals_pil_on_pil_files(mode):
    rs = np.random.RandomState(len(mode))
    for h, w in [(1, 1), (3, 7), (32, 32), (45, 61)]:
        buf = io.BytesIO()
        _pil_image(mode, rs, h, w).save(buf, "PNG")
        data = buf.getvalue()
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        got = decode_png(data)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"{mode} {h}x{w}")


def _png(pixels: np.ndarray, color: int, filters, depth: int = 8, interlace: int = 0,
         palette: np.ndarray | None = None) -> bytes:
    """A PNG of `pixels` (H, W*bpp uint8) whose row y is filtered with
    `filters[y]`, written here from the PNG specification."""
    h, stride = pixels.shape
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    w = stride // bpp
    cur = pixels.astype(np.int64)
    raw = bytearray()
    for y in range(h):
        prior = cur[y - 1] if y else np.zeros(stride, np.int64)
        row = cur[y]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        kind = filters[y]
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            pa, pb, pc = (np.abs(prior - upleft), np.abs(left - upleft),
                          np.abs(left + prior - 2 * upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        raw.append(kind)
        raw.extend(((row - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                                             0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    raw = zlib.compress(bytes(raw))
    # two IDAT chunks: the reader must join them
    return out + chunk(b"IDAT", raw[:5]) + chunk(b"IDAT", raw[5:]) + chunk(b"IEND", b"")


@pytest.mark.parametrize("color", [0, 2, 3, 4, 6])
def test_decode_png_undoes_every_row_filter(color):
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    rs = np.random.RandomState(color)
    h, w = 15, 9
    pixels = rs.randint(0, 256, (h, w * bpp)).astype(np.uint8)
    palette = rs.randint(0, 256, (256, 3)) if color == 3 else None
    filters = [y % 5 for y in range(h)]  # 0-4 three times, the first row too
    data = _png(pixels, color, filters, palette=palette)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decode_png(data), want)


def test_decode_png_refuses_what_it_does_not_read(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "JPEG")
    with pytest.raises(NotImplementedError, match="item 13"):
        decode_png(buf.getvalue())
    pixels = np.zeros((4, 12), np.uint8)
    good = _png(pixels, 2, [1] * 4)
    with pytest.raises(ValueError, match="CRC"):
        decode_png(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    # the FID loader: a format and layouts the port does not read
    refused = W.refused(Image)
    for name, data in (("a.gif", refused["gif"]),
                       ("b.tif", refused["tiff Zstd (compression 50000)"]),
                       ("c.jpg", refused["jpeg arithmetic-coded lossless (SOF11)"])):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(NotImplementedError, match="item 13i"):
            fid.get_activations([tmp_path / name], lambda b: b.mean((1, 2)), dims=3)


def test_decode_png_reads_what_it_once_refused(tmp_path):
    """Adam7, 16-bit and PIL's "I;16" PNGs equal PIL; the FID loader reads
    a progressive JPEG and a BMP as the JAX package does."""
    rs = np.random.RandomState(11)
    datas = [W.png(rs.randint(0, 256, (4, 4, 3)), 2, 8, interlace=1),
             W.png(rs.randint(0, 65536, (4, 4, 3)), 2, 16)]
    buf = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000, "I;16").save(buf, "PNG")
    datas.append(buf.getvalue())
    for data in datas:
        np.testing.assert_array_equal(decode_png(data),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    Image.fromarray(_smooth(rs, 8, 8, 3)).save(tmp_path / "a.jpg", progressive=True)
    Image.fromarray(_smooth(rs, 8, 8, 3)).save(tmp_path / "b.bmp")
    for name in ("a.jpg", "b.bmp"):
        np.testing.assert_array_equal(fid._load_images_01([tmp_path / name])[0],
                                      jfid._load_image_01(tmp_path / name))


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("color, depth", W.PNG_LAYOUTS,
                         ids=[f"c{c}d{d}" for c, d in W.PNG_LAYOUTS])
def test_png_depths_and_adam7_equal_pil(color, depth, interlace):
    """Every colour type at every depth, Adam7 or not, at every size from
    1x1 to 9x9 (where Adam7's passes are empty) and at 17x13, one call:
    grey 1-bit as 0/255, 2- and 4-bit x85 and x17, 16-bit grey clipped at
    255 ("I;16"), 16-bit colour by its high bytes, sub-byte palettes."""
    rs = np.random.RandomState(color * 32 + depth + interlace)
    sizes = [(h, w) for h in range(1, 10) for w in range(1, 10)] + [(17, 13)]
    datas = [W.png_file(rs, color, depth, interlace, h, w) for h, w in sizes]
    for (h, w), data, img in zip(sizes, datas, decode_pngs(datas)):
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert img.shape == (h, w, 3)
        np.testing.assert_array_equal(img, want, err_msg=f"{h}x{w}")


def test_png_values_at_16_bits_follow_pil():
    """16-bit grey is clipped, not scaled (0, 100, 255, 256, 65535 -> 0,
    100, 255, 255, 255); 16-bit RGB takes each sample's high byte."""
    grey = W.png(np.array([0, 100, 255, 256, 65535]).reshape(1, 5, 1), 0, 16)
    assert decode_png(grey)[0, :, 0].tolist() == [0, 100, 255, 255, 255]
    rgb = W.png(np.array([0x1234, 0x80FF, 0x00FF]).reshape(1, 1, 3), 2, 16)
    assert decode_png(rgb)[0, 0].tolist() == [18, 128, 0]
    for data in (grey, rgb):
        np.testing.assert_array_equal(decode_png(data),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_png_pil_files_at_every_depth():
    cases = [(label, d) for label, d in W.png_matrix(Image, sizes=[(3, 5)])
             if label.startswith("png PIL")]
    assert len(cases) == 5
    for label, data in cases:
        np.testing.assert_array_equal(decode_png(data),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("RGB")),
                                      err_msg=label)


def _mixed_folder(directory, rs) -> list:
    """One file of each format and layout the port reads, by extension the
    FID lists (bmp, jpg, pgm, png, ppm, tif, webp)."""
    import _torch_jpeg_arith as A

    directory.mkdir(parents=True, exist_ok=True)
    arr = _smooth(rs, 21, 19, 3)
    base = io.BytesIO()
    Image.fromarray(arr).save(base, "JPEG", quality=90)
    files = {
        "bmp24.bmp": W.bmp(arr, 24), "bmp8.bmp": W.bmp(rs.randint(0, 256, (21, 19)), 8,
                                                        palette=rs.randint(0, 256, (256, 3))),
        "bmp_rle4.bmp": W.bmp(np.repeat(rs.randint(0, 16, (21, 7)), 3, 1)[:, :19], 4,
                              palette=rs.randint(0, 256, (16, 3)), compression=2),
        "grey.pgm": W.netpbm(arr[:, :, 0], "P5"), "wide.pgm": W.netpbm(arr[:, :, 1] * 3, "P2", 1000),
        "rgb.ppm": W.netpbm(arr, "P6"), "bits.pbm.ppm": W.netpbm(arr[:, :, 0] > 127, "P4"),
        "lzw.tif": W.tiff(arr, photometric=2, compression=5, predictor=2),
        "deflate.tiff": W.tiff(arr.astype(np.uint16) * 257, photometric=2, bits=16,
                               compression=8, order="MM", tile=(16, 16)),
        "packbits.tif": W.tiff(arr, photometric=2, compression=32773, planar=2),
        "arith.jpg": A.to_arithmetic(base.getvalue()),
        "arith_prog.jpg": A.to_arithmetic(base.getvalue(), progressive=True),
        "png16.png": W.png(arr.astype(np.uint16) * 300, 2, 16),
        "adam7.png": W.png(arr, 2, 8, interlace=1),
        "pal4.png": W.png(rs.randint(0, 16, (21, 19, 1)), 3, 4, palette=rs.randint(0, 256, (16, 3))),
    }
    for name, data in files.items():
        (directory / name).write_bytes(data)
    Image.fromarray(arr).save(directory / "prog.jpg", quality=90, progressive=True)
    Image.fromarray(arr).convert("CMYK").save(directory / "cmyk.jpg", quality=90)
    return sorted(directory.iterdir())


@pytest.mark.parametrize("resize", [0, 16])
def test_fid_loader_reads_every_format_as_the_jax_package_does(tmp_path, resize):
    """A folder of BMP, PGM, PPM, TIFF, progressive, arithmetic and CMYK
    JPEG, 16-bit, Adam7 and 4-bit palette PNG files through the port's FID
    reader and `ddgan_tpu/eval/fid.py:_load_image_01`, exactly."""
    _mixed_folder(tmp_path, np.random.RandomState(12))
    files = fid.list_image_files(tmp_path)
    assert files == jfid.list_image_files(tmp_path) and len(files) == 17
    got = fid._load_images_01(files, resize=resize)
    for f, img in zip(files, got):
        np.testing.assert_array_equal(img, jfid._load_image_01(f, resize=resize), str(f))


def test_dataset_items_of_every_format_equal_jax(tmp_path):
    """`DatasetCustom` (`*/*.jpg`: progressive, arithmetic, CMYK and the
    other formats under a .jpg name, which both packages tell by their
    bytes) and `DataReader` (`*/*.png`) items against the JAX package's."""
    from ddgan_tpu.data import datasets as jds

    from ddgan_torch.data import datasets as ds

    rs = np.random.RandomState(13)
    files = _mixed_folder(tmp_path / "src", rs)
    for k, f in enumerate(files):
        for root in (tmp_path / "custom" / "train" / "a", tmp_path / "reader" / "b"):
            root.mkdir(parents=True, exist_ok=True)
            ext = "jpg" if "custom" in str(root) else "png"
            (root / f"{k:02d}.{ext}").write_bytes(f.read_bytes())
    pairs = [(ds.DatasetCustom(str(tmp_path / "custom")),
              jds.DatasetCustom(str(tmp_path / "custom"))),
             (ds.DataReader(str(tmp_path / "reader")), jds.DataReader(str(tmp_path / "reader")))]
    for mine, theirs in pairs:
        assert len(mine) == len(theirs) == len(files)
        for i in range(len(mine)):
            a, b = mine[i], theirs[i]
            a, b = (a[0], b[0]) if isinstance(a, tuple) else (a, b)
            np.testing.assert_array_equal(a, np.asarray(b), f"item {i}")


def test_decode_pngs_decodes_a_mixed_batch_as_pil_does():
    """One call over files of several shapes, colour types and filters, in a
    shuffled order: 70 filtered images of one shape (two groups of at most
    64), PIL files at 256², unfiltered port files, every filter by hand."""
    rs = np.random.RandomState(7)
    datas = []
    for i in range(70):
        buf = io.BytesIO()
        Image.fromarray(_smooth(rs, 9, 11, 3)).save(buf, "PNG")
        datas.append(buf.getvalue())
    for mode in ("RGB", "RGBA", "L"):
        buf = io.BytesIO()
        _pil_image(mode, rs, 256, 256).save(buf, "PNG")
        datas.append(buf.getvalue())
    for mode in ("P", "LA"):
        buf = io.BytesIO()
        _pil_image(mode, rs, 9, 11).save(buf, "PNG")
        datas.append(buf.getvalue())
    datas += [encode_png(rs.randint(0, 256, (9, 11, 3)).astype(np.uint8)) for _ in range(3)]
    datas.append(encode_png(rs.randint(0, 256, (9, 11)).astype(np.uint8)))
    datas += [_png(rs.randint(0, 256, (11, 27)).astype(np.uint8), 2, [y % 5 for y in range(11)])
              for _ in range(2)]
    datas = [datas[i] for i in rs.permutation(len(datas))]
    got = decode_pngs(datas)
    assert len(got) == len(datas)
    for k, (data, img) in enumerate(zip(datas, got)):
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert img.dtype == np.uint8
        np.testing.assert_array_equal(img, want, err_msg=f"file {k}")


def test_fid_loader_reads_pil_files_as_the_jax_package_does(tmp_path):
    """`_load_images_01` (the port's FID reader) against the JAX package's
    PIL reader on adaptively filtered PIL files, exactly."""
    rs = np.random.RandomState(8)
    files = []
    for i in range(60):
        files.append(tmp_path / f"{i}.png")
        Image.fromarray(_smooth(rs, 40, 24, 3)).save(files[-1])
    got = fid._load_images_01(files)
    for f, img in zip(files, got):
        np.testing.assert_array_equal(img, jfid._load_image_01(f))


@pytest.mark.parametrize("resize", [0, 16])
def test_fid_loader_reads_webp_files_as_the_jax_package_does(tmp_path, resize):
    """A directory of .webp files (`IMAGE_EXTENSIONS` lists webp): lossy
    RGB and grey, lossy RGBA, lossless, each through the port's FID reader
    and `ddgan_tpu/eval/fid.py:_load_image_01`, exactly."""
    rs = np.random.RandomState(13)
    for k, (h, w) in enumerate([(9, 13), (40, 24), (64, 64)]):
        arr = _smooth(rs, h, w, 4)
        for name, im, save in (("lossy", Image.fromarray(arr[:, :, :3]), dict(quality=80)),
                               ("grey", Image.fromarray(arr[:, :, 0]), dict(quality=60)),
                               ("rgba", Image.fromarray(arr), dict(quality=90)),
                               ("lossless", Image.fromarray(arr[:, :, :3]), dict(lossless=True))):
            im.save(tmp_path / f"{k}_{name}.webp", **save)
    files = fid.list_image_files(tmp_path)
    assert files == jfid.list_image_files(tmp_path) and len(files) == 12
    got = fid._load_images_01(files, resize=resize)
    for f, img in zip(files, got):
        np.testing.assert_array_equal(img, jfid._load_image_01(f, resize=resize), str(f))


@pytest.mark.parametrize("resize", [0, 16])
def test_fid_loader_reads_more_tiff_and_jpeg_kinds_as_the_jax_package_does(tmp_path, resize):
    """One file of each kind of `_torch_imagewriters.more_kinds` (CCITT in
    every coding, JPEG-in-TIFF RGB and YCbCr 4:2:0, LZMA, BigTIFF, float
    with predictor 3, signed 16- and 32-bit, fill order 2, YCbCr data units
    under LZW, old-style JPEG, CIELAB, JPEG 4:4:0 and 4:1:1) in one
    directory, through the port's FID reader and
    `ddgan_tpu/eval/fid.py:_load_image_01`, exactly."""
    kinds = W.more_kinds(Image)
    for k, (name, (ext, data)) in enumerate(kinds.items()):
        (tmp_path / f"{k:02d}_{name.replace(' ', '_').replace(':', '')}.{ext}").write_bytes(data)
    files = fid.list_image_files(tmp_path)
    assert files == jfid.list_image_files(tmp_path) and len(files) == len(kinds)
    got = fid._load_images_01(files, resize=resize)
    for f, img in zip(files, got):
        np.testing.assert_array_equal(img, jfid._load_image_01(f, resize=resize), str(f))


def _image_folder(tmp_path, sizes) -> list:
    """JPEGs (RGB at 4:2:0 and 4:4:4, grey) and PNGs (RGB, grey) written
    by PIL, one of each kind at each (H, W)."""
    rs = np.random.RandomState(len(sizes))
    files = []
    for k, (h, w) in enumerate(sizes):
        arr = _smooth(rs, h, w, 3)
        for name, im, save in (("jpg420", Image.fromarray(arr), dict(subsampling=2)),
                               ("jpg444", Image.fromarray(arr), dict(subsampling=0)),
                               ("jpgL", Image.fromarray(arr[:, :, 1]), {}),
                               ("png", Image.fromarray(arr), {}),
                               ("pngL", Image.fromarray(arr[:, :, 2]), {})):
            ext = "png" if name.startswith("png") else "jpg"
            files.append(tmp_path / f"{k}_{name}.{ext}")
            im.save(files[-1], quality=92, **save)
    return files


def test_decode_images_reads_png_and_jpeg_as_pil_does(tmp_path):
    files = _image_folder(tmp_path, [(9, 13), (32, 32), (1, 5)])
    got = decode_images([f.read_bytes() for f in files])
    for f, img in zip(files, got):
        assert img.dtype == np.uint8 and img.ndim == 3
        np.testing.assert_array_equal(img, np.asarray(Image.open(f).convert("RGB")), str(f))


@pytest.mark.parametrize("resize", [8, 37])
def test_fid_loader_resizes_as_the_jax_package_does(tmp_path, resize):
    """`_load_images_01(paths, resize)`: PIL's bilinear to resize² of the RGB
    image, then /255 (`ddgan_tpu/eval/fid.py:31-37`), exactly."""
    files = _image_folder(tmp_path, [(9, 13), (40, 24), (64, 64)])
    got = fid._load_images_01(files, resize=resize)
    for f, img in zip(files, got):
        assert img.shape == (resize, resize, 3)
        np.testing.assert_array_equal(img, jfid._load_image_01(f, resize=resize))


@pytest.mark.parametrize("resize", [0, 8])
def test_fid_activations_over_a_jpeg_folder_equal_jax(tmp_path, resize):
    """`get_activations` over a folder of JPEGs and PNGs, in batches that
    mix them, with and without the resize (sizes differ only where it
    resizes)."""
    sizes = [(20, 20)] * 2 if resize == 0 else [(20, 20), (13, 31)]
    _image_folder(tmp_path, sizes)
    files = fid.list_image_files(tmp_path)
    assert len(files) == 10 and {f.suffix for f in files} == {".jpg", ".png"}
    proj = np.random.RandomState(6).randn(6, 5)

    def feature_fn(b):
        return np.concatenate([b.mean((1, 2)), b.std((1, 2))], 1) @ proj

    got = fid.get_activations(files, feature_fn, batch_size=4, dims=5, resize=resize)
    want = jfid.get_activations(files, feature_fn, 4, 5, resize=resize)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the Fréchet distance
def _stats(seed: int, n: int, d: int):
    a = np.random.RandomState(seed).randn(n, d) @ np.random.RandomState(seed + 1).randn(d, d)
    return a.mean(0), np.cov(a, rowvar=False)


def test_frechet_distance_equals_jax():
    s1, s2 = _stats(0, 200, 32), _stats(2, 150, 32)
    got = fid.calculate_frechet_distance(*s1, *s2)
    want = jfid.calculate_frechet_distance(*s1, *s2)
    assert got > 1 and _rel(got, want) < 1e-10
    assert abs(fid.calculate_frechet_distance(*s1, *s1)) < 1e-6 * np.trace(s1[1])


def test_frechet_distance_eps_retry_equals_jax(monkeypatch, capsys):
    """A product whose square root is not finite is retried with eps on the
    diagonals, as in the reference: here `sqrtm` gives NaN for the first,
    unregularised product of each call."""
    s1, s2 = _stats(4, 40, 16), _stats(6, 50, 16)
    real_sqrtm = linalg.sqrtm

    def sqrtm(m):
        if np.array_equal(m, s1[1].dot(s2[1])):
            return np.full_like(m, np.nan)
        return real_sqrtm(m)

    monkeypatch.setattr(linalg, "sqrtm", sqrtm)
    got = fid.calculate_frechet_distance(*s1, *s2, eps=1e-3)
    ours = capsys.readouterr().out
    want = jfid.calculate_frechet_distance(*s1, *s2, eps=1e-3)
    assert "adding 0.001 to diagonal" in ours and ours == capsys.readouterr().out
    assert np.isfinite(got) and _rel(got, want) < 1e-10
    monkeypatch.setattr(linalg, "sqrtm", real_sqrtm)
    assert _rel(got, fid.calculate_frechet_distance(*s1, *s2)) > 1e-9  # eps moved it


def test_frechet_distance_rejects_an_imaginary_root_as_jax_does():
    mu = np.zeros(3)
    for impl in (fid, jfid):
        with pytest.raises(ValueError, match="Imaginary component"):
            impl.calculate_frechet_distance(mu, np.eye(3), mu, -np.eye(3))


# --------------------------------------------------------------------------
# FID over directories of PNGs, with the same seeded random Inception
@pytest.fixture(scope="module")
def png_dirs(tmp_path_factory):
    """Two directories of 80 PNGs each (PIL-written, so PIL's filters),
    32x32 RGB, from different numpy seeds and brightness."""
    root = tmp_path_factory.mktemp("fid")
    dirs = []
    for k, shift in ((0, 0), (1, 60)):
        d = root / f"set{k}"
        d.mkdir()
        rs = np.random.RandomState(100 + k)
        for i in range(80):
            img = np.clip(_smooth(rs, 32, 32, 3).astype(np.int64) // 2 + shift, 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(d / f"{i}.png")
        dirs.append(str(d))
    return dirs


@pytest.fixture
def random_inception(monkeypatch):
    monkeypatch.setenv(inception.RANDOM_WEIGHTS_ENV, "0")
    monkeypatch.delenv(inception.DEFAULT_WEIGHTS_ENV, raising=False)
    monkeypatch.setenv("DDGAN_TORCH_DEVICE", "cpu")


def test_fid_of_png_dirs_equals_jax_and_stats_files_agree(png_dirs, random_inception, tmp_path):
    got = fid.calculate_fid_given_paths(png_dirs, batch_size=32, dims=64)
    want = jfid.calculate_fid_given_paths(png_dirs, batch_size=32, dims=64)
    assert got > 0.01 and _rel(got, want) < 1e-4

    # .npz from the CLI's --save-stats and from save_statistics, and .npy
    feature_fn = inception.default_feature_fn(64)
    stats = [fid.compute_statistics_of_path(d, feature_fn, 32, 64) for d in png_dirs]
    npz = [str(tmp_path / "a.npz"), str(tmp_path / "b.npz")]
    fid.main(["--save-stats", png_dirs[0], npz[0], "--dims", "64", "--batch-size", "32"])
    fid.save_statistics(npz[1], *stats[1])
    npy = str(tmp_path / "b.npy")
    np.save(npy, {"mu": stats[1][0], "sigma": stats[1][1]})
    from_npz = fid.calculate_fid_given_paths(npz, dims=64, feature_fn=feature_fn)
    from_npy = fid.calculate_fid_given_paths([npz[0], npy], dims=64, feature_fn=feature_fn)
    mixed = fid.calculate_fid_given_paths([png_dirs[0], npz[1]], batch_size=32, dims=64)
    assert _rel(from_npz, got) < 1e-6 and from_npy == from_npz and _rel(mixed, got) < 1e-6
    assert fid.main(npz + ["--dims", "64"]) == from_npz
    with pytest.raises(RuntimeError, match="Invalid path"):
        fid.calculate_fid_given_paths([png_dirs[0], str(tmp_path / "none")], dims=64)


def test_activations_of_arrays_follow_jax(random_inception):
    """Arrays in [0, 255] are scaled (max > 1.5), grey arrays are stacked to
    three channels, and a batch larger than the data is cut to it."""
    rs = np.random.RandomState(8)
    files = [rs.rand(20, 20, 3) * 255, rs.rand(20, 20), rs.rand(20, 20, 3)]

    def feature_fn(b):
        return np.concatenate([b.mean((1, 2)), b.std((1, 2))], 1)[:, None, None, :]

    got = fid.get_activations(files, feature_fn, batch_size=8, dims=6)
    np.testing.assert_array_equal(got, jfid.get_activations(files, feature_fn, 8, 6))
    assert got.max() <= 1.0


# --------------------------------------------------------------------------
# Inception Score
def test_inception_score_equals_jax():
    probs = np.random.RandomState(0).dirichlet(np.ones(10) * 0.3, size=90)
    for splits in (1, 3):
        assert inception_score.inception_score_from_probs(probs, splits) == \
            jis.inception_score_from_probs(probs, splits)
    w = np.random.RandomState(1).randn(3, 12).astype(np.float32)
    images = list(np.random.RandomState(2).rand(30, 8, 8, 3).astype(np.float32))

    def logits_fn(b):
        return b.mean((1, 2)) @ w * 20

    got = inception_score.get_inception_score(images, logits_fn, batch_size=7, splits=3)
    assert got == jis.get_inception_score(images, logits_fn, batch_size=7, splits=3)
    assert got[0] > 1


@pytest.mark.parametrize("case", ["stack01_nchw", "stack255_nhwc", "dir01", "range1", "range255"])
def test_load_sample_array_range_rules_equal_jax(case, tmp_path, capsys):
    rs = np.random.RandomState(3)
    data = rs.rand(4, 3, 6, 6).astype(np.float32)
    value_range = {"range1": "1", "range255": "255"}.get(case, "auto")
    if case == "dir01":
        path = tmp_path / "per_image"
        path.mkdir()
        for i, x in enumerate(data):
            np.save(path / f"{i}.npy", x)
    else:
        path = tmp_path / "stack.npy"
        np.save(path, data.transpose(0, 2, 3, 1) * 255 if case == "stack255_nhwc" else data)
    got = inception_score.load_sample_array(str(path), value_range)
    ours = capsys.readouterr().out
    want = jis.load_sample_array(str(path), value_range)
    assert ours == capsys.readouterr().out
    assert got.shape == (4, 6, 6, 3)
    np.testing.assert_array_equal(got, want)
    for impl in (inception_score, jis):
        with pytest.raises(ValueError, match="value_range"):
            impl.load_sample_array(str(path), "7")


def test_inception_score_cli_with_random_logits(tmp_path, random_inception, capsys):
    """`python -m ddgan_torch.eval.inception_score` on a [0,1] NCHW stack:
    the score of the seeded random classifier, as its parts give it."""
    data = np.random.RandomState(4).rand(3, 3, 16, 16).astype(np.float32)
    np.save(tmp_path / "s.npy", data)
    got = inception_score.main(["--sample_dir", str(tmp_path / "s.npy"), "--batch_size", "2"])
    assert "RANDOM Inception classifier" in capsys.readouterr().out
    want = inception_score.get_inception_score(
        list(data.transpose(0, 2, 3, 1)), inception.default_logits_fn(), batch_size=2, splits=1)
    assert np.isfinite(got[0]) and got[0] >= 1 and got[1] == 0
    assert _rel(got[0], want[0]) < 1e-6


# --------------------------------------------------------------------------
# the folder wrappers
def test_simple_metrics_equal_jax(tmp_path):
    """ImageFolder layouts (class subfolders) and flat folders, with a cheap
    shared numpy feature function and classifier."""
    rs = np.random.RandomState(5)
    for folder, sub in (("real", "cls_a"), ("real", "cls_b"), ("fake", "")):
        d = tmp_path / folder / sub
        d.mkdir(parents=True, exist_ok=True)
        for i in range(12):
            Image.fromarray(_smooth(rs, 10, 10, 3)).save(d / f"{i}.png")
    proj = np.random.RandomState(6).randn(6, 4)

    def feature_fn(b):
        return np.concatenate([b.mean((1, 2)), b.std((1, 2))], 1) @ proj

    real, fake = str(tmp_path / "real"), str(tmp_path / "fake")
    got = simple_metrics.calculate_fid(real, fake, batch_size=5, feature_fn=feature_fn, dims=4)
    want = jsimple.calculate_fid(real, fake, batch_size=5, feature_fn=feature_fn, dims=4)
    assert got > 0 and _rel(got, want) < 1e-10

    def logits_fn(b):
        return feature_fn(b) * 10

    got = simple_metrics.calculate_inception_score(real, logits_fn, batch_size=5, splits=2)
    assert got == jsimple.calculate_inception_score(real, logits_fn, batch_size=5, splits=2)


def test_eval_exports_match_jax():
    import ddgan_tpu.eval as jeval

    import ddgan_torch.eval as teval

    names = [n for n in dir(jeval) if not n.startswith("_") and callable(getattr(jeval, n))]
    assert names and all(callable(getattr(teval, n)) for n in names)
    assert isinstance(teval.InceptionV3FID(output_blocks=(0,)), torch.nn.Module)
