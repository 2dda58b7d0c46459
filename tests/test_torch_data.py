"""The port's data layer (`ddgan_torch.data`) against the JAX package's
(`ddgan_tpu.data`): the same files, written into tmp_path from numpy seeds,
read by both; every comparison is exact (`np.array_equal`, dtypes equal).

The port hands over uint8 arrays where the JAX package hands over PIL
images made from them, so an item is compared as `np.asarray` of the JAX
item. The JAX package's LUNA16 reader is held on its pure-numpy path, and
on its native slice cache where the port's cache of decoded volumes
(`ddgan_torch.data.slicecache`) is held against it. Image files (JPEG,
PNG) are written by PIL and read by both packages.
"""

import csv
import pickle
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

import ddgan_tpu.data as jdata
from ddgan_tpu import native as jnative
from ddgan_tpu.config import Config as JConfig

import ddgan_torch.data as tdata
from ddgan_torch.config import Config


def assert_same(got, want):
    want = np.asarray(want)
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.fixture
def numpy_luna(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


# ---------------------------------------------------------------- NIfTI
@pytest.mark.parametrize("suffix", [".nii.gz", ".nii"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32, np.float64])
def test_nifti_written_by_each_is_read_by_the_other(tmp_path, suffix, dtype):
    vol = np.random.RandomState(0).randint(-50, 200, (9, 7, 5)).astype(dtype)
    if dtype == np.uint8:
        vol = np.abs(vol).astype(dtype)
    jdata.write_nifti(tmp_path / f"j{suffix}", vol)
    tdata.write_nifti(tmp_path / f"t{suffix}", vol)
    if suffix == ".nii":  # (a gzip header carries the write time)
        assert (tmp_path / "j.nii").read_bytes() == (tmp_path / "t.nii").read_bytes()
    j, t = tmp_path / f"j{suffix}", tmp_path / f"t{suffix}"
    assert_same(tdata.read_nifti(j), jdata.read_nifti(j))
    assert_same(tdata.read_nifti(j), jdata.read_nifti(t))
    assert_same(tdata.read_nifti(t), vol.astype(np.float64))


# ---------------------------------------------------------------- transforms
@pytest.mark.parametrize("shape", [(10, 12), (10, 12, 3), (5, 6), (6, 5, 3)])
@pytest.mark.parametrize("name", ["ToTensor", "CenterCrop"])
def test_transform_of_an_array_is_the_jax_ones_of_its_pil_image(shape, name):
    """The port's datasets hand over the uint8 array the JAX package makes a
    PIL image of; each transform gives what the JAX one gives of that
    image (CenterCrop(8) pads the two small shapes)."""
    from PIL import Image

    from ddgan_tpu.data import transforms as jt

    from ddgan_torch.data import transforms as tt

    arr = np.random.RandomState(len(shape)).randint(0, 256, shape).astype(np.uint8)
    make = (lambda m: m.ToTensor()) if name == "ToTensor" else (lambda m: m.CenterCrop(8))
    assert_same(make(tt)(arr), make(jt)(Image.fromarray(arr)))


# ---------------------------------------------------------------- LUNA16
VOL = (48, 40, 36)


def _luna_files(tmp_path, n_files=2):
    data_dir, mask_dir = tmp_path / "data", tmp_path / "masks"
    data_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(n_files):
        mask = np.zeros(VOL, np.uint8)
        mask[10 + i:16 + i, 20:24, 3:9] = 1
        jdata.write_nifti(data_dir / f"case{i}.nii.gz", rng.randint(0, 255, VOL).astype(np.uint8))
        jdata.write_nifti(mask_dir / f"case{i}.nii.gz", mask)
    return str(data_dir), str(mask_dir)


def _both(cls_name, *args, **kwargs):
    return getattr(jdata, cls_name)(*args, **kwargs), getattr(tdata, cls_name)(*args, **kwargs)


def _transform(**flags):
    cfg = dict(image_size=12, num_channels=1, to_tensor_transform="no", use_normalize="no",
               CenterCrop="no")
    cfg.update(flags)
    return jdata.build_transform(JConfig(**cfg)), tdata.build_transform(Config(**cfg))


def _assert_items(jds, tds, indices=None):
    assert len(tds) == len(jds)
    for i in indices if indices is not None else range(len(jds)):
        (jx, jy), (tx, ty) = jds[i], tds[i]
        assert_same(tx, jx)
        assert ty == jy


@pytest.mark.parametrize("layout", ["single_axis_z", "single_axis_x", "all_axes", "fast_memory"])
def test_luna16_slices_and_items_match(tmp_path, monkeypatch, numpy_luna, layout):
    data_dir, mask_dir = _luna_files(tmp_path)
    monkeypatch.chdir(tmp_path)
    kw = dict(bound_exp_lim=2, single_axis=layout != "all_axes",
              _where="x" if layout == "single_axis_x" else "z",
              fast_memory=layout == "fast_memory")
    jds = jdata.Luna16Dataset(data_dir, mask_dir, **kw)
    j_cache = (tmp_path / "slices_info.txt").read_text()
    tds = tdata.Luna16Dataset(data_dir, mask_dir, **kw)
    assert (tmp_path / "slices_info.txt").read_text() == j_cache  # the cache each writes
    assert tds.slice_info == jds.slice_info and len(tds.slice_info) > 10
    if layout == "all_axes":
        assert {a for _, a, _ in tds.slice_info} == {"x", "y", "z"}
    n = len(jds)
    _assert_items(jds, tds, [0, n // 2, n - 1])


def test_luna16_cache_and_transforms_match(tmp_path, monkeypatch, numpy_luna):
    data_dir, mask_dir = _luna_files(tmp_path, n_files=1)
    monkeypatch.chdir(tmp_path)
    scanned = jdata.Luna16Dataset(data_dir, mask_dir, bound_exp_lim=1)
    cache = tmp_path / "SlicesInfoZ.txt"
    tdata.save_slice_info(scanned.slice_info, str(cache))
    assert tdata.load_slice_info(str(cache)) == jdata.load_slice_info(str(cache))
    jt, tt = _transform(to_tensor_transform="yes", use_normalize="yes", CenterCrop="yes")
    jds = jdata.Luna16Dataset(data_dir, mask_dir, transform=jt, path_to_slices_info=str(cache))
    tds = tdata.Luna16Dataset(data_dir, mask_dir, transform=tt, path_to_slices_info=str(cache))
    assert tds.slice_info == jds.slice_info == scanned.slice_info
    _assert_items(jds, tds, [0, len(jds) - 1])
    assert tds[0][0].shape == (12, 12, 1) and tds[0][0].dtype == np.float32


@pytest.mark.parametrize("bounders", [2, 3])
def test_luna16_3d_groups_match(tmp_path, monkeypatch, numpy_luna, bounders):
    data_dir, mask_dir = _luna_files(tmp_path)
    monkeypatch.chdir(tmp_path)
    jds, tds = _both("Luna16Dataset", data_dir, mask_dir, bound_exp_lim=2, _3d=True,
                     bounders=bounders, single_axis=True, _where="z")
    assert tds._3d_slices_info == jds._3d_slices_info and len(tds) > 0
    _assert_items(jds, tds)
    assert tds[0][0].shape == VOL[:2] + (bounders * bounders,)


# ---------------------------------------------------------------- patches
@pytest.mark.parametrize("limited", [True, False])
@pytest.mark.parametrize("flags", [{}, {"to_tensor_transform": "yes", "CenterCrop": "yes"}])
def test_positive_patch_items_match(tmp_path, limited, flags):
    for case, seed in (("case1", 0), ("case2", 1)):
        (tmp_path / case).mkdir()
        np.save(tmp_path / case / "p_label_1.npy", np.random.RandomState(seed).rand(64, 20, 20))
    np.save(tmp_path / "case1" / "n_label_0.npy", np.zeros((64, 20, 20)))
    jt, tt = _transform(**flags)
    jds = jdata.PositivePatchDataset(str(tmp_path), transform=jt, limited_slices=limited)
    tds = tdata.PositivePatchDataset(str(tmp_path), transform=tt, limited_slices=limited)
    assert tds.slice_info == jds.slice_info and len(tds) == (16 if limited else 128)
    _assert_items(jds, tds, [0, 7, len(jds) - 1])


# ---------------------------------------------------------------- StackMNIST
def _write_idx(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x800 + arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("transform", ["none", "stacked_mnist"])
def test_stackmnist_items_match(tmp_path, transform):
    _write_idx(tmp_path / "train-images-idx3-ubyte",
               np.random.RandomState(0).randint(0, 256, (10, 28, 28)))
    _write_idx(tmp_path / "train-labels-idx1-ubyte", np.arange(10))
    jt = tt = None
    if transform != "none":
        jt, tt = jdata.stackmnist.data_transforms_stacked_mnist()[0], \
            tdata.data_transforms_stacked_mnist()[0]
    jds = jdata.StackedMNIST(str(tmp_path), transform=jt, rng=np.random.default_rng(4))
    tds = tdata.StackedMNIST(str(tmp_path), transform=tt, rng=np.random.default_rng(4))
    _assert_items(jds, tds)
    assert tds[0][0].shape == ((28, 28, 3) if transform == "none" else (32, 32, 3))
    cfg = Config(dataset="stackmnist", data_dir=str(tmp_path), to_tensor_transform="no")
    ds = tdata.make_dataset(cfg)
    assert isinstance(ds, tdata.StackedMNIST) and ds[0][0].shape == (32, 32, 3)


# ---------------------------------------------------------------- CIFAR-10
def _cifar_files(tmp_path, per_batch=6):
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.RandomState(3)
    for i in range(1, 6):
        with open(base / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (per_batch, 3072), dtype=np.uint8),
                         b"labels": list(rng.randint(0, 10, per_batch))}, f)
    return str(tmp_path)


@pytest.mark.parametrize("flags", [{}, {"to_tensor_transform": "yes", "use_normalize": "yes"}])
def test_cifar10_items_match(tmp_path, flags):
    root = _cifar_files(tmp_path)
    cfg = dict(dataset="cifar10", data_dir=root, num_channels=3, image_size=32,
               to_tensor_transform="no", use_normalize="no", CenterCrop="no")
    cfg.update(flags)
    jds, tds = jdata.make_dataset(JConfig(**cfg)), tdata.make_dataset(Config(**cfg))
    assert isinstance(tds, tdata.CIFAR10) and len(tds) == 30
    _assert_items(jds, tds)
    assert_same(tds.data, jds.data)


# ---------------------------------------------------------------- loader
def _epochs(loader, n=3):
    out = []
    for e in range(n):
        loader.set_epoch(e)
        out.append(list(loader))
    return out


def _assert_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        for (gx, gy), (wx, wy) in zip(g, w):
            assert_same(gx, wx)
            assert_same(gy, wy)


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("shard", [None, 0, 1])
def test_loader_batches_match_for_three_epochs(workers, shard):
    kw = dict(batch_size=5, shuffle=True, drop_last=True, seed=7, num_workers=workers)
    if shard is not None:
        kw.update(num_shards=2, shard_id=shard)
    # 63 images: two shards pad the permutation to 64
    jds = jdata.SyntheticDataset(n=63, image_size=4, num_channels=2, seed=1)
    tds = tdata.SyntheticDataset(n=63, image_size=4, num_channels=2, seed=1)
    assert_same(tds.data, jds.data)
    got, want = _epochs(tdata.DataLoader(tds, **kw)), _epochs(jdata.DataLoader(jds, **kw))
    _assert_batches(got, want)
    assert not np.array_equal(got[0][0][0], got[1][0][0])  # each epoch reshuffles


class PerImage:
    """A dataset's items without the array `data` that the loader's
    vectorized batch path needs: the loader takes the per-image path."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


@pytest.mark.parametrize("vectorized", [True, False])
def test_loader_uint8_paths_match(tmp_path, vectorized):
    """CIFAR-10 through ToTensor → Normalize, on the vectorized uint8 batch
    path and on the per-image path: each equals the JAX loader's on the
    same path, and the two paths agree within the rounding of a multiply
    by 1/255 against a division by 255 (atol 1e-6, as tests/test_data.py)."""
    root = _cifar_files(tmp_path)
    jt, tt = _transform(to_tensor_transform="yes", use_normalize="yes", num_channels=3)
    jds, tds = jdata.CIFAR10(root, transform=jt), tdata.CIFAR10(root, transform=tt)
    if not vectorized:
        jds, tds = PerImage(jds), PerImage(tds)
    kw = dict(batch_size=4, seed=3)
    tl = tdata.DataLoader(tds, **kw)
    assert (tl._vectorized_transform() is not None) if vectorized else not hasattr(tds, "data")
    got = _epochs(tl)
    _assert_batches(got, _epochs(jdata.DataLoader(jds, **kw)))
    if not vectorized:
        fast = _epochs(tdata.DataLoader(tds.ds, **kw))
        for g, f in zip(got, fast):
            for (gx, gy), (fx, fy) in zip(g, f):
                np.testing.assert_allclose(gx, fx, rtol=0, atol=1e-6)
                assert np.array_equal(gy, fy)


def test_loader_early_exit_leaves_no_worker():
    ds = tdata.SyntheticDataset(n=128, image_size=4, num_channels=1)
    before = threading.active_count()
    it = iter(tdata.DataLoader(ds, batch_size=8, seed=3, num_workers=4, prefetch=2))
    first = [next(it), next(it)]
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    want = list(jdata.DataLoader(jdata.SyntheticDataset(n=128, image_size=4, num_channels=1),
                                 batch_size=8, seed=3))[:2]
    _assert_batches([first], [want])


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_worker_error_reaches_the_consumer(workers):
    class BadDataset:
        def __len__(self):
            return 32

        def __getitem__(self, i):
            if i == 13:
                raise OSError("corrupt file")
            return np.zeros((4, 4, 1), np.float32), 0

    loader = tdata.DataLoader(BadDataset(), batch_size=4, shuffle=False, num_workers=workers)
    with pytest.raises(OSError, match="corrupt file"):
        for _ in loader:
            pass


def test_make_dataset_synthetic_matches():
    cfg = dict(dataset="synthetic", image_size=8, num_channels=3, seed=5)
    jds, tds = jdata.make_dataset(JConfig(**cfg)), tdata.make_dataset(Config(**cfg))
    assert isinstance(tds, tdata.SyntheticDataset) and len(tds) == 256
    assert_same(tds.data, jds.data)
    _assert_items(jds, tds, [0, 255])


# ---------------------------------------------------------------- image files
def _smooth(rs, h, w, c):
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [127 + 90 * np.sin(a * xx + p) * np.cos(b * yy) + rs.normal(0, 14, (h, w))
              for a, b, p in rs.uniform(0.02, 0.25, (c, 3))]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def _custom_folder(tmp_path, split="train"):
    """data_dir/{split}/{class}/*.jpg: RGB at 4:2:0 and 4:4:4 and a grey
    JPEG, of sizes that need a resize and a crop, and a PNG that the glob
    leaves out."""
    rs = np.random.RandomState(11)
    for cls in ("cats", "dogs"):
        folder = tmp_path / split / cls
        folder.mkdir(parents=True)
        for i, (h, w) in enumerate([(20, 26), (31, 17), (24, 24)]):
            arr = _smooth(rs, h, w, 3)
            im = Image.fromarray(arr[:, :, 0]) if i == 2 else Image.fromarray(arr)
            im.save(folder / f"{i}.jpg", quality=90, subsampling=2 * (i % 2))
        Image.fromarray(_smooth(rs, 8, 8, 3)).save(folder / "skip.png")
    return str(tmp_path)


@pytest.mark.parametrize("flags", [
    {},
    {"to_tensor_transform": "yes", "use_normalize": "yes", "CenterCrop": "yes"},
    {"do_resize": "yes", "to_tensor_transform": "yes", "use_normalize": "yes",
     "CenterCrop": "yes"},
    {"do_resize": "yes"},
], ids=["none", "tensor_norm_crop", "resize_tensor_norm_crop", "resize"])
def test_make_dataset_custom_items_match(tmp_path, flags):
    cfg = dict(dataset="custom", data_dir=_custom_folder(tmp_path), mode="train",
               image_size=16, num_channels=3, to_tensor_transform="no", use_normalize="no",
               CenterCrop="no")
    cfg.update(flags)
    jds, tds = jdata.make_dataset(JConfig(**cfg)), tdata.make_dataset(Config(**cfg))
    assert isinstance(tds, tdata.DatasetCustom) and len(tds) == 6
    assert tds.images_all == jds.images_all
    _assert_items(jds, tds)
    if flags.get("CenterCrop") == "yes":
        assert tds[0][0].shape == (16, 16, 3) and tds[0][0].dtype == np.float32


def test_dataset_custom_splits_and_missing_split(tmp_path):
    root = _custom_folder(tmp_path, split="val")
    jds, tds = _both("DatasetCustom", root, class_="val")
    _assert_items(jds, tds)
    for mod in (jdata, tdata):
        with pytest.raises(FileNotFoundError, match="one of \\[train, val, test\\]"):
            mod.DatasetCustom(root, class_="train")


@pytest.mark.parametrize("with_transform", [False, True])
def test_data_reader_items_match(tmp_path, with_transform):
    rs = np.random.RandomState(2)
    for cls, modes in (("a", ("RGB", "L")), ("b", ("RGBA", "P"))):
        (tmp_path / cls).mkdir()
        for mode in modes:
            im = Image.fromarray(_smooth(rs, 13, 10, 3))
            im = im.quantize(200) if mode == "P" else im.convert(mode)
            im.save(tmp_path / cls / f"{mode}.png")
    jt, tt = (_transform(to_tensor_transform="yes", num_channels=3, do_resize="yes")
              if with_transform else (None, None))
    jds = jdata.DataReader(str(tmp_path), transform=jt)
    tds = tdata.DataReader(str(tmp_path), transform=tt)
    assert len(tds) == len(jds) == 4
    for i in range(4):
        assert_same(tds[i], jds[i])


@pytest.mark.parametrize("with_transform", [False, True])
def test_heavy_dataset_items_match(tmp_path, with_transform):
    """The CSV manifest: two volumes, their items in order and out of order
    (the single-volume cache switches), and from threads."""
    rs = np.random.RandomState(4)
    rows = []
    for i, shape in enumerate([(5, 9, 11), (3, 12, 10)]):
        path = tmp_path / f"vol{i}.nii.gz"
        jdata.write_nifti(path, rs.uniform(-40, 300, shape).astype(np.float32))
        rows.append({"Path": str(path), "Class": str(i), "ShapeZiro": str(shape[0])})
    manifest = tmp_path / "manifest.csv"
    with open(manifest, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["Path", "Class", "ShapeZiro"])
        writer.writeheader()
        writer.writerows(rows)
    jt, tt = (_transform(to_tensor_transform="yes", use_normalize="yes", CenterCrop="yes")
              if with_transform else (None, None))
    jds = jdata.HeavyDatasetCustom(str(manifest), transform=jt)
    tds = tdata.HeavyDatasetCustom(str(manifest), transform=tt)
    assert tds.index == jds.index and len(tds) == 8
    _assert_items(jds, tds, [0, 6, 1, 7, 5, 2])
    with ThreadPoolExecutor(max_workers=4) as pool:
        got = list(pool.map(lambda i: tds[i][0], [0, 5, 1, 6, 2, 7] * 4))
    for i, g in zip([0, 5, 1, 6, 2, 7] * 4, got):
        assert_same(g, np.asarray(jds[i][0]))


@pytest.mark.parametrize("jax_path", ["numpy", "native"])
@pytest.mark.parametrize("shape", [(230, 210, 6), (64, 70, 12)], ids=["partly_past", "small"])
def test_luna16_dataset2_items_match(tmp_path, monkeypatch, jax_path, shape):
    """Crop (40, 60, 220, 200) then PIL's bicubic to 64², on int16 CT values
    (-1024..3071); the box runs past the smaller slices' edges."""
    if jax_path == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert jnative.available()
    rs = np.random.RandomState(sum(shape))
    for sub in ("data", "masks"):
        (tmp_path / sub).mkdir()
    mask = np.zeros(shape, np.uint8)
    mask[20:30, 30:40, 2:4] = 1
    jdata.write_nifti(tmp_path / "data" / "c.nii.gz",
                      rs.randint(-1024, 3072, shape).astype(np.int16))
    jdata.write_nifti(tmp_path / "masks" / "c.nii.gz", mask)
    monkeypatch.chdir(tmp_path)
    jt, tt = _transform(to_tensor_transform="yes", use_normalize="yes")
    jds, tds = _both("Luna16Dataset2", str(tmp_path / "data"), str(tmp_path / "masks"),
                     bound_exp_lim=1)
    jds.transform, tds.transform = jt, tt
    assert tds.slice_info == jds.slice_info and len(tds) == 4
    _assert_items(jds, tds)
    assert tds[0][0].shape == (64, 64, 1)


@pytest.mark.parametrize("shape", [(10, 12), (12, 10), (10, 12, 3), (6, 5, 3), (1, 7), (8, 8)])
def test_resize_transform_matches(shape):
    """`Resize(8)`: the smaller edge to 8 with Python's round, then PIL's
    bilinear (`ddgan_tpu/data/transforms.py:27-39`)."""
    from ddgan_tpu.data import transforms as jt

    from ddgan_torch.data import transforms as tt

    arr = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    assert_same(tt.Resize(8)(arr), jt.Resize(8)(Image.fromarray(arr)))
    assert tdata.build_transform(Config(to_tensor_transform="no")) is None
    pipeline = tdata.build_transform(Config(do_resize="yes", image_size=8,
                                            to_tensor_transform="no", use_normalize="no",
                                            CenterCrop="no"))
    assert [type(t) for t in pipeline.transforms] == [tt.Resize]


# ---------------------------------------------------------------- volume cache
def _ct_volume(path, shape, seed):
    """int16 CT values, -1024..3071: astype(np.uint8) wraps them."""
    vol = np.random.RandomState(seed).randint(-1024, 3072, shape).astype(np.int16)
    jdata.write_nifti(path, vol)
    return vol


def test_slice_cache_equals_the_uncached_reader(tmp_path):
    from ddgan_torch.data import slicecache

    paths = [tmp_path / f"v{i}.nii.gz" for i in range(3)]
    for i, p in enumerate(paths):
        _ct_volume(p, (9, 7, 5), seed=i)
    cache = slicecache.VolumeCache(capacity=2)
    for _ in range(2):
        for p in paths:
            vol = tdata.read_nifti(p)
            got = cache.get(p)
            assert_same(got, vol)
            assert not got.flags.writeable
    assert len(cache) == 2 and cache.decodes == 6 and cache.hits == 0  # LRU of 2 over 3
    assert cache.get(paths[2]) is cache.get(paths[2]) and cache.hits == 2
    for axis, n in zip("xyz", (9, 7, 5)):
        for index in (0, n - 1):
            got = slicecache.read_slice(paths[2], axis, index)
            want = np.take(vol, index, axis="xyz".index(axis))
            assert_same(got, want)
            got[...] = 0  # a copy: the cached volume is not touched
    assert_same(slicecache.volume(paths[2]), tdata.read_nifti(paths[2]))
    with pytest.raises(IndexError):
        slicecache.read_slice(paths[2], "z", 5)
    # a rewritten file is decoded again
    _ct_volume(paths[2], (9, 7, 6), seed=9)
    assert slicecache.volume(paths[2]).shape == (9, 7, 6)
    # no cache: every request decodes
    none = slicecache.VolumeCache(capacity=0)
    assert_same(none.get(paths[0]), none.get(paths[0]))
    assert len(none) == 0 and none.decodes == 2


def test_slice_cache_decodes_a_volume_once_across_threads(tmp_path):
    from ddgan_torch.data import slicecache

    path = tmp_path / "v.nii.gz"
    _ct_volume(path, (16, 16, 16), seed=0)
    calls = []

    def slow_reader(p):
        calls.append(p)
        time.sleep(0.05)
        return tdata.read_nifti(p)

    cache = slicecache.VolumeCache(reader=slow_reader)
    with ThreadPoolExecutor(max_workers=8) as pool:
        vols = list(pool.map(lambda _: cache.get(path), range(16)))
    assert len(calls) == 1 and all(v is vols[0] for v in vols)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_slice_cache_slices_equal_the_jax_native_module(tmp_path, axis):
    """uint8 slices of an int16 volume of CT values: the port's (the cached
    float64 volume, then astype(np.uint8)) equal both of the JAX package's
    paths, the native C++ cache (float32, truncated to int64, wrapped) and
    its numpy reader (astype(np.uint8), custom.py:200)."""
    from ddgan_torch.data import slicecache

    assert jnative.available()
    path = str(tmp_path / "ct.nii.gz")
    vol = _ct_volume(path, (12, 10, 8), seed=3)
    n = vol.shape["xyz".index(axis)]
    for index in range(n):
        port = slicecache.read_slice(path, axis, index).astype(np.uint8)
        native = jnative.read_slice_u8(path, axis, index)
        numpy_path = np.take(vol, index, axis="xyz".index(axis))
        assert_same(port, native)
        assert_same(port, numpy_path.astype(np.float64).astype(np.uint8))
    assert (vol < 0).any() and (vol > 255).any()
