"""The port's data layer (`ddgan_torch.data`) against the JAX package's
(`ddgan_tpu.data`): the same files, written into tmp_path from numpy seeds,
read by both; every comparison is exact (`np.array_equal`, dtypes equal).

The port hands over uint8 arrays where the JAX package hands over PIL
images made from them, so an item is compared as `np.asarray` of the JAX
item. The JAX package's LUNA16 reader is held on its pure-numpy path (its
native slice cache is a C++ speed path the port does not have).
"""

import pickle
import struct
import threading
import time

import numpy as np
import pytest

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


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("dataset", ["custom", "lsun", "celeba_256", "celeba"])
def test_image_file_datasets_raise_naming_item_13(dataset):
    with pytest.raises(NotImplementedError, match="item 13"):
        tdata.make_dataset(Config(dataset=dataset))


@pytest.mark.parametrize("cls", ["DatasetCustom", "DataReader", "HeavyDatasetCustom",
                                 "Luna16Dataset2"])
def test_pil_datasets_raise_naming_item_13(tmp_path, cls):
    with pytest.raises(NotImplementedError, match="item 13"):
        getattr(tdata, cls)(str(tmp_path))


def test_resize_raises_naming_item_13():
    with pytest.raises(NotImplementedError, match="item 13"):
        tdata.build_transform(Config(do_resize="yes"))
    assert tdata.build_transform(Config(to_tensor_transform="no")) is None
