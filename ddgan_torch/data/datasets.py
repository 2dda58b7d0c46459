"""LUNA16 / patch / folder datasets (reference: datasets_prep/custom.py,
datasets_prep/heavy_custom.py, datasets_prep/datareader.py).

The port's own copy of `ddgan_tpu/data/datasets.py`, without PIL. Items are
the uint8 arrays that the JAX package wraps in PIL images, so `ToTensor`
gives what it gives there: image files are decoded by `utils.decode_images`
(PNG, JPEG, WebP, BMP, PBM/PGM/PPM and TIFF, told by their first bytes)
as PIL's `convert("RGB")` gives them, and `Luna16Dataset2`'s resize is PIL's bicubic
(`data/resize.py`). LUNA16 volumes are read through the process-wide LRU of
decoded volumes (`data/slicecache.py`), as the JAX package reads them
through its native slice cache.

All datasets implement the plain protocol `__len__` / `__getitem__ ->
(image, label)`; `DataReader` returns the image only.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Callable

import numpy as np

from ..utils import decode_images
from . import slicecache
from .nifti import read_nifti
from .resize import BICUBIC, resize


def save_slice_info(data, txt_file_path: str = "./slices_info.txt") -> None:
    """Write '(path, axis, index)' lines — same format as the shipped
    configs/SlicesInfo*.txt caches (additionals/utilities.py:181-187)."""
    with open(txt_file_path, "w") as f:
        for item in data:
            f.write(f"{item[0]}, {item[1]}, {item[2]}\n")


def load_slice_info(file_path: str):
    """Parse the slice-info cache format (additionals/utilities.py:189-195)."""
    loaded = []
    with open(file_path) as f:
        for line in f:
            parts = line.strip().split(", ")
            loaded.append((parts[0], parts[1], int(parts[2])))
    return loaded


class Luna16Dataset:
    """Lazy per-slice reader over 256³ CT volumes + nodule masks.

    Reference: datasets_prep/custom.py:15-216. Scans each mask's nonzero
    bounding box (expanded by bound_exp_lim), emits (file, axis, index)
    slice records either single-axis or all-axes; supports the txt cache,
    3-D stacks of `bounders` slices, and fast_memory preloading.
    """

    DATA_SHAPE = (256, 256, 256)

    def __init__(
        self,
        data_dir: str,
        mask_dir: str | None = None,
        transform: Callable | None = None,
        bound_exp_lim: int = 5,
        _3d: bool = False,
        bounders: int | None = None,
        single_axis: bool = True,
        _where: str | None = None,
        fast_memory: bool = False,
        path_to_slices_info: str | None = None,
    ):
        self.transform = transform
        self.data_dir = data_dir
        self.mask_dir = mask_dir
        self.bound_exp_lim = bound_exp_lim
        self.fast_memory = fast_memory
        self._3d = _3d
        self._3d_slices_info = [] if _3d else None
        self.slices = []
        self.bounders = bounders
        self.single_axis = single_axis
        if single_axis:
            _where = _where if _where is not None else "z"
            self._where_all = [_where]
        else:
            self._where_all = ["x", "y", "z"]

        if path_to_slices_info is not None:
            self.slice_info = load_slice_info(path_to_slices_info)
        else:
            self.slice_info = []
            self._prepare_dataset()
            save_slice_info(self.slice_info)

        if self._3d:
            self._build_3d_groups()
        if self.fast_memory:
            self._preload()

    # -- index construction -------------------------------------------------
    def _prepare_dataset(self):
        if not os.path.isdir(self.data_dir):
            raise FileNotFoundError(f"data_dir not found: {self.data_dir}")
        if self.mask_dir is None:
            raise FileNotFoundError("mask_dir is required to scan slices")
        nii_files = sorted(
            os.path.join(self.data_dir, f)
            for f in os.listdir(self.data_dir)
            if f.endswith(".nii.gz")
        )
        if not nii_files:
            raise FileNotFoundError("No volumes found in the specified directory.")
        for nii_path in nii_files:
            mask_path = os.path.join(self.mask_dir, os.path.split(nii_path)[-1])
            handled = self._bounds_from_mask(np.nonzero(slicecache.volume(mask_path)))
            if handled is None:
                continue
            for axis, rng in zip(("x", "y", "z"), handled):
                if axis in self._where_all:
                    for i in rng:
                        self.slice_info.append((nii_path, axis, int(i)))

    def _bounds_from_mask(self, idx):
        """Nonzero bounding box expanded by bound_exp_lim, as slice ranges
        (custom.py:87-112); None for an empty mask."""
        if len(idx) < 3 or idx[0].size == 0:
            return None
        shape = self.DATA_SHAPE
        lo = [int(idx[a].min()) for a in range(3)]
        hi = [int(idx[a].max()) + 1 for a in range(3)]
        hi = [h if h < shape[a] else h - 1 for a, h in enumerate(hi)]
        for a in range(3):
            if lo[a] > self.bound_exp_lim:
                lo[a] -= self.bound_exp_lim
            if hi[a] + self.bound_exp_lim < shape[a]:
                hi[a] += self.bound_exp_lim
        step = self.bounders if self._3d else 1
        return tuple(range(lo[a], hi[a], step) for a in range(3))

    def _build_3d_groups(self):
        """Group consecutive same-volume slices into stacks of `bounders`
        (reference __get_bounds__, custom.py:115-151)."""
        by_key: dict[tuple[str, str], list[int]] = {}
        for path, axis, index in self.slice_info:
            if axis in self._where_all:
                by_key.setdefault((path, axis), []).append(index)
        for (path, axis), indices in by_key.items():
            while len(indices) >= (self.bounders or 1) + 1:
                group = indices[: self.bounders + 1]
                self._3d_slices_info.append((path, axis, group))
                indices = indices[self.bounders :]

    def _preload(self):
        for path, axis, index in self.slice_info:
            self.slices.append(self._read_slice(path, axis, index))

    # -- access --------------------------------------------------------------
    @staticmethod
    def _read_slice(path, axis, index):
        """One 2-D slice, from the cache of decoded volumes (the reference
        decodes the whole volume for each slice, custom.py:190)."""
        return slicecache.read_slice(path, axis, index)

    def __getitem__(self, index):
        if self._3d:
            path, axis, group = self._3d_slices_info[index]
            patch = slicecache.volume(path)
            lo, hi = group[0], group[-1]
            if axis == "x":
                img = patch[lo:hi, :, :]
            elif axis == "y":
                img = patch[:, lo:hi, :]
            else:
                img = patch[:, :, lo:hi]
        else:
            if self.fast_memory:
                img = self.slices[index]
            else:
                path, axis, idx = self.slice_info[index]
                img = self._read_slice(path, axis, idx)
        img = np.asarray(img).astype(np.uint8)
        if self.transform is not None:
            img = self.transform(img)
        return img, 1  # dummy label (custom.py:204)

    def __len__(self):
        if self._3d:
            return len(self._3d_slices_info)
        return len(self.slices) if self.fast_memory else len(self.slice_info)


class Luna16Dataset2(Luna16Dataset):
    """2-D-only variant with hardcoded crop (40,60,220,200) → 64².

    Reference: datasets_prep/custom.py:222-358 (orphan, kept for parity).
    PIL's `.crop(box).resize((64, 64))` (`ddgan_tpu/data/datasets.py:251-252`):
    the crop fills with zeros past the slice's edge, and the resize takes
    PIL's default filter for an "L" image, bicubic.
    """

    CROP_BOX = (40, 60, 220, 200)  # PIL's (left, upper, right, lower)
    SIZE = (64, 64)

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("_3d", False)
        super().__init__(*args, **kwargs)

    def __getitem__(self, index):
        if self.fast_memory:
            img = self.slices[index]
        else:
            path, axis, idx = self.slice_info[index]
            img = self._read_slice(path, axis, idx)
        img = resize(crop(np.asarray(img).astype(np.uint8), self.CROP_BOX), self.SIZE, BICUBIC)
        if self.transform is not None:
            img = self.transform(img)
        return img, 1


def crop(img: np.ndarray, box) -> np.ndarray:
    """PIL's `Image.crop((left, upper, right, lower))` of an (H, W[, C])
    array: the region, with zeros where it runs past the image."""
    left, upper, right, lower = box
    out = np.zeros((lower - upper, right - left) + img.shape[2:], img.dtype)
    h, w = img.shape[:2]
    y0, y1, x0, x1 = max(upper, 0), min(lower, h), max(left, 0), min(right, w)
    if y0 < y1 and x0 < x1:
        out[y0 - upper:y1 - upper, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


class PositivePatchDataset:
    """64³ .npy patches matching '*/*label_1.npy'; one sample per slice,
    stride 8 when limited_slices; min-max → uint8. (custom.py:364-421)"""

    def __init__(self, data_dir, transform=None, limited_slices=False):
        self.transform = transform
        self.data_dir = data_dir
        self.limited_slices = limited_slices
        self.slice_info = []
        self._prepare_dataset()

    def _prepare_dataset(self):
        if not os.path.isdir(self.data_dir):
            raise FileNotFoundError(f"data_dir not found: {self.data_dir}")
        npy_files = sorted(glob.glob(os.path.join(self.data_dir, "*/*label_1.npy")))
        if not npy_files:
            raise FileNotFoundError("No positive patches found in the specified directory.")
        num_slices = 64
        num_skip = 8 if self.limited_slices else 1
        for path in npy_files:
            for slice_index in range(0, num_slices, num_skip):
                self.slice_info.append((path, slice_index))

    def __len__(self):
        return len(self.slice_info)

    def __getitem__(self, index):
        path, slice_index = self.slice_info[index]
        patch = np.load(path)
        if slice_index < 0 or slice_index >= patch.shape[0]:
            raise IndexError(f"Slice index {slice_index} out of bounds")
        img = patch[slice_index, :, :]
        img = img - np.min(img)
        rng = np.max(img)
        img = img / rng if rng != 0 else np.zeros_like(img)
        img = (img * 255).astype(np.uint8)
        if self.transform is not None:
            img = self.transform(img)
        return img, 1


def _read_image(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_images([f.read()])[0]


class DatasetCustom:
    """Generic data_dir/{train,val,test}/*/*.jpg folder dataset. (custom.py:426-459)"""

    def __init__(self, data_dir, class_="train", transform=None):
        self.class_ = class_
        self.transform = transform
        data_path = os.path.join(data_dir, class_)
        if not os.path.isdir(data_path):
            raise FileNotFoundError(
                "The class_ param should be one of [train, val, test]!"
            )
        self.images_all = sorted(glob.glob(data_path + "/*/*.jpg"))

    def __getitem__(self, index):
        image = _read_image(self.images_all[index])
        if self.transform is not None:
            image = self.transform(image)
        return image, "Dumm"

    def __len__(self):
        return len(self.images_all)


class DataReader:
    """Flat root/*/*.png reader returning image only. (datasets_prep/datareader.py)"""

    def __init__(self, root, transform=None):
        self.transform = transform
        self.images = sorted(glob.glob(os.path.join(root, "*/*.png")))

    def __getitem__(self, index):
        img = _read_image(self.images[index])
        if self.transform is not None:
            img = self.transform(img)
        return img

    def __len__(self):
        return len(self.images)


class HeavyDatasetCustom:
    """CSV-manifest (Path, Class, ShapeZiro) volume reader with a
    single-volume cache. (datasets_prep/heavy_custom.py:29-49)

    The cache is one (path, volume) pair replaced as a whole, so the
    loader's threads never pair a path with another path's volume.
    """

    def __init__(self, manifest_csv, transform=None):
        self.transform = transform
        with open(manifest_csv) as f:
            self.rows = list(csv.DictReader(f))
        self._cache: tuple[str, np.ndarray] | None = None
        self.index = []
        for row in self.rows:
            for k in range(int(row["ShapeZiro"])):
                self.index.append((row["Path"], int(row["Class"]), k))

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i):
        path, label, k = self.index[i]
        cached = self._cache
        if cached is None or cached[0] != path:
            cached = (path, read_nifti(path))
            self._cache = cached
        img = np.asarray(cached[1][k]).astype(np.uint8)
        if self.transform is not None:
            img = self.transform(img)
        return img, label
