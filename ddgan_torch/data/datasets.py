"""LUNA16 and patch datasets (reference: datasets_prep/custom.py).

The port's own copy of `ddgan_tpu/data/datasets.py`, limited to the
datasets that decode with numpy: `Luna16Dataset` (NIfTI volumes through the
pure-numpy reader) and `PositivePatchDataset` (`.npy` patches), and the
slice-info cache. Items are the uint8 arrays that the JAX package wraps in
PIL images, so `ToTensor` gives what it gives there. The JAX package's
native C++ slice cache is not ported: every slice is read with numpy
(ROADMAP.md Queue 1 item 13). The datasets that open or resize images with
PIL raise.

All datasets implement the plain protocol `__len__` / `__getitem__ ->
(image, label)`.
"""

from __future__ import annotations

import glob
import os
from typing import Callable

import numpy as np

from .nifti import read_nifti
from .transforms import needs_image_decoder


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
            handled = self._bounds_from_mask(np.nonzero(read_nifti(mask_path)))
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
        """One 2-D slice; the whole volume is decoded per slice, as the
        reference does (custom.py:190)."""
        patch = read_nifti(path)
        if index < 0 or index >= patch.shape["xyz".index(axis)]:
            raise IndexError(f"Slice index {index} out of bounds")
        if axis == "x":
            return patch[index, :, :]
        if axis == "y":
            return patch[:, index, :]
        return patch[:, :, index]

    def __getitem__(self, index):
        if self._3d:
            path, axis, group = self._3d_slices_info[index]
            patch = read_nifti(path)
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


class _NeedsDecoder:
    """A JAX-package dataset that opens or resizes images with PIL."""

    def __init__(self, *args, **kwargs):
        raise needs_image_decoder(type(self).__name__)


class Luna16Dataset2(_NeedsDecoder):
    """The 2-D variant with a PIL crop and resize to 64² (custom.py:222-358)."""


class DatasetCustom(_NeedsDecoder):
    """data_dir/{train,val,test}/*/*.jpg through PIL (custom.py:426-459)."""


class DataReader(_NeedsDecoder):
    """root/*/*.png through PIL (datasets_prep/datareader.py)."""


class HeavyDatasetCustom(_NeedsDecoder):
    """CSV-manifest volume reader yielding PIL images (heavy_custom.py:29-49)."""
