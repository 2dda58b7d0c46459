"""NIfTI→PNG/NPY converters for building FID "real" image sets.

The port's copy of `ddgan_tpu/data/converters.py` (reference:
additionals/images.py, nii_to_png/_simple :87-145, nii_to_npy/_simple/_3d
:151-265, npy_to_image :27-63). Volumes are read with the port's numpy
NIfTI reader and PNGs written with `utils.encode_png` (8-bit grey or RGB),
so no imaging package is needed. A `do_resize_to` that would change an
image's size raises: PIL's resize is ROADMAP.md Queue 1 item 13's work.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

from ..utils import encode_png
from .nifti import read_nifti


def _slice_volume(patch: np.ndarray, where: str, index: int) -> np.ndarray:
    if index < 0 or index >= patch.shape["xyz".index(where)]:
        raise IndexError(f"Slice index {index} out of bounds for {patch.shape}")
    if where == "x":
        return patch[index, :, :]
    if where == "y":
        return patch[:, index, :]
    return patch[:, :, index]


def _check_size(pixels: np.ndarray, do_resize_to) -> None:
    """PIL's resize to the image's own (width, height) is a copy; any other
    size needs PIL's resampling, which the port does not have yet."""
    if do_resize_to is not None and tuple(do_resize_to) != (pixels.shape[1], pixels.shape[0]):
        raise NotImplementedError(
            f"resizing a {pixels.shape[1]}x{pixels.shape[0]} image to {tuple(do_resize_to)} "
            "needs PIL's bilinear resize, which ddgan_torch does not have yet (ROADMAP.md "
            "Queue 1 item 13); convert at the slices' own size (do_resize_to=None).")


def nii_to_png_simple(nii_file_path, where, slice_index, only_z=True,
                      save_dir="./real_images", do_resize_to=(128, 128)):
    """One slice → PNG named {case}_{axis}_{index}.png. (images.py:87-122)"""
    if only_z and where != "z":
        return
    patch = read_nifti(nii_file_path)
    pixels = _slice_volume(patch, where, slice_index).astype(np.uint8)
    _check_size(pixels, do_resize_to)
    name = os.path.split(nii_file_path)[-1].split(".nii.gz")[0]
    Path(save_dir, f"{name}_{where}_{slice_index}.png").write_bytes(encode_png(pixels))


def nii_to_png(slices_info, save_dir="./real_images", only_z=True, lim=None,
               do_resize_to=None, do_transform_for="none"):
    """Batch converter over a slice-info list, capped at `lim` files.
    (images.py:127-145)"""
    del do_transform_for  # reference's _data_transforms_luna16 is buggy/no-op
    os.makedirs(save_dir, exist_ok=True)
    if lim is not None:
        lim = lim if isinstance(lim, int) else 1000
    for nii_file_path, where, slc in slices_info:
        if lim is not None and len(os.listdir(save_dir)) > lim:
            return
        nii_to_png_simple(nii_file_path, where, slc, only_z, save_dir, do_resize_to)


def nii_to_npy_simple(nii_file_path, where, slice_index, only_z=True,
                      save_dir="./real_npys"):
    """One slice → .npy. (images.py:151-180)"""
    if only_z and where != "z":
        return
    patch = read_nifti(nii_file_path)
    arr = _slice_volume(patch, where, slice_index)
    name = os.path.split(nii_file_path)[-1].split(".nii.gz")[0]
    np.save(os.path.join(save_dir, f"{name}_{where}_{slice_index}.npy"), arr)


def nii_to_npy(slices_info, save_dir="./real_npys", only_z=True, lim=None):
    """Batch NIfTI→NPY. (images.py:186-205)"""
    os.makedirs(save_dir, exist_ok=True)
    if lim is not None:
        lim = lim if isinstance(lim, int) else 1000
    for nii_file_path, where, slc in slices_info:
        if lim is not None and len(os.listdir(save_dir)) > lim:
            return
        nii_to_npy_simple(nii_file_path, where, slc, only_z, save_dir)


def nii_to_npy_3d(data_dir, save_dir="./real_npys_3d", lim=None):
    """Whole volumes → .npy. (images.py:211-265)"""
    os.makedirs(save_dir, exist_ok=True)
    files = sorted(glob.glob(os.path.join(data_dir, "*.nii.gz")))
    for i, path in enumerate(files):
        if lim is not None and i >= lim:
            return
        vol = read_nifti(path)
        name = os.path.split(path)[-1].split(".nii.gz")[0]
        np.save(os.path.join(save_dir, f"{name}.npy"), vol)


def npy_to_image(npy_dir, save_dir="./converted_images", normalize=True, lim=None):
    """Batch .npy → PNG (sampler output postprocessing). (images.py:27-63)"""
    os.makedirs(save_dir, exist_ok=True)
    files = sorted(glob.glob(os.path.join(npy_dir, "*.npy")))
    for i, path in enumerate(files):
        if lim is not None and i >= lim:
            return
        arr = np.load(path)
        if arr.ndim == 3 and arr.shape[0] in (1, 3):  # CHW → HWC
            arr = arr.transpose(1, 2, 0)
        arr = np.asarray(arr, np.float32).squeeze()
        if normalize:
            lo, hi = arr.min(), arr.max()
            arr = (arr - lo) / max(hi - lo, 1e-8)
            arr = arr * 255.0
        arr = np.clip(arr, 0, 255).astype(np.uint8)
        Path(save_dir, Path(path).stem + ".png").write_bytes(encode_png(arr))
