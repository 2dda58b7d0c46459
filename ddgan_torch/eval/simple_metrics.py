"""Folder-level FID and IS convenience wrappers.

The port's own copy of `ddgan_tpu/eval/simple_metrics.py` (reference:
additionals/simple_fid_and_incep.py). Both metrics run through the same
pluggable extractors as the main pipeline; with no feature_fn given they
use the port's FID InceptionV3 (weights required locally, or seeded random
ones via DDGAN_TPU_INCEPTION_RANDOM).

Folder protocol matches the reference: images under class subfolders
(ImageFolder layout) or flat; inputs are resized and normalized by the
feature function itself. Images are read with the port's decoders (PNG,
JPEG, WebP, BMP, PBM/PGM/PPM and TIFF, `utils.decode_images`).
"""

from __future__ import annotations

import pathlib
from typing import Callable

from .fid import (
    IMAGE_EXTENSIONS,
    _load_images_01,
    calculate_activation_statistics,
    calculate_frechet_distance,
)
from .inception_score import get_inception_score


def _list_images_recursive(path: str) -> list[pathlib.Path]:
    p = pathlib.Path(path)
    files: list[pathlib.Path] = []
    for ext in IMAGE_EXTENSIONS:
        files.extend(p.glob(f"*.{ext}"))
        files.extend(p.glob(f"*/*.{ext}"))  # ImageFolder class subdirs
    return sorted(files)


def calculate_fid(
    real_images_path: str,
    generated_images_path: str,
    batch_size: int = 32,
    feature_fn: Callable | None = None,
    dims: int = 2048,
) -> float:
    """FID between two image folders. (simple_fid_and_incep.py:48-78)"""
    if feature_fn is None:
        from .inception import default_feature_fn

        feature_fn = default_feature_fn(dims=dims)
    real = _list_images_recursive(real_images_path)
    fake = _list_images_recursive(generated_images_path)
    mu_r, s_r = calculate_activation_statistics(real, feature_fn, batch_size, dims)
    mu_g, s_g = calculate_activation_statistics(fake, feature_fn, batch_size, dims)
    return calculate_frechet_distance(mu_r, s_r, mu_g, s_g)


def calculate_inception_score(
    images_path: str,
    logits_fn: Callable,
    batch_size: int = 32,
    splits: int = 10,
) -> tuple[float, float]:
    """IS over an image folder. (simple_fid_and_incep.py:25-45)"""
    files = _list_images_recursive(images_path)
    images = _load_images_01(files)
    return get_inception_score(images, logits_fn, batch_size=batch_size, splits=splits)
