"""StackedMNIST: 3 random MNIST digits stacked as RGB channels; target is
the 3-digit number. (reference: datasets_prep/stackmnist_data.py:21-49)

The port's own copy of `ddgan_tpu/data/stackmnist.py`, on arrays:
torchvision-free, it reads the standard MNIST IDX files
(train-images-idx3-ubyte[.gz] etc.) from `root/MNIST/raw` or `root`
directly. No downloading — files must exist locally. `__getitem__`
returns the uint8 (28, 28, 3) array where the JAX package returns the PIL
image made from it.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from .transforms import Compose, Normalize, ToTensor


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_idx(root: str, stem: str) -> str:
    candidates = [
        os.path.join(root, "MNIST", "raw", stem),
        os.path.join(root, "MNIST", "raw", stem + ".gz"),
        os.path.join(root, stem),
        os.path.join(root, stem + ".gz"),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(
        f"MNIST IDX file {stem} not found under {root} (no download in this environment)"
    )


class StackedMNIST:
    def __init__(self, root, train=True, transform=None, target_transform=None,
                 download=False, rng: np.random.Generator | None = None):
        del download  # files must be local
        img_stem = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
        lbl_stem = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
        self.data = _read_idx(_find_idx(root, img_stem))
        self.targets = _read_idx(_find_idx(root, lbl_stem))
        self.transform = transform
        self.target_transform = target_transform

        rng = rng or np.random.default_rng()
        n = len(self.data)
        index1 = np.hstack([rng.permutation(n), rng.permutation(n)])
        index2 = np.hstack([rng.permutation(n), rng.permutation(n)])
        index3 = np.hstack([rng.permutation(n), rng.permutation(n)])
        self.num_images = 2 * n
        self.index = list(zip(index1, index2, index3))

    def __len__(self):
        return self.num_images

    def __getitem__(self, index):
        img = np.zeros((28, 28, 3), dtype=np.uint8)
        target = 0
        for i in range(3):
            j = self.index[index][i]
            img[:, :, i] = self.data[j]
            target += int(self.targets[j]) * 10 ** (2 - i)
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target


class _Pad2:
    """Pad an HW or HWC uint8 image by 2 zeros on each side, 28x28 → 32x32
    (transforms.Pad(2))."""

    def __call__(self, img: np.ndarray) -> np.ndarray:
        arr = np.asarray(img)
        pad = ((2, 2), (2, 2)) + ((0, 0),) * (arr.ndim - 2)
        return np.pad(arr, pad)


def data_transforms_stacked_mnist():
    """Pad-to-32 + ToTensor + Normalize. (stackmnist_data.py:51-65)"""
    t = Compose([_Pad2(), ToTensor(), Normalize((0.5,) * 3, (0.5,) * 3)])
    return t, t
