"""CelebA-HQ LMDB and LSUN datasets, on the port's own LMDB reader.

The port's own copy of `ddgan_tpu/data/lmdb_datasets.py` (reference:
datasets_prep/lmdb_datasets.py, the CelebA-HQ 27000/3000 split, and
datasets_prep/lsun.py, torchvision's LSUN with a cached key list). It reads
the LMDB files with `data/lmdb.py` instead of the `lmdb` package, and
decodes encoded values with `utils.decode_images` instead of PIL: PNG,
JPEG, WebP (the LSUN release's values, as its `data.py export` writes
them), BMP, PBM/PGM/PPM and TIFF, converted to RGB as `.convert("RGB")`
does. What they do not read raises NotImplementedError naming ROADMAP.md
Queue 1 item 13i. Items
are the uint8 (H, W, 3) arrays that the JAX package wraps in PIL images,
through the same transform.
"""

from __future__ import annotations

import os
import pickle
import string
from collections.abc import Iterable

import numpy as np

from . import lmdb
from ..utils import decode_images


def num_samples(dataset: str, train: bool) -> int:
    """Hardcoded CelebA split sizes. (lmdb_datasets.py:16-21)"""
    if dataset == "celeba":
        return 27000 if train else 3000
    raise NotImplementedError(f"dataset {dataset} is unknown")


def _open(path: str) -> lmdb.Environment:
    return lmdb.open(path, readonly=True, max_readers=1, lock=False, readahead=False,
                     meminit=False)


class LMDBDataset:
    """CelebA-HQ LMDB reader, raw or encoded bytes. (lmdb_datasets.py:24-58)

    The value of `str(index)` is an encoded image, or with `is_encoded`
    False the raw bytes of a square RGB image, sqrt(len / 3) on a side.
    """

    def __init__(self, root, name="", train=True, transform=None, is_encoded=False):
        self.train = train
        self.name = name
        self.transform = transform
        lmdb_path = os.path.join(root, "train.lmdb" if train else "validation.lmdb")
        self.data_lmdb = _open(lmdb_path)
        self.is_encoded = is_encoded

    def __getitem__(self, index):
        target = [0]
        with self.data_lmdb.begin(write=False, buffers=True) as txn:
            data = txn.get(str(index).encode())
        if self.is_encoded:
            img = decode_images([data])[0]
        else:
            img = np.frombuffer(data, dtype=np.uint8)
            size = int(np.sqrt(len(img) / 3))
            img = np.reshape(img, (size, size, 3))
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return num_samples(self.name, self.train)


class LSUNClass:
    """One LSUN category LMDB with a cached key list. (lsun.py:24-60)

    The keys come from a cursor once and are pickled, as a list of bytes, to
    `_cache_<the root's letters and digits>` in the LMDB directory: the JAX
    package's file, so that a cache written by either package is read by
    the other.
    """

    def __init__(self, root, transform=None, target_transform=None):
        self.root = root
        self.transform = transform
        self.target_transform = target_transform
        self.env = _open(root)
        with self.env.begin(write=False) as txn:
            self.length = txn.stat()["entries"]
        cache_file = "_cache_" + "".join(
            c for c in root if c in string.ascii_letters + string.digits
        )
        cache_path = os.path.join(root, cache_file)
        if os.path.isfile(cache_path):
            with open(cache_path, "rb") as f:
                self.keys = pickle.load(f)
        else:
            with self.env.begin(write=False) as txn:
                self.keys = [key for key in txn.cursor().iternext(keys=True, values=False)]
            with open(cache_path, "wb") as f:
                pickle.dump(self.keys, f)

    def __getitem__(self, index):
        with self.env.begin(write=False) as txn:
            imgbuf = txn.get(self.keys[index])
        img = decode_images([imgbuf])[0]
        target = None
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target

    def __len__(self):
        return self.length


class LSUN:
    """Multi-category LSUN over per-class LMDBs. (lsun.py:63-170)

    classes: 'train' | 'val' | 'test' | list of '<category>_<split>'.
    """

    CATEGORIES = [
        "bedroom", "bridge", "church_outdoor", "classroom", "conference_room",
        "dining_room", "kitchen", "living_room", "restaurant", "tower",
    ]

    def __init__(self, root, classes="train", transform=None, target_transform=None):
        self.root = root
        self.transform = transform
        self.target_transform = target_transform
        self.classes = self._verify_classes(classes)
        self.dbs = [
            LSUNClass(root=os.path.join(root, f"{c}_lmdb"), transform=transform)
            for c in self.classes
        ]
        self.indices = []
        count = 0
        for db in self.dbs:
            count += len(db)
            self.indices.append(count)
        self.length = count

    def _verify_classes(self, classes):
        if isinstance(classes, str):
            if classes == "test":
                return [classes]
            if classes in ("train", "val"):
                return [f"{c}_{classes}" for c in self.CATEGORIES]
            return [classes]
        if isinstance(classes, Iterable):
            return list(classes)
        raise ValueError(f"invalid classes: {classes!r}")

    def __getitem__(self, index):
        target = 0
        sub = 0
        for ind in self.indices:
            if index < ind:
                break
            target += 1
            sub = ind
        db = self.dbs[target]
        index = index - sub
        img, _ = db[index]
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target

    def __len__(self):
        return self.length
