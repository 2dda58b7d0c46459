"""CIFAR-10 reader over the standard python pickle batches.

The port's own copy of `ddgan_tpu/data/cifar10.py`. The reference README's
headline recipe trains on CIFAR-10 (readme.md:29-36) via torchvision; this
is a torchvision-free reader of the same on-disk format
(`cifar-10-batches-py/data_batch_*`). No downloading — files must be local.
`__getitem__` returns the uint8 HWC array where the JAX package returns
the PIL image made from it.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


class CIFAR10:
    def __init__(self, root, train=True, transform=None, target_transform=None,
                 download=False):
        del download
        base = os.path.join(root, "cifar-10-batches-py")
        if not os.path.isdir(base):
            base = root
        files = (
            [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        )
        datas, labels = [], []
        for name in files:
            path = os.path.join(base, name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"CIFAR-10 batch {path} not found (no download in this environment)"
                )
            with open(path, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            datas.append(np.asarray(d[b"data"], dtype=np.uint8))
            labels.extend(d.get(b"labels", d.get(b"fine_labels", [])))
        self.data = (
            np.concatenate(datas).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        )
        self.targets = list(labels)
        self.transform = transform
        self.target_transform = target_transform

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        img = self.data[index]
        target = self.targets[index]
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target
