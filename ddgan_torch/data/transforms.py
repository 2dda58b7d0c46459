"""Image transform pipeline on numpy arrays.

The port's own copy of `ddgan_tpu/data/transforms.py`, without PIL: the
reference's conditional assembly from yes/no string flags
(ddgan.py:203-219), Resize → ToTensor → Normalize(0.5, 0.5) → CenterCrop,
each included when its flag is 'yes'. The datasets hand over the uint8
arrays that the JAX package wraps in PIL images, and each transform gives
what the JAX one gives of that image (`Resize` through the port's copy of
PIL's bilinear, `data/resize.py`). Output is float32 HWC; the train loop
makes batches NCHW on the device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .resize import BILINEAR, resize


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Resize:
    """torchvision Resize(int) semantics: smaller edge → size, bilinear."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: np.ndarray) -> np.ndarray:
        h, w = np.asarray(img).shape[:2]
        if w <= h:
            new_w, new_h = self.size, max(1, round(h * self.size / w))
        else:
            new_w, new_h = max(1, round(w * self.size / h)), self.size
        return resize(img, (new_w, new_h), BILINEAR)


class ToTensor:
    """uint8 → float32 [0,1], HWC (channel dim added for grayscale)."""

    def __call__(self, img) -> np.ndarray:
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / 255.0
        return arr.astype(np.float32)


class Normalize:
    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean.reshape(1, 1, -1)) / self.std.reshape(1, 1, -1)


class CenterCrop:
    """Center crop of an HW or HWC array (the reference applies it after
    ToTensor, ddgan.py:213-214). An HW array becomes HWC, as the JAX
    package's PIL branch makes it. Pads with zeros if smaller than target."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        if x.ndim == 2:
            x = x[:, :, None]
        h, w = x.shape[:2]
        s = self.size
        if h < s or w < s:
            pad_h, pad_w = max(0, s - h), max(0, s - w)
            x = np.pad(
                x,
                ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
            )
            h, w = x.shape[:2]
        top, left = (h - s) // 2, (w - s) // 2
        return x[top : top + s, left : left + s]


def build_transform(args) -> Compose | None:
    """Assemble transforms from yes/no flags. (ddgan.py:203-219)"""
    transform_list = []
    if getattr(args, "do_resize", "no").lower() == "yes":
        transform_list.append(Resize(args.image_size))
    if getattr(args, "to_tensor_transform", "no").lower() == "yes":
        transform_list.append(ToTensor())
    if getattr(args, "use_normalize", "no").lower() == "yes":
        c = args.num_channels
        transform_list.append(Normalize((0.5,) * c, (0.5,) * c))
    if getattr(args, "CenterCrop", "no").lower() == "yes":
        transform_list.append(CenterCrop(args.image_size))
    return Compose(transform_list) if transform_list else None
