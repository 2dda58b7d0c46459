"""Dataset selection from config, mirroring ddgan.py:222-240 plus the
README recipes' datasets (cifar10 / stackmnist) — the port's own copy of
`ddgan_tpu/data/factory.py`. The datasets of image files (custom, lsun,
celeba_256) need an image decoder and raise (ROADMAP.md Queue 1 item 13)."""

from __future__ import annotations

from .cifar10 import CIFAR10
from .datasets import Luna16Dataset, PositivePatchDataset
from .loader import SyntheticDataset
from .stackmnist import StackedMNIST, data_transforms_stacked_mnist
from .transforms import build_transform, needs_image_decoder

_IMAGE_FILE_DATASETS = {
    "custom": "dataset 'custom' (JPEG folders)",
    "lsun": "dataset 'lsun' (LMDB of encoded images)",
    "celeba_256": "dataset 'celeba_256' (LMDB of encoded images)",
    "celeba": "dataset 'celeba' (LMDB of encoded images)",
}


def make_dataset(args):
    """Build the dataset named by args.dataset with the flag-driven
    transform pipeline. (ddgan.py:203-240)"""
    name = args.dataset
    if name in _IMAGE_FILE_DATASETS:
        raise needs_image_decoder(_IMAGE_FILE_DATASETS[name])
    transform = build_transform(args)

    if name == "posluna":
        return PositivePatchDataset(
            data_dir=args.data_dir,
            transform=transform,
            limited_slices=args.limited_slices,
        )
    if name == "luna16":
        bound_exp_lim = getattr(
            args, "bound_expand_limit", 1 if args.limited_slices else 5
        )
        return Luna16Dataset(
            data_dir=args.data_dir,
            mask_dir=args.mask_dir,
            transform=transform,
            bound_exp_lim=bound_exp_lim,
            path_to_slices_info=getattr(args, "path_to_slices_info", None),
            _3d=getattr(args, "use_3d_mode", False),
            bounders=args.num_channels,
            single_axis=args.limited_slices,
            _where=args.axis_for_limit,
        )
    if name == "cifar10":
        return CIFAR10(args.data_dir, train=True, transform=transform)
    if name == "stackmnist":
        train_t, _ = data_transforms_stacked_mnist()
        return StackedMNIST(
            root=args.data_dir, train=True, transform=transform or train_t
        )
    if name == "synthetic":
        return SyntheticDataset(
            n=getattr(args, "synthetic_size", 256),
            image_size=args.image_size,
            num_channels=args.num_channels,
            seed=args.seed,
        )
    raise ValueError(f"unknown dataset: {name}")
