"""Host-side data layer (numpy and the standard library only).

The port's own copy of `ddgan_tpu/data/`, limited to the datasets that need
no image decoder: LUNA16 CT slices (pure-numpy NIfTI reader), positive-patch
NPY volumes, StackMNIST (IDX files), CIFAR-10 (pickle batches) and the
synthetic set; plus the yes/no-flag transform pipeline (ddgan.py:203-219)
and the sharded, prefetching loader that replaces DataLoader +
DistributedSampler. The datasets of image files raise, naming ROADMAP.md
Queue 1 item 13.
"""

from .nifti import read_nifti, write_nifti  # noqa: F401
from .transforms import Compose, build_transform  # noqa: F401
from .datasets import (  # noqa: F401
    DataReader,
    DatasetCustom,
    HeavyDatasetCustom,
    Luna16Dataset,
    Luna16Dataset2,
    PositivePatchDataset,
    load_slice_info,
    save_slice_info,
)
from .stackmnist import StackedMNIST, data_transforms_stacked_mnist  # noqa: F401
from .cifar10 import CIFAR10  # noqa: F401
from .loader import DataLoader, SyntheticDataset  # noqa: F401
from .factory import make_dataset  # noqa: F401
