"""Host-side data layer (numpy, the standard library and the port's own
C++ JPEG decoder).

The port's own copy of `ddgan_tpu/data/`: LUNA16 CT slices (pure-numpy
NIfTI reader behind an LRU of decoded volumes), positive-patch NPY volumes,
JPEG and PNG folders, StackMNIST (IDX files), CIFAR-10 (pickle batches)
and the synthetic set; the CelebA-HQ and LSUN LMDBs (on the port's own
LMDB reader, `data/lmdb.py`); PIL's bilinear and bicubic resize in numpy;
the yes/no-flag transform pipeline (ddgan.py:203-219) and the sharded,
prefetching loader that replaces DataLoader + DistributedSampler.
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
from .lmdb_datasets import LMDBDataset, LSUN  # noqa: F401
from .loader import DataLoader, SyntheticDataset  # noqa: F401
from .factory import make_dataset  # noqa: F401
