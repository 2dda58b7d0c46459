"""Data parallelism over torch.distributed: the port's counterpart of
`ddgan_tpu/parallel/` (reference: ddgan.py:589-644, SURVEY.md §2.4).

One process per GPU. Parameters are replicated, each rank trains on its
shard of the data, and the optimizers mean the gradients across ranks
before they step (`train/optim.py`, or `train/zero1.py` with the Adam
moments sharded). Without a process group every function here is the
one-process path.
"""

from .distributed import (  # noqa: F401
    DEFAULT_PORT,
    broadcast_params_,
    default_group,
    init_processes,
    initialize,
    is_main,
    launch,
    rank,
    rank_device,
    world_size,
)
from .mesh import all_gather_, mean_across_ranks_, reduce_scatter_, replicate_  # noqa: F401
