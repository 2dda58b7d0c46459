"""Collectives over the ranks: the port's counterpart of
`ddgan_tpu/parallel/mesh.py`.

The JAX package lays the devices out on a 1-D 'data' mesh: `make_mesh`
builds it, `shard_batch` hands each device its slice of the global batch
and `replicate` copies the state to every device; the train step then
`pmean`s gradients and metrics over the axis. In a process-per-GPU world
the process group is the mesh, and the loader already hands each rank its
shard of the data (`train/loop.py:build_loader`), so `make_mesh` and
`shard_batch` have nothing left to do and are not ported. What remains:

  * `mean_across_ranks_(tensors)`: `pmean`. One flat float32 buffer, one
    all-reduce (SUM), divided by the world size, copied back. The
    optimizers mean their gradients with it, the loop the epoch's losses,
    the PSO step its losses.
  * `replicate_(module_or_tensors)`: a broadcast from rank 0.
  * `reduce_scatter_` and `all_gather_`: the flat collectives of ZeRO-1
    (`train/zero1.py`) and of the sharded sampler. They call
    `reduce_scatter_tensor` and `all_gather_into_tensor`, which every
    supported torch has; newer ones warn that these names are deprecated,
    and that warning is silenced here.
"""

from __future__ import annotations

import warnings
from typing import Iterable

import torch
import torch.distributed as dist


def mean_across_ranks_(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks of `group` (default:
    the default group), through one float32 all-reduce."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def replicate_(module_or_tensors: torch.nn.Module | Iterable[torch.Tensor], group=None) -> None:
    """Broadcast from rank 0 into every rank's tensors (a module: its
    parameters and buffers)."""
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = list(module_or_tensors.state_dict(keep_vars=True).values())
    else:
        tensors = list(module_or_tensors)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, 0, group=group)


def reduce_scatter_(out: torch.Tensor, flat: torch.Tensor, group=None) -> None:
    """`out` (n,) on rank r = the SUM over ranks of `flat[r*n:(r+1)*n]`."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*is deprecated.*", category=FutureWarning)
        dist.reduce_scatter_tensor(out, flat, group=group)


def all_gather_(out: torch.Tensor, local: torch.Tensor, group=None) -> None:
    """`out` (R*n, ...) = every rank's `local` (n, ...) in rank order."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*is deprecated.*", category=FutureWarning)
        dist.all_gather_into_tensor(out, local, group=group)
