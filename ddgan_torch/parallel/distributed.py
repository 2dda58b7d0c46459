"""Process groups, rendezvous and the spawn of one process per GPU.

Counterpart of `ddgan_tpu/parallel/distributed.py`. The reference's L5 layer
(ddgan.py:589-644) spawns one process per GPU and meets through
torch.distributed's env:// rendezvous (MASTER_ADDR from --master_address,
MASTER_PORT hard-coded '6020', NCCL or gloo); the JAX package keeps that
surface over `jax.distributed`. The port is back on torch.distributed:

  * `initialize` is `init_process_group`, a no-op at world size <= 1 as
    the JAX one is. The backend is `what_backend` (nccl or gloo) on CUDA
    and gloo on the CPU (`resolve_backend`). Tests pass a `file://`
    `init_method` so that parallel runs never meet on port 6020.
  * `init_processes(rank, size, fn, args)`: init, `fn(rank, local_rank,
    args)`, a barrier, and teardown (ddgan.py:589-613), with a finite
    timeout, so that a rank that dies makes the others raise instead of
    waiting forever.
  * `launch(args, fn)`: the reference's `main` (ddgan.py:615-644):
    `num_process_per_node` processes on this node, process `i` with global
    rank `node_rank * num_process_per_node + i`, each on `cuda:{i}` (or on
    the device that `$DDGAN_TORCH_DEVICE` or launch's `device` names). The
    fork's quirk that forces both counts to 1 (SURVEY.md §2.4,
    ddgan.py:619-621) is not kept: the JAX package uses every local device,
    and so does the port. A caller that must not meet another run on port
    6020 passes an `init_method`, and a `deadline_s` bounds the whole run.
  * `rank()`, `world_size()`, `is_main()` and `default_group()` read the
    process's place in the run: rank 0 of 1, and no group, when no group
    was initialised. `broadcast_params_` is the reference's
    `broadcast_params` (ddgan.py:30-33).
"""

from __future__ import annotations

import copy
import datetime
import multiprocessing
import os
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from .._device import ENV_VAR, resolve_device
from .mesh import replicate_

DEFAULT_PORT = 6020  # the reference's hard-coded MASTER_PORT (ddgan.py:592)
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def default_group():
    """The default process group, or None when no group was initialised."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def rank() -> int:
    return 0 if default_group() is None else dist.get_rank()


def world_size() -> int:
    return 1 if default_group() is None else dist.get_world_size()


def is_main() -> bool:
    """Rank 0: the process that prints and writes (ddgan.py:536)."""
    return rank() == 0


def resolve_backend(what_backend: str, device: torch.device) -> str:
    """gloo on the CPU; on CUDA `what_backend` when it is nccl or gloo, else
    nccl (the JAX package's 'ici' names its own interconnect)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return what_backend if what_backend in ("nccl", "gloo") else "nccl"


def initialize(backend: str, rank: int, world_size: int, *, init_method: str | None = None,
               master_address: str = "127.0.0.1",
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """`init_process_group` with the reference's env:// rendezvous
    (MASTER_ADDR = master_address, MASTER_PORT = 6020) unless `init_method`
    is given; nothing at world size <= 1."""
    if world_size <= 1:
        return
    if init_method is None:
        os.environ["MASTER_ADDR"] = str(master_address)
        os.environ["MASTER_PORT"] = str(DEFAULT_PORT)
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)


def rank_device(local_rank: int) -> torch.device:
    """`cuda:{local_rank}`; the device `resolve_device` gives when it is the
    CPU or a CUDA device with an index (`DDGAN_TORCH_DEVICE=cuda:0` puts
    every rank on card 0)."""
    dev = resolve_device()
    return torch.device("cuda", local_rank) if dev.type == "cuda" and dev.index is None else dev


def init_processes(rank: int, size: int, fn: Callable[[int, int, Any], Any], args, *,
                   init_method: str | None = None, device: str | torch.device | None = None,
                   timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """Init, `fn(rank, args.local_rank, args)`, barrier, teardown
    (ddgan.py:589-613). `device` (default `rank_device(args.local_rank)`)
    picks the backend with `args.what_backend`. Returns what `fn` returns."""
    local_rank = int(getattr(args, "local_rank", 0))
    dev = torch.device(device) if device is not None else rank_device(local_rank)
    initialize(resolve_backend(str(getattr(args, "what_backend", "nccl")), dev), rank, size,
               init_method=init_method,
               master_address=str(getattr(args, "master_address", "127.0.0.1")),
               timeout=timeout)
    try:
        out = fn(rank, local_rank, args)
        if default_group() is not None:
            dist.barrier()
        return out
    finally:
        if default_group() is not None:
            dist.destroy_process_group()


def broadcast_params_(module: torch.nn.Module) -> None:
    """Every parameter and buffer of `module` from rank 0 (ddgan.py:30-33);
    nothing without a group."""
    if default_group() is not None:
        replicate_(module)


def _run_rank(rank: int, size: int, local_rank: int, fn, args, init_method, device,
              timeout) -> None:
    if device is not None:
        os.environ[ENV_VAR] = str(device)  # read by rank_device in this process
    args = copy.copy(args)
    args.local_rank = local_rank
    dev = rank_device(local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_processes(rank, size, fn, args, init_method=init_method, timeout=timeout)


def launch(args, fn: Callable[[int, int, Any], Any], *, init_method: str | None = None,
           device: str | None = None, deadline_s: float | None = None,
           timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Run `fn(rank, local_rank, args)` in `args.num_process_per_node` spawned
    processes of this node (ddgan.py:615-644). `init_method` replaces the
    env:// rendezvous (a `file://` path keeps parallel runs apart); `device`
    is `$DDGAN_TORCH_DEVICE` in every process (`cuda:0` puts them all on one
    card); `timeout` bounds each collective. A process that fails, or the
    run passing `deadline_s`, kills the others and raises RuntimeError."""
    per_node = int(args.num_process_per_node)
    size = per_node * int(args.num_proc_node)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_run_rank,
                         args=(int(args.node_rank) * per_node + i, size, i, fn, args,
                               init_method, device, timeout))
             for i in range(per_node)]
    for p in procs:
        p.start()
    deadline = None if deadline_s is None else time.monotonic() + deadline_s
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"training processes {failed} of this node exited with "
                                   f"{[codes[i] for i in failed]}")
            if all(c == 0 for c in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"training processes of this node ran past the "
                                   f"{deadline_s} s deadline")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
