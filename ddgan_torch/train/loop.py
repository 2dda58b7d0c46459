"""The training loop on one GPU per process — counterpart of
`ddgan_tpu/train/loop.py` (reference: `ddgan.train`, ddgan.py:186-586).

Per epoch (reference parity):
  * loader.set_epoch (ddgan.py:430-431) and the epoch's learning rates:
    the per-epoch cosine (ddgan.py:524-526), or constant under no_lr_decay;
  * per batch: the batch moves to the device as NCHW float32 from pinned
    host memory (non-blocking), then one train step (D update, G update,
    EMA; `step.make_train_step`), or a D-only step under
    d_updates_per_g_update > 1. The losses stay on the device and are
    fetched once per epoch; the only per-iteration host sync is the print
    every 100 iterations;
  * at the epoch's end: losses.json (the pre-resume history kept) and
    final_loss.txt, netG_{epoch}.pth every save_ckpt_every epochs with the
    EMA as its weights, and content.pth every save_content_every epochs
    (checkpoint.py). content.pth is written last: it is the epoch's commit
    point, so a run killed at any moment resumes from an epoch whose losses
    and generator are on disk, and redoes the epoch after it.

kind_of_optim 'pso' trains without gradients (`pso_step.py`): a constant
learning rate (unused), no D-only steps, one swarm per network built as the
JAX package builds it (max_iter = num_epoch * len(loader)), and at each
epoch's end the epoch-end swarm update on the epoch's losses.

`limited_iter` truncates epochs (ddgan.py:414-424). `profile_dir` records a
`torch.profiler` trace of the first epoch into that directory, the
counterpart of the JAX package's `jax.profiler` trace. The seed draws the
initial weights from a CPU `torch.Generator`, then the seed of the
generator on the device that carries every step's draws and dropout masks,
as the JAX package splits its key, and for PSO the seed of the generator of
the swarms; a resume rebuilds them from the seed, as JAX's key restarts from
PRNGKey(seed). `--resume` takes `content.pth`, else a JAX package
`content.ckpt` (`compat/content.py`).

Data parallelism (`ddgan_torch.parallel`): when a process group is
initialised (`parallel.init_processes`, `parallel.launch`), each of its R
ranks loads its shard of the data (`build_loader`), `batch_size` is the
batch of each rank (the JAX package's batch per device), and rank r draws
from the seed + r (rank 0 of a run without a group keeps the seed of one
process). The weights are broadcast from rank 0 after they are built and
after a resume; the optimizers mean the gradients across the ranks
(`optimizer_sharding` 'replicated': `ClippedAdam`; 'zero1': `Zero1Adam`
with the Adam moments sharded), the PSO step its losses, and the loop the
epoch's losses, with one all-reduce an epoch (the numbers of the JAX step's
per-step `pmean`). The swarms draw from one generator seeded alike on every
rank. Only rank 0 prints and writes; every rank joins the ZeRO-1 gather of
`content.pth`, then a barrier, so that `content.pth` stays the epoch's
commit point. Without a group the loop runs as on one GPU, draw for draw.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..data import DataLoader, make_dataset
from ..diffusion import DiffusionCoefficients, PosteriorCoefficients
from ..models import NCSNpp, build_discriminator
from ..parallel import (
    broadcast_params_,
    default_group,
    is_main,
    mean_across_ranks_,
    rank_device,
    world_size,
)
from ..parallel import rank as process_rank
from . import checkpoint as ckpt
from .optim import ClippedAdam, cosine_lr
from .pso_optim import AdaptivePSO
from .pso_step import (
    PSOTrainState,
    create_pso_train_state,
    make_pso_epoch_end,
    make_pso_train_step,
    pad_epoch_losses,
)
from .state import TrainState, create_train_state
from .step import make_train_step
from .zero1 import Zero1Adam


def build_models(args, generator: torch.Generator | None = None):
    """(G, D) of a config, on the CPU, initial weights drawn from `generator`."""
    return NCSNpp.from_config(args, generator=generator), build_discriminator(args, generator)


def _limited_iter(args):
    """ddgan.py:414-424 semantics: int or list → iteration cutoff."""
    li = getattr(args, "limited_iter", "no")
    if isinstance(li, bool):
        return None
    if isinstance(li, int):
        return li
    if isinstance(li, list):
        return int(np.mean(li))
    return None


def build_loader(args, dataset, batch: int, num_shards: int = 1, shard_id: int = 0
                 ) -> DataLoader:
    """The shuffled, drop-last loader of one rank's `batch`, on shard
    `shard_id` of `num_shards` (the ranks) of each epoch's permutation, as
    the JAX package shards it over its processes. The reference retries
    without its distributed sampler when that fails (ddgan.py:262-269); the
    JAX package re-raises on more than one process, because the retry would
    feed every rank the whole dataset, and on one the retry is the same
    loader. The port raises."""
    loader = DataLoader(
        dataset,
        batch_size=batch,
        shuffle=True,
        drop_last=True,
        num_shards=num_shards,
        shard_id=shard_id,
        num_workers=getattr(args, "num_workers", 0),
        seed=int(args.seed),
    )
    len(loader)  # validate the indices now, like torch's constructor
    return loader


def resolve_optimizer_sharding(args) -> str:
    """'replicated' or 'zero1', from the config key `optimizer_sharding`.
    The JAX package's DDGAN_TPU_ZERO1 is a bisect knob of its traced step,
    read at trace time; the port reads none of those knobs
    (DDGAN_TPU_R1_SHARED, DDGAN_TPU_PALLAS_*), and not this one either."""
    mode = str(getattr(args, "optimizer_sharding", "replicated")).lower()
    if mode not in ("replicated", "zero1"):
        raise ValueError(f"optimizer_sharding must be 'replicated' or 'zero1', got {mode!r}")
    return mode


def build_optimizers(args, gen: torch.nn.Module, disc: torch.nn.Module, group=None):
    """(opt_G, opt_D): `ClippedAdam`, or `Zero1Adam` under optimizer_sharding
    'zero1' (2·⌈P/R⌉ optimizer floats per rank instead of 2·P), each with its
    network's clip, betas and weight decay from `args`, meaning the gradients
    across the ranks of `group`."""
    cls = Zero1Adam if resolve_optimizer_sharding(args) == "zero1" else ClippedAdam
    return (cls(gen.parameters(), args.beta1_g, args.beta2_g, args.weight_decay_G,
                args.grad_clip_norm, group=group),
            cls(disc.parameters(), args.beta1_d, args.beta2_d, args.weight_decay_D,
                args.grad_clip_norm, group=group))


def build_adam_state(args, gen: torch.nn.Module, disc: torch.nn.Module, group=None
                     ) -> TrainState:
    """The Adam train state of G and D (on their device) with the optimizers
    of `build_optimizers`. The EMA shadow is always allocated, so a
    checkpoint resumes across an ema_decay change (as the JAX package's
    fixed train-state structure)."""
    return create_train_state(gen, disc, *build_optimizers(args, gen, disc, group), use_ema=True)


def _rank_mean(values: list, group) -> list[float]:
    """Device scalars as floats, meaned across the ranks of `group` (one
    all-reduce) when there is one."""
    if not values:
        return []
    stacked = torch.stack(values)
    if group is not None:
        mean_across_ranks_([stacked], group)
    return stacked.tolist()


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """An NHWC float32 host batch as NCHW float32 on `device`: transposed into
    pinned memory, then copied without blocking the host."""
    src = torch.from_numpy(x).permute(0, 3, 1, 2)
    if device.type != "cuda":
        return src.contiguous()
    host = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(src)
    return host.to(device, non_blocking=True)


def _start_profile(profile_dir, device: torch.device):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(str(profile_dir)))
    prof.start()
    return prof


def train_rank(rank: int, local_rank: int, args) -> None:
    """`train` on this process's GPU: the `fn` of `parallel.launch`."""
    del rank
    train(args, device=rank_device(local_rank))


def train(args, dataset=None, device: str | torch.device | None = None
          ) -> TrainState | PSOTrainState:
    """Run training. `args` is a Config or any attribute bag with the
    reference's schema; `batch_size` is the batch of each rank. Runs on
    `device` (default: `_device.resolve_device`), over the ranks of the
    default process group when one is initialised. Returns the final
    state."""
    device = resolve_device(device)
    group, rank = default_group(), process_rank()
    is_pso = str(getattr(args, "kind_of_optim", "adam")).lower() == "pso"
    loss_group = None if is_pso else group  # the PSO step means its losses itself
    # EMA disabled for decay <= 0, like the reference (ema.py:33 apply_ema)
    use_ema = bool(args.use_ema) and float(args.ema_decay) > 0.0

    exp_path = Path("./saved_info/dd_gan") / str(args.dataset) / str(args.exp)
    exp_path.mkdir(parents=True, exist_ok=True)

    if dataset is None:
        dataset = make_dataset(args)
    loader = build_loader(args, dataset, int(args.batch_size), world_size(), rank)

    init_rng = torch.Generator().manual_seed(int(args.seed))
    gen, disc = build_models(args, init_rng)
    rng = torch.Generator(device=device).manual_seed(
        int(torch.randint(2**62, (1,), generator=init_rng)) + rank)
    gen, disc = gen.to(device), disc.to(device)
    broadcast_params_(gen)
    broadcast_params_(disc)
    coeff = DiffusionCoefficients.create(args.num_timesteps, args.beta_min, args.beta_max,
                                         args.use_geometric, device=device)
    pos_coeff = PosteriorCoefficients.create(args.num_timesteps, args.beta_min, args.beta_max,
                                             args.use_geometric, device=device)
    d_per_g = 1 if is_pso else int(getattr(args, "d_updates_per_g_update", 1))
    d_only_step = pso_epoch_end = None
    call_kw = {}  # the step's extra arguments
    if is_pso:
        # the swarms' generator: seeded alike on every rank (pso_step.py)
        swarm_rng = torch.Generator(device=device).manual_seed(
            int(torch.randint(2**62, (1,), generator=init_rng)))
        call_kw = {"swarm_rng": swarm_rng}
        pso = AdaptivePSO(swarm_size=20, max_iter=args.num_epoch * max(1, len(loader)))
        state = create_pso_train_state(gen, disc, pso, swarm_rng, use_ema=True)
        step_fn = make_pso_train_step(coeff, pos_coeff, pso, num_timesteps=args.num_timesteps,
                                      nz=args.nz, ema_decay=args.ema_decay, use_ema=use_ema,
                                      group=group)
        pso_epoch_end = make_pso_epoch_end(pso)
    else:
        state = build_adam_state(args, gen, disc, group)
        step_kw = dict(num_timesteps=args.num_timesteps, nz=args.nz, r1_gamma=args.r1_gamma,
                       lazy_reg=args.lazy_reg, ema_decay=args.ema_decay, use_ema=use_ema,
                       r1_shared=str(getattr(args, "r1_shared", "auto")).lower())
        step_fn = make_train_step(coeff, pos_coeff, **step_kw)
        if d_per_g > 1:
            d_only_step = make_train_step(coeff, pos_coeff, update_g=False, **step_kw)

    init_epoch = 0
    if getattr(args, "resume", False):
        if (exp_path / "content.pth").exists():
            ckpt.load_content(exp_path, state)
        elif (exp_path / "content.ckpt").exists():
            from ..compat.content import load_content_ckpt

            load_content_ckpt(exp_path, state)
        broadcast_params_(state.gen)
        broadcast_params_(state.disc)
        if state.epoch:
            init_epoch = state.epoch
            if is_main():
                print(f"=> Loaded checkpoint (epoch {init_epoch})")

    limited = _limited_iter(args)
    losses_file = exp_path / "losses.json"
    # On resume, keep the pre-resume loss history (entries up to the resume
    # epoch). The reference restarts losses=[] and overwrites the file
    # (ddgan.py:571-586); the JAX package keeps it, and so does the port.
    losses = []
    if init_epoch > 0 and losses_file.exists():
        try:
            with open(losses_file) as f:
                losses = [e for e in json.load(f) if e.get("epoch", 0) <= init_epoch]
        except (json.JSONDecodeError, OSError):
            losses = []

    profile_dir = getattr(args, "profile_dir", None)
    for epoch in range(init_epoch, args.num_epoch + 1):
        loader.set_epoch(epoch)
        if is_pso or args.no_lr_decay:
            lr_g, lr_d = float(args.lr_g), float(args.lr_d)
        else:
            lr_g = cosine_lr(args.lr_g, epoch, args.num_epoch)
            lr_d = cosine_lr(args.lr_d, epoch, args.num_epoch)
        prof = _start_profile(profile_dir, device) \
            if profile_dir and epoch == init_epoch and is_main() else None

        loss_values_D, loss_values_G = [], []
        epoch_t0 = time.perf_counter()
        for iteration, (x, _) in enumerate(loader):
            if limited is not None and iteration >= limited:
                break
            real = _to_device(x, device)
            d_only = d_per_g > 1 and (iteration % d_per_g) != d_per_g - 1
            metrics = (d_only_step if d_only else step_fn)(state, real, rng, lr_g, lr_d,
                                                           **call_kw)
            # device tensors: a float() here would wait for the step
            loss_values_D.append(metrics.errD)
            if not d_only:  # a D-only step has no G loss (errG is a 0 filler)
                loss_values_G.append(metrics.errG)
            if iteration % 100 == 0:
                shown = _rank_mean([metrics.errG, metrics.errD], loss_group)
                if is_main():
                    print(f"Epoch {epoch + 1}, Iteration {iteration}, "
                          f"G Loss: {shown[0]:.8f}, D Loss: {shown[1]:.8f}")

        state.epoch = epoch + 1
        n_d = len(loss_values_D)
        loss_values = _rank_mean(loss_values_D + loss_values_G, loss_group)
        loss_values_D, loss_values_G = loss_values[:n_d], loss_values[n_d:]
        dt = time.perf_counter() - epoch_t0  # the epoch's steps, synced by the fetch
        swarm_s = None
        if is_pso and loss_values_D:
            # the epoch-end swarm update on the epoch's losses (ddgan.py:528-533)
            swarm_t0 = time.perf_counter()
            pso_epoch_end(state, pad_epoch_losses(loss_values_D, pso.swarm_size),
                          pad_epoch_losses(loss_values_G, pso.swarm_size), swarm_rng)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            swarm_s = time.perf_counter() - swarm_t0
        if prof is not None:
            prof.stop()

        save_t0 = time.perf_counter()
        avg_d = float(np.mean(loss_values_D)) if loss_values_D else float("inf")
        avg_g = float(np.mean(loss_values_G)) if loss_values_G else float("inf")
        losses.append({"epoch": epoch + 1, "G_loss": avg_g, "D_loss": avg_d})
        if is_main():
            ckpt.write_json(losses_file, losses)
            # the final generator loss, for the PSO HPO scorer (the reference
            # reads this file but never writes it, pso.py:415-420)
            with open(exp_path / "final_loss.txt", "w") as f:
                f.write(f"{avg_g}\n")
            if epoch % args.save_ckpt_every == 0:
                ckpt.save_netg(exp_path, epoch, state.gen, state.ema_G if use_ema else None)
        # the reference parses save_content / save_content_every and saves
        # every epoch regardless (ddgan.py:545-561); the documented intent:
        if bool(getattr(args, "save_content", True)) and (
            epoch % max(1, int(getattr(args, "save_content_every", 1))) == 0
        ):
            opts = ckpt.optimizer_states(state)  # the ZeRO-1 gather: every rank joins
            if is_main():
                ckpt.save_content(exp_path, state, args, opts)
        if group is not None:
            dist.barrier(group)
        n_it = len(loss_values_D)
        if n_it and is_main():
            swarm = "" if swarm_s is None else f", epoch-end swarm {swarm_s:.3f}s"
            print(
                f"[epoch {epoch}] {n_it} iters in {dt:.3f}s ({n_it / dt:.2f} it/s), "
                f"saves {time.perf_counter() - save_t0:.3f}s{swarm}, G {avg_g:.4f} D {avg_d:.4f}"
            )

    return state
