"""The training loop on one GPU — counterpart of `ddgan_tpu/train/loop.py`
(reference: `ddgan.train`, ddgan.py:186-586).

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
initial weights from a CPU `torch.Generator`, then the seed of the one
generator on the device that carries every step's draws and dropout masks,
as the JAX package splits its key (a PSO run's swarms are drawn from the
latter); a resume rebuilds both from the seed, as JAX's key restarts from
PRNGKey(seed). `--resume` takes `content.pth`, else a JAX package
`content.ckpt` (`compat/content.py`).

ZeRO-1 (ROADMAP.md Queue 1 item 7) is not ported: that setting raises
before any work.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..data import DataLoader, make_dataset
from ..diffusion import DiffusionCoefficients, PosteriorCoefficients
from ..models import NCSNpp, build_discriminator
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


def build_loader(args, dataset, batch: int) -> DataLoader:
    """The shuffled, drop-last loader of the one GPU's batch. The reference
    retries without its distributed sampler when that fails
    (ddgan.py:262-269); on one GPU there is no sampler to drop."""
    loader = DataLoader(
        dataset,
        batch_size=batch,
        shuffle=True,
        drop_last=True,
        num_workers=getattr(args, "num_workers", 0),
        seed=int(args.seed),
    )
    len(loader)  # validate the indices now, like torch's constructor
    return loader


def build_adam_state(args, gen: torch.nn.Module, disc: torch.nn.Module) -> TrainState:
    """The Adam train state of G and D (on their device) with each network's
    clip, betas and weight decay from `args`. The EMA shadow is always
    allocated, so a checkpoint resumes across an ema_decay change (as the
    JAX package's fixed train-state structure)."""
    return create_train_state(
        gen, disc,
        ClippedAdam(gen.parameters(), args.beta1_g, args.beta2_g, args.weight_decay_G,
                    args.grad_clip_norm),
        ClippedAdam(disc.parameters(), args.beta1_d, args.beta2_d, args.weight_decay_D,
                    args.grad_clip_norm),
        use_ema=True,
    )


def _refuse_unported(args) -> None:
    if str(getattr(args, "optimizer_sharding", "replicated")).lower() == "zero1":
        raise NotImplementedError(
            "optimizer_sharding 'zero1' is not ported to ddgan_torch yet (ROADMAP.md Queue 1 "
            "item 7); one GPU trains with 'replicated'.")


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


def train(args, dataset=None, device: str | torch.device | None = None
          ) -> TrainState | PSOTrainState:
    """Run training. `args` is a Config or any attribute bag with the
    reference's schema; `batch_size` is the batch of the one GPU. Runs on
    `device` (default: `_device.resolve_device`). Returns the final state."""
    _refuse_unported(args)
    device = resolve_device(device)
    is_pso = str(getattr(args, "kind_of_optim", "adam")).lower() == "pso"
    # EMA disabled for decay <= 0, like the reference (ema.py:33 apply_ema)
    use_ema = bool(args.use_ema) and float(args.ema_decay) > 0.0

    exp_path = Path("./saved_info/dd_gan") / str(args.dataset) / str(args.exp)
    exp_path.mkdir(parents=True, exist_ok=True)

    if dataset is None:
        dataset = make_dataset(args)
    loader = build_loader(args, dataset, int(args.batch_size))

    init_rng = torch.Generator().manual_seed(int(args.seed))
    gen, disc = build_models(args, init_rng)
    rng = torch.Generator(device=device).manual_seed(
        int(torch.randint(2**62, (1,), generator=init_rng)))
    gen, disc = gen.to(device), disc.to(device)
    coeff = DiffusionCoefficients.create(args.num_timesteps, args.beta_min, args.beta_max,
                                         args.use_geometric, device=device)
    pos_coeff = PosteriorCoefficients.create(args.num_timesteps, args.beta_min, args.beta_max,
                                             args.use_geometric, device=device)
    d_per_g = 1 if is_pso else int(getattr(args, "d_updates_per_g_update", 1))
    d_only_step = pso_epoch_end = None
    if is_pso:
        pso = AdaptivePSO(swarm_size=20, max_iter=args.num_epoch * max(1, len(loader)))
        state = create_pso_train_state(gen, disc, pso, rng, use_ema=True)
        step_fn = make_pso_train_step(coeff, pos_coeff, pso, num_timesteps=args.num_timesteps,
                                      nz=args.nz, ema_decay=args.ema_decay, use_ema=use_ema)
        pso_epoch_end = make_pso_epoch_end(pso)
    else:
        state = build_adam_state(args, gen, disc)
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
        if state.epoch:
            init_epoch = state.epoch
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
        prof = _start_profile(profile_dir, device) if profile_dir and epoch == init_epoch \
            else None

        loss_values_D, loss_values_G = [], []
        epoch_t0 = time.perf_counter()
        for iteration, (x, _) in enumerate(loader):
            if limited is not None and iteration >= limited:
                break
            real = _to_device(x, device)
            d_only = d_per_g > 1 and (iteration % d_per_g) != d_per_g - 1
            metrics = (d_only_step if d_only else step_fn)(state, real, rng, lr_g, lr_d)
            # device tensors: a float() here would wait for the step
            loss_values_D.append(metrics.errD)
            if not d_only:  # a D-only step has no G loss (errG is a 0 filler)
                loss_values_G.append(metrics.errG)
            if iteration % 100 == 0:
                print(
                    f"Epoch {epoch + 1}, Iteration {iteration}, "
                    f"G Loss: {float(metrics.errG):.8f}, "
                    f"D Loss: {float(metrics.errD):.8f}"
                )

        state.epoch = epoch + 1
        loss_values_D = torch.stack(loss_values_D).tolist() if loss_values_D else []
        loss_values_G = torch.stack(loss_values_G).tolist() if loss_values_G else []
        dt = time.perf_counter() - epoch_t0  # the epoch's steps, synced by the fetch
        swarm_s = None
        if is_pso and loss_values_D:
            # the epoch-end swarm update on the epoch's losses (ddgan.py:528-533)
            swarm_t0 = time.perf_counter()
            pso_epoch_end(state, pad_epoch_losses(loss_values_D, pso.swarm_size),
                          pad_epoch_losses(loss_values_G, pso.swarm_size), rng)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            swarm_s = time.perf_counter() - swarm_t0
        if prof is not None:
            prof.stop()

        save_t0 = time.perf_counter()
        avg_d = float(np.mean(loss_values_D)) if loss_values_D else float("inf")
        avg_g = float(np.mean(loss_values_G)) if loss_values_G else float("inf")
        losses.append({"epoch": epoch + 1, "G_loss": avg_g, "D_loss": avg_d})
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
            ckpt.save_content(exp_path, state, args)
        n_it = len(loss_values_D)
        if n_it:
            swarm = "" if swarm_s is None else f", epoch-end swarm {swarm_s:.3f}s"
            print(
                f"[epoch {epoch}] {n_it} iters in {dt:.3f}s ({n_it / dt:.2f} it/s), "
                f"saves {time.perf_counter() - save_t0:.3f}s{swarm}, G {avg_g:.4f} D {avg_d:.4f}"
            )

    return state
