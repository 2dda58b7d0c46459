"""The gradient-free train step of kind_of_optim 'pso' on one GPU.

Counterpart of `ddgan_tpu/train/pso_step.py` (reference protocol:
ddgan.py:438-533, the PSO branches). Per batch, errD and errG are computed
forward only and appended to a ring buffer of `trigger + 1` losses per
network; once more than `trigger` (20 in the reference) have accumulated,
`AdaptivePSO.step` runs for that network on the buffer, D's swarm first,
then G's, and its count restarts. The EMA of G steps every iteration,
after the swarm updates. At an epoch's end the swarm steps once more with
the epoch's first `swarm_size` losses, +inf-padded
(`make_pso_epoch_end`, `pad_epoch_losses`), and the buffers reset.

The losses are the Adam step's without gradients: D on x_t, on the
posterior fakes of G and (for errG) on the posterior fakes of a second G
forward with fresh draws; G runs in train mode both times, its dropout
masks drawn from the step's generator. The counts are host integers (they
move by one a step), so deciding whether the swarm fires never waits for
the device; the losses stay on the device. Tests inject the step's draws
(`StepDraws`) and the swarms' (`PSODraws`).

On several ranks (a process `group`), each rank computes the losses on its
shard of the data, and the four losses are meaned across the ranks before
they enter the ring buffers (`ddgan_tpu/train/pso_step.py:132-136`), so
every rank steps its replica of the swarms on the same fitness values. The
random streams are split as the JAX package splits its keys (`:100-108`):
the swarms draw from `swarm_rng`, seeded alike on every rank, and the data
and dropout draws from the rank's own `rng`; one generator carrying both
would make the replicated swarms diverge at their first update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion.schedules import (
    DiffusionCoefficients,
    PosteriorCoefficients,
    q_sample_pairs_with_noise,
    sample_posterior_with_noise,
)
from ..parallel.mesh import mean_across_ranks_
from .ema import ema_init, ema_update
from .pso_optim import AdaptivePSO, PSODraws, PSOState
from .step import StepDraws, StepMetrics, draw_step

BUF = 21  # the reference fires at len(local_loss) > 20 (ddgan.py:491, :513)


@dataclasses.dataclass
class PSOTrainState:
    gen: torch.nn.Module
    disc: torch.nn.Module
    pso_G: PSOState | None
    pso_D: PSOState | None
    ema_G: dict[str, torch.Tensor] | None
    loss_buf_G: torch.Tensor  # (trigger + 1,) float32, on the device
    loss_buf_D: torch.Tensor
    buf_count_G: int = 0
    buf_count_D: int = 0
    step: int = 0  # global step
    epoch: int = 0


def create_pso_train_state(gen: torch.nn.Module, disc: torch.nn.Module, pso: AdaptivePSO,
                           generator: torch.Generator | None = None, use_ema: bool = True,
                           buf_len: int = BUF) -> PSOTrainState:
    """The state of G and D (built, initialised, on their device) with a
    swarm each, initialised from `generator` (D's first, then G's), G's
    parameters as the EMA shadow and empty loss buffers."""
    dev = next(gen.parameters()).device
    pso_D = pso.init(list(disc.parameters()), generator)
    pso_G = pso.init(list(gen.parameters()), generator)
    return PSOTrainState(
        gen=gen, disc=disc, pso_G=pso_G, pso_D=pso_D,
        ema_G=ema_init(gen) if use_ema else None,
        loss_buf_G=torch.zeros(buf_len, device=dev),
        loss_buf_D=torch.zeros(buf_len, device=dev),
    )


def make_pso_train_step(
    coeff: DiffusionCoefficients,
    pos_coeff: PosteriorCoefficients,
    pso: AdaptivePSO,
    *,
    num_timesteps: int,
    nz: int,
    ema_decay: float,
    use_ema: bool,
    trigger: int = 20,
    group=None,
) -> Callable[..., StepMetrics]:
    """Build the PSO train step.

    Returns step(state, real, rng, lr_g, lr_d, draws=None, pso_draws=None,
    swarm_rng=None) -> StepMetrics, which updates `state` in place. The
    learning rates are taken and ignored (PSO has none). `pso_draws` is (D's,
    G's) `PSODraws` for a step that fires the swarms; without them the swarms
    draw from `swarm_rng` (default: `rng`). `trigger`: the swarm fires once
    MORE than this many losses have accumulated; the state's buffers must
    hold trigger + 1 (create_pso_train_state(buf_len=trigger + 1)). With a
    process `group` the losses are meaned across its ranks."""

    def apply_D(disc, x, t, x_t):
        return disc(x, t, x_t).reshape(-1).float()

    @torch.no_grad()
    def step(state: PSOTrainState, real: torch.Tensor, rng: torch.Generator | None,
             lr_g: float, lr_d: float, draws: StepDraws | None = None,
             pso_draws: tuple[PSODraws, PSODraws] | None = None,
             swarm_rng: torch.Generator | None = None) -> StepMetrics:
        del lr_g, lr_d
        gen, disc = state.gen, state.disc
        gen.train()
        disc.train()
        gen.set_dropout_generator(rng)
        d = draws if draws is not None else draw_step(real, num_timesteps, nz, rng)

        # D's loss, forward only (ddgan.py:450-477 without the backward)
        x_t, x_tp1 = q_sample_pairs_with_noise(coeff, real, d.t, d.noise_q, d.noise_next)
        errD_real = F.softplus(-apply_D(disc, x_t, d.t, x_tp1)).mean()
        x0 = gen(x_tp1, d.t, d.z)
        x_pos = sample_posterior_with_noise(pos_coeff, x0, x_tp1, d.t, d.noise_post)
        errD_fake = F.softplus(apply_D(disc, x_pos, d.t, x_tp1)).mean()
        errD = errD_real + errD_fake

        # G's loss with fresh draws (ddgan.py:495-503)
        _, x_tp1_g = q_sample_pairs_with_noise(coeff, real, d.t_g, d.noise_q_g, d.noise_next_g)
        x0g = gen(x_tp1_g, d.t_g, d.z_g)
        x_pos_g = sample_posterior_with_noise(pos_coeff, x0g, x_tp1_g, d.t_g, d.noise_post_g)
        errG = F.softplus(-apply_D(disc, x_pos_g, d.t_g, x_tp1_g)).mean()
        if group is not None:
            losses = torch.stack([errD, errG, errD_real, errD_fake])
            mean_across_ranks_([losses], group)
            errD, errG, errD_real, errD_fake = losses.unbind()

        # accumulate, and step each swarm once its buffer is past the trigger
        # (ddgan.py:491-493, :513-515)
        buf_len = state.loss_buf_D.shape[0]
        state.loss_buf_D[state.buf_count_D % buf_len] = errD
        state.loss_buf_G[state.buf_count_G % buf_len] = errG
        state.buf_count_D += 1
        state.buf_count_G += 1
        draws_D, draws_G = pso_draws if pso_draws is not None else (None, None)
        swarm = rng if swarm_rng is None else swarm_rng
        if state.buf_count_D > trigger:
            pso.step(state.pso_D, list(disc.parameters()), state.loss_buf_D, swarm, draws_D)
            state.buf_count_D = 0
        if state.buf_count_G > trigger:
            pso.step(state.pso_G, list(gen.parameters()), state.loss_buf_G, swarm, draws_G)
            state.buf_count_G = 0

        if use_ema:
            ema_update(state.ema_G, gen, ema_decay)
        state.step += 1
        return StepMetrics(errD=errD, errD_real=errD_real, errD_fake=errD_fake, errG=errG,
                           grad_penalty=torch.zeros((), device=real.device))

    return step


def make_pso_epoch_end(pso: AdaptivePSO) -> Callable[..., None]:
    """The epoch-end swarm update (ddgan.py:528-533), as the JAX package's.

    The reference steps each swarm once more after the iteration loop with
    the epoch's loss list, so the fitness of particle i is the epoch's i-th
    loss, and re-declares its in-epoch buffers every epoch (ddgan.py:436-437):
    the ring buffers reset here. Epochs shorter than the swarm are padded
    with +inf (`pad_epoch_losses`), which never improves a particle. The EMA
    is not touched (it steps per iteration only, ddgan.py:518-519)."""

    def epoch_end(state: PSOTrainState, loss_d: Sequence[float], loss_g: Sequence[float],
                  rng: torch.Generator | None,
                  pso_draws: tuple[PSODraws, PSODraws] | None = None) -> None:
        dev = state.loss_buf_D.device
        draws_D, draws_G = pso_draws if pso_draws is not None else (None, None)
        pso.step(state.pso_D, list(state.disc.parameters()),
                 torch.as_tensor(np.asarray(loss_d, np.float32), device=dev), rng, draws_D)
        pso.step(state.pso_G, list(state.gen.parameters()),
                 torch.as_tensor(np.asarray(loss_g, np.float32), device=dev), rng, draws_G)
        state.loss_buf_D.zero_()
        state.loss_buf_G.zero_()
        state.buf_count_D = state.buf_count_G = 0

    return epoch_end


def pad_epoch_losses(losses, swarm_size: int) -> np.ndarray:
    """An epoch's loss list as the (swarm_size,) fitness vector: its first
    swarm_size losses, +inf-padded (see make_pso_epoch_end)."""
    out = np.full((swarm_size,), np.inf, np.float32)
    k = min(len(losses), swarm_size)
    out[:k] = np.asarray(losses[:k], np.float32)
    return out
