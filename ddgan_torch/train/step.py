"""The DDGAN train step on one GPU: D update, G update, EMA.

Counterpart of `ddgan_tpu/train/step.py:100-340` (reference semantics:
ddgan.py:438-522, per batch):

  D: t ~ U[0, T); (x_t, x_{t+1}) = q_sample_pairs; fakes from G (no
     gradient) → sample_posterior; errD_fake = softplus(D(x_pos)).mean();
     errD_real = softplus(-D(x_t)).mean(); every `lazy_reg` steps the R1
     penalty r1_gamma/2 · E‖∂ΣD(x_t)/∂x_t‖², a grad-of-grad; clip, Adam.
  G: fresh t, pairs, z and posterior noise; errG =
     softplus(-D(x_pos_g)).mean() against the freshly updated D, with
     gradients taken for G's parameters only (D's weight gradients are
     never computed, as under `jax.value_and_grad(g_loss_fn)`); clip,
     Adam, then the EMA of G.

Lazy R1 follows the documented intent, as the JAX package does: every
`lazy_reg` steps, every step when `lazy_reg` is None (the reference's
precedence bug, ddgan.py:462). `r1_shared` "yes" takes the R1 gradient
from the same D(x_t) forward that gives errD_real, "no" recomputes that
forward, "auto" shares it at images of 256² and more.

Randomness comes from an explicit `torch.Generator` on the batch's device:
each step draws t, both q-noises, z and the posterior noise of the D
update, then those of the G update (`draw_step`), and G's dropout masks
come from the same generator. Tests inject the draws instead (`draws`),
as the JAX package's `*_with_noise` functions take them.

On several ranks the step stays rank-local: each rank's optimizers mean
the gradients across the ranks (`ClippedAdam` / `Zero1Adam` with a process
group, the JAX step's `pmean`, `ddgan_tpu/train/step.py:282-283`,
`:307-308`), so the minibatch-stddev groups of D stay within a rank as they
stay within a shard in JAX, and the metrics it returns are the rank's: the
loop means them across the ranks once an epoch, which gives the numbers of
the JAX step's per-step `pmean` (`:329-330`) without a sync each step. The
JAX package's `pair_d` is a TPU layout choice that leaves the numbers the
same; it is not part of this step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..diffusion.schedules import (
    DiffusionCoefficients,
    PosteriorCoefficients,
    q_sample_pairs_with_noise,
    sample_posterior_with_noise,
)
from .ema import ema_update
from .state import TrainState


class StepMetrics(NamedTuple):
    errD: torch.Tensor
    errD_real: torch.Tensor
    errD_fake: torch.Tensor
    errG: torch.Tensor
    grad_penalty: torch.Tensor


class StepDraws(NamedTuple):
    """The random numbers of one step: the D update's, then the G update's."""

    t: torch.Tensor
    noise_q: torch.Tensor
    noise_next: torch.Tensor
    z: torch.Tensor
    noise_post: torch.Tensor
    t_g: torch.Tensor
    noise_q_g: torch.Tensor
    noise_next_g: torch.Tensor
    z_g: torch.Tensor
    noise_post_g: torch.Tensor


def draw_step(real: torch.Tensor, num_timesteps: int, nz: int,
              rng: torch.Generator | None) -> StepDraws:
    """Draw a step's t, q-noises, z and posterior noise from `rng`, D's
    then G's, on the batch's device."""
    b, dev, dt = real.shape[0], real.device, real.dtype
    out = []
    for _ in range(2):
        out.append(torch.randint(0, num_timesteps, (b,), generator=rng, device=dev))
        out.append(torch.randn(real.shape, generator=rng, device=dev, dtype=dt))
        out.append(torch.randn(real.shape, generator=rng, device=dev, dtype=dt))
        out.append(torch.randn((b, nz), generator=rng, device=dev, dtype=dt))
        out.append(torch.randn(real.shape, generator=rng, device=dev, dtype=dt))
    return StepDraws(*out)


def make_train_step(
    coeff: DiffusionCoefficients,
    pos_coeff: PosteriorCoefficients,
    *,
    num_timesteps: int,
    nz: int,
    r1_gamma: float,
    lazy_reg: int | None,
    ema_decay: float,
    use_ema: bool,
    update_g: bool = True,
    r1_shared: str = "auto",
) -> Callable[..., StepMetrics]:
    """Build the train step.

    Returns step(state, real, rng, lr_g, lr_d, draws=None) -> StepMetrics,
    which updates `state` in place (parameters, optimizers, EMA, step).
    `real` is the batch (NCHW, float32, on the models' device). With
    update_g=False only D is updated (the d_updates_per_g_update > 1 mode).
    After a step each parameter's `.grad` holds its clipped gradient.
    """
    r1_shared = str(r1_shared).lower()
    if r1_shared not in ("auto", "yes", "no"):
        raise ValueError(f"r1_shared must be 'auto', 'yes' or 'no', got {r1_shared!r}")

    def apply_D(disc, x, t, x_t):
        # the head returns float32 already; keep losses in full precision
        return disc(x, t, x_t).reshape(-1).float()

    def step(state: TrainState, real: torch.Tensor, rng: torch.Generator | None,
             lr_g: float, lr_d: float, draws: StepDraws | None = None) -> StepMetrics:
        gen, disc = state.gen, state.disc
        gen.train()
        disc.train()
        gen.set_dropout_generator(rng)
        d = draws if draws is not None else draw_step(real, num_timesteps, nz, rng)
        b = real.shape[0]
        apply_r1 = lazy_reg is None or state.step % lazy_reg == 0
        use_shared = r1_shared == "yes" or (r1_shared == "auto" and real.shape[2] >= 256)

        # ---------------- D update ----------------
        x_t, x_tp1 = q_sample_pairs_with_noise(coeff, real, d.t, d.noise_q, d.noise_next)
        with torch.no_grad():
            x_0_pred = gen(x_tp1, d.t, d.z)
            x_pos = sample_posterior_with_noise(pos_coeff, x_0_pred, x_tp1, d.t, d.noise_post)

        state.opt_D.zero_grad()
        errD_fake = F.softplus(apply_D(disc, x_pos, d.t, x_tp1)).mean()
        if apply_r1 and use_shared:
            x_t = x_t.detach().requires_grad_(True)
        d_real = apply_D(disc, x_t, d.t, x_tp1)
        errD_real = F.softplus(-d_real).mean()
        penalty = torch.zeros((), device=real.device)
        if apply_r1:
            if use_shared:
                x_in, out = x_t, d_real
            else:
                x_in = x_t.detach().requires_grad_(True)
                out = apply_D(disc, x_in, d.t, x_tp1)
            (grad_real,) = torch.autograd.grad(out.sum(), x_in, create_graph=True)
            gp = grad_real.float().reshape(b, -1).square().sum(1).mean()
            penalty = r1_gamma / 2.0 * gp
        (errD_real + errD_fake + penalty).backward(inputs=list(disc.parameters()))
        state.opt_D.step(lr_d)

        # ---------------- G update (fresh draws, updated D) ----------------
        if update_g:
            _, x_tp1_g = q_sample_pairs_with_noise(coeff, real, d.t_g, d.noise_q_g,
                                                   d.noise_next_g)
            state.opt_G.zero_grad()
            x0 = gen(x_tp1_g, d.t_g, d.z_g)
            x_pos_g = sample_posterior_with_noise(pos_coeff, x0, x_tp1_g, d.t_g, d.noise_post_g)
            errG = F.softplus(-apply_D(disc, x_pos_g, d.t_g, x_tp1_g)).mean()
            errG.backward(inputs=list(gen.parameters()))
            state.opt_G.step(lr_g)
            if use_ema:
                ema_update(state.ema_G, gen, ema_decay)
        else:
            errG = torch.zeros((), device=real.device)

        state.step += 1
        return StepMetrics(
            errD=(errD_real + errD_fake).detach(),
            errD_real=errD_real.detach(),
            errD_fake=errD_fake.detach(),
            errG=errG.detach(),
            grad_penalty=penalty.detach(),
        )

    return step
