"""DDGAN diffusion math: VP / geometric schedules, the forward-process
coefficients and training pairs, the posterior coefficients and the T-step
reverse sampler.

Counterpart of `ddgan_tpu/diffusion/schedules.py` (reference semantics:
ddgan.py:36-183). Schedules are computed on the host in float64 and kept
as float32 tensors on the run's device. Images are NCHW; `extract`
broadcasts per-sample scalars over the trailing dims, so it is
layout-agnostic. Randomness comes from an explicit `torch.Generator`, or
is injected (the `_with_noise` variants), so tests can feed the JAX
package and the port the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..parallel.mesh import all_gather_
from ..trace import span


def var_func_vp(t: np.ndarray, beta_min: float, beta_max: float) -> np.ndarray:
    """VP-SDE marginal variance 1 - exp(2 * log_mean_coeff). (ddgan.py:38-42)"""
    log_mean_coeff = -0.25 * t**2 * (beta_max - beta_min) - 0.5 * t * beta_min
    return 1.0 - np.exp(2.0 * log_mean_coeff)


def var_func_geometric(t: np.ndarray, beta_min: float, beta_max: float) -> np.ndarray:
    """Geometric-progression variance beta_min * (beta_max/beta_min)**t. (ddgan.py:45-47)"""
    return beta_min * ((beta_max / beta_min) ** t)


def get_time_schedule(num_timesteps: int, device=None) -> torch.Tensor:
    """t-grid arange(0, T+1)/T * (1 - 1e-3) + 1e-3, float32. (ddgan.py:58-65)"""
    eps_small = 1e-3
    t = np.arange(0, num_timesteps + 1, dtype=np.float64) / num_timesteps
    t = t * (1.0 - eps_small) + eps_small
    return torch.tensor(t, dtype=torch.float32, device=resolve_device(device))


def _sigma_schedule_np(num_timesteps, beta_min, beta_max, use_geometric):
    eps_small = 1e-3
    t = np.arange(0, num_timesteps + 1, dtype=np.float64) / num_timesteps
    t = t * (1.0 - eps_small) + eps_small
    if use_geometric:
        var = var_func_geometric(t, beta_min, beta_max)
        # var(t) must stay below 1 and non-decreasing, else alpha_bar goes
        # non-positive and every coefficient downstream is NaN; the JAX
        # package fails loudly here too (ddgan_tpu/diffusion/schedules.py:62).
        if not (0.0 < beta_min <= beta_max < 1.0):
            raise ValueError(
                "use_geometric=True requires 0 < beta_min <= beta_max < 1 "
                f"(got beta_min={beta_min}, beta_max={beta_max}): var(t)="
                "beta_min*(beta_max/beta_min)**t must stay below 1 AND be "
                "non-decreasing, else alpha_bar ratios exceed 1, betas go "
                "negative, and sigmas = sqrt(betas) are NaN (ddgan.py:45-47)."
            )
    else:
        var = var_func_vp(t, beta_min, beta_max)
    alpha_bars = 1.0 - var
    betas = 1.0 - alpha_bars[1:] / alpha_bars[:-1]
    betas = np.concatenate([np.array([1e-8]), betas]).astype(np.float32)
    sigmas = betas**0.5
    a_s = np.sqrt(1.0 - betas)
    return sigmas.astype(np.float32), a_s.astype(np.float32), betas


def get_sigma_schedule(
    num_timesteps: int,
    beta_min: float,
    beta_max: float,
    use_geometric: bool = False,
    device=None,
):
    """(sigmas, a_s, betas), each of length T+1 with betas[0] = 1e-8 prepended.

    Reference semantics: ddgan.py:68-91. Computed in float64, returned float32.
    """
    dev = resolve_device(device)
    return tuple(
        torch.from_numpy(a).to(dev)
        for a in _sigma_schedule_np(num_timesteps, beta_min, beta_max, use_geometric)
    )


def extract(coeffs: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-sample coefficients and broadcast over `ndim - 1` trailing dims."""
    out = coeffs[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class DiffusionCoefficients:
    """Forward-process coefficients (ddgan.py:94-106).

    a_s_cum[i]    = prod_{j<=i} a_s[j]
    sigmas_cum[i] = sqrt(1 - a_s_cum[i]^2)
    a_s_prev      = a_s with the last entry replaced by 1.
    """

    sigmas: torch.Tensor
    a_s: torch.Tensor
    a_s_cum: torch.Tensor
    sigmas_cum: torch.Tensor
    a_s_prev: torch.Tensor

    @staticmethod
    def create(
        num_timesteps: int,
        beta_min: float,
        beta_max: float,
        use_geometric: bool = False,
        device=None,
    ) -> "DiffusionCoefficients":
        dev = resolve_device(device)
        sigmas, a_s, _ = _sigma_schedule_np(num_timesteps, beta_min, beta_max, use_geometric)
        a_s_cum = np.cumprod(a_s)
        sigmas_cum = np.sqrt(1.0 - a_s_cum**2)
        a_s_prev = a_s.copy()
        a_s_prev[-1] = 1.0
        table = dict(sigmas=sigmas, a_s=a_s, a_s_cum=a_s_cum, sigmas_cum=sigmas_cum,
                     a_s_prev=a_s_prev)
        return DiffusionCoefficients(
            **{k: torch.tensor(np.asarray(v, np.float32), device=dev) for k, v in table.items()}
        )


def q_sample(
    coeff: DiffusionCoefficients,
    x_start: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """Diffuse x_start to time t: a_s_cum[t] * x0 + sigmas_cum[t] * noise. (ddgan.py:109-117)"""
    nd = x_start.ndim
    return extract(coeff.a_s_cum, t, nd) * x_start + extract(coeff.sigmas_cum, t, nd) * noise


def q_sample_pairs(
    coeff: DiffusionCoefficients,
    x_start: torch.Tensor,
    t: torch.Tensor,
    generator: torch.Generator | None,
):
    """Training pair (x_t, x_{t+1}); two independent noises, drawn from
    `generator` in that order. (ddgan.py:120-126)"""
    noise_q = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                          dtype=x_start.dtype)
    noise_next = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                             dtype=x_start.dtype)
    return q_sample_pairs_with_noise(coeff, x_start, t, noise_q, noise_next)


def q_sample_pairs_with_noise(
    coeff: DiffusionCoefficients,
    x_start: torch.Tensor,
    t: torch.Tensor,
    noise_q: torch.Tensor,
    noise_next: torch.Tensor,
):
    """Pair sampling with externally supplied noise (for parity tests)."""
    nd = x_start.ndim
    x_t = q_sample(coeff, x_start, t, noise_q)
    x_t_plus_one = extract(coeff.a_s, t + 1, nd) * x_t + extract(coeff.sigmas, t + 1, nd) * noise_next
    return x_t, x_t_plus_one


@dataclasses.dataclass(frozen=True)
class PosteriorCoefficients:
    """Reverse-process posterior coefficients (ddgan.py:131-148).

    Built from betas[1:] (the 1e-8 sentinel dropped), all float32.
    """

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    posterior_variance: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor

    @staticmethod
    def create(
        num_timesteps: int,
        beta_min: float,
        beta_max: float,
        use_geometric: bool = False,
        device=None,
    ) -> "PosteriorCoefficients":
        dev = resolve_device(device)
        _, _, betas_full = _sigma_schedule_np(
            num_timesteps, beta_min, beta_max, use_geometric
        )
        betas = np.asarray(betas_full, dtype=np.float32)[1:]
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.concatenate(
            [np.array([1.0], dtype=np.float32), alphas_cumprod[:-1]]
        )
        posterior_variance = (
            betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        )
        table = dict(
            betas=betas,
            alphas=alphas,
            alphas_cumprod=alphas_cumprod,
            alphas_cumprod_prev=alphas_cumprod_prev,
            posterior_variance=posterior_variance,
            sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
            sqrt_recip_alphas_cumprod=1.0 / np.sqrt(alphas_cumprod),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1.0),
            posterior_mean_coef1=(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            ),
            posterior_mean_coef2=(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
            ),
            posterior_log_variance_clipped=np.log(
                np.maximum(posterior_variance, 1e-20)
            ),
        )
        return PosteriorCoefficients(
            **{
                k: torch.tensor(np.asarray(v, np.float32), device=dev)
                for k, v in table.items()
            }
        )


def sample_posterior(
    coefficients: PosteriorCoefficients,
    x_0: torch.Tensor,
    x_t: torch.Tensor,
    t: torch.Tensor,
    generator: torch.Generator | None,
) -> torch.Tensor:
    """Ancestral posterior sample; noise gated off at t == 0. (ddgan.py:151-169)"""
    noise = torch.randn(
        x_t.shape, generator=generator, device=x_t.device, dtype=x_t.dtype
    )
    return sample_posterior_with_noise(coefficients, x_0, x_t, t, noise)


def sample_posterior_with_noise(
    coefficients: PosteriorCoefficients,
    x_0: torch.Tensor,
    x_t: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """Posterior sampling with externally supplied noise (for parity tests)."""
    nd = x_t.ndim
    mean = (
        extract(coefficients.posterior_mean_coef1, t, nd) * x_0
        + extract(coefficients.posterior_mean_coef2, t, nd) * x_t
    )
    log_var = extract(coefficients.posterior_log_variance_clipped, t, nd)
    nonzero_mask = (1.0 - (t == 0).to(x_t.dtype)).reshape((-1,) + (1,) * (nd - 1))
    return mean + nonzero_mask * torch.exp(0.5 * log_var) * noise


# the denoiser (x_t, t, z) -> x0_hat, e.g. an NCSNpp
GeneratorFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@torch.no_grad()
def sample_from_model(
    coefficients: PosteriorCoefficients,
    generator: GeneratorFn,
    n_time: int,
    x_init: torch.Tensor,
    nz: int,
    rng: torch.Generator | None = None,
) -> torch.Tensor:
    """T-step reverse sampler, fresh z each step. (ddgan.py:172-183)

    `generator` maps (x, t, z) to x0_hat. Iterates i = T-1 .. 0; each step
    draws z, then the posterior noise, from `rng` (on x_init's device).
    """
    batch = x_init.shape[0]
    x = x_init
    for i in range(n_time - 1, -1, -1):
        t = torch.full((batch,), i, dtype=torch.int64, device=x.device)
        z = torch.randn((batch, nz), generator=rng, device=x.device, dtype=x.dtype)
        with span("ddgan.sample.G", x.device):
            x_0 = generator(x, t, z)
        with span("ddgan.sample.posterior", x.device):
            x = sample_posterior(coefficients, x_0, x, t, rng)
    return x


@torch.no_grad()
def sample_from_model_with_noise(
    coefficients: PosteriorCoefficients,
    generator: GeneratorFn,
    n_time: int,
    x_init: torch.Tensor,
    zs: Sequence[torch.Tensor],
    noises: Sequence[torch.Tensor],
) -> torch.Tensor:
    """`sample_from_model` with the T latents and T posterior noises given,
    in step order (zs[0] and noises[0] are used at t = T-1)."""
    if len(zs) != n_time or len(noises) != n_time:
        raise ValueError(f"need {n_time} z's and noises, got {len(zs)}, {len(noises)}")
    batch = x_init.shape[0]
    x = x_init
    for step, i in enumerate(range(n_time - 1, -1, -1)):
        t = torch.full((batch,), i, dtype=torch.int64, device=x.device)
        x_0 = generator(x, t, zs[step])
        x = sample_posterior_with_noise(coefficients, x_0, x, t, noises[step])
    return x


def make_sharded_sampler(
    coefficients: PosteriorCoefficients,
    generator: GeneratorFn,
    n_time: int,
    image_shape: tuple[int, int, int],
    nz: int,
    per_device_batch: int,
    group=None,
) -> Callable[[int], torch.Tensor]:
    """Batch generation over the ranks of `group`: the counterpart of the JAX
    package's mesh-sharded sampler (`ddgan_tpu/diffusion/schedules.py:325-363`).

    Returns `sample(seed) -> (R * per_device_batch, C, H, W)`, on every rank
    (`image_shape` is (C, H, W): the port is NCHW). Rank r draws x_init and
    then the sampler's draws from one generator on the coefficients' device
    seeded with seed + r, runs `sample_from_model` on its `per_device_batch`,
    and one `all_gather_into_tensor` returns the global batch in rank order,
    so slice r equals a one-process `sample_from_model` with that generator
    (and without a group, or on one rank, what the sampler CLI draws from
    the seed). The JAX package folds the axis index into the call's key
    instead.
    """
    rank = 0 if group is None else dist.get_rank(group)
    world = 1 if group is None else dist.get_world_size(group)
    device = coefficients.posterior_mean_coef1.device

    def sample(seed: int) -> torch.Tensor:
        rng = torch.Generator(device=device).manual_seed(int(seed) + rank)
        x_init = torch.randn((per_device_batch, *image_shape), generator=rng, device=device)
        local = sample_from_model(coefficients, generator, n_time, x_init, nz, rng).contiguous()
        if group is None:
            return local
        out = local.new_empty((world * per_device_batch, *local.shape[1:]))
        all_gather_(out, local, group)
        return out

    return sample
