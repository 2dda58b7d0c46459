"""DDGAN's diffusion in plain PyTorch: the VP schedule of T steps, the
training pairs (x_t, x_{t+1}), the posterior q(x_t | x_{t+1}, x_0) and the
T-step sampler (ddgan.py of NVlabs/denoising-diffusion-gan, :36-183).
Schedules are worked out in float64 and kept in float32.
"""

from __future__ import annotations

import numpy as np
import torch

EPS_SMALL = 1e-3


class Schedule:
    def __init__(self, T: int, beta_min: float, beta_max: float, device):
        t = np.arange(T + 1, dtype=np.float64) / T * (1.0 - EPS_SMALL) + EPS_SMALL
        log_mean = -0.25 * t**2 * (beta_max - beta_min) - 0.5 * t * beta_min
        alpha_bars = np.exp(2.0 * log_mean)
        betas = np.concatenate([[1e-8], 1.0 - alpha_bars[1:] / alpha_bars[:-1]]).astype(np.float32)
        a_s = np.sqrt(1.0 - betas)
        a_s_cum = np.cumprod(a_s)
        # posterior, from betas[1:] (ddgan.py:131-148)
        b = betas[1:]
        ac = np.cumprod(1.0 - b)
        ac_prev = np.concatenate([[1.0], ac[:-1]]).astype(np.float32)
        post_var = b * (1.0 - ac_prev) / (1.0 - ac)
        table = {
            "sigmas": np.sqrt(betas), "a_s": a_s, "a_s_cum": a_s_cum,
            "sigmas_cum": np.sqrt(1.0 - a_s_cum**2),
            "coef1": b * np.sqrt(ac_prev) / (1.0 - ac),
            "coef2": (1.0 - ac_prev) * np.sqrt(1.0 - b) / (1.0 - ac),
            "log_var": np.log(np.maximum(post_var, 1e-20)),
        }
        self.T = T
        for k, v in table.items():
            setattr(self, k, torch.tensor(np.asarray(v, np.float32), device=device))


def _at(c: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return c[t][:, None, None, None]


def q_pairs(s: Schedule, x0, t, noise_q, noise_next):
    """(x_t, x_{t+1}) from x_0 with two independent noises."""
    x_t = _at(s.a_s_cum, t) * x0 + _at(s.sigmas_cum, t) * noise_q
    return x_t, _at(s.a_s, t + 1) * x_t + _at(s.sigmas, t + 1) * noise_next


def posterior(s: Schedule, x0, x_t, t, noise):
    """A draw of x_{t-1} ~ q(. | x_t, x_0); no noise where t == 0."""
    mean = _at(s.coef1, t) * x0 + _at(s.coef2, t) * x_t
    keep = (t != 0).to(x_t.dtype)[:, None, None, None]
    return mean + keep * torch.exp(0.5 * _at(s.log_var, t)) * noise


@torch.no_grad()
def sample(s: Schedule, G, ops, shape, nz: int, gen: torch.Generator | None):
    """One sampler call: x_T ~ N(0, 1), then for t = T-1 .. 0 a fresh z, G's
    x_0 and a posterior draw, all drawn from `gen` in that order."""
    dev = s.a_s.device
    x = torch.randn(shape, generator=gen, device=dev)
    for i in range(s.T - 1, -1, -1):
        t = torch.full((shape[0],), i, dtype=torch.int64, device=dev)
        z = torch.randn((shape[0], nz), generator=gen, device=dev)
        x0 = G(ops, x, t, z)
        x = posterior(s, x0, x, t, torch.randn(x.shape, generator=gen, device=dev))
    return x
