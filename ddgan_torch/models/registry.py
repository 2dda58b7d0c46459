"""Model registry. (reference: score_sde/models/utils.py:34-57)"""

from __future__ import annotations

import numpy as np

_MODELS: dict[str, type] = {}


def register_model(cls=None, *, name: str | None = None):
    """Decorator registering a model class under `name` (or its class name)."""

    def _register(c):
        local_name = name if name is not None else c.__name__
        if local_name in _MODELS:
            raise ValueError(f"Already registered model with name: {local_name}")
        _MODELS[local_name] = c
        return c

    if cls is None:
        return _register
    return _register(cls)


def get_model(name: str) -> type:
    return _MODELS[name]


# ---- reference score_sde/models/utils.py helpers (:60-148), numpy ----------
def get_sigmas(config) -> np.ndarray:
    """SMLD noise levels, geometric from sigma_max to sigma_min. (utils.py:60-70)"""
    return np.exp(np.linspace(np.log(config.sigma_max), np.log(config.sigma_min),
                              config.num_scales))


def get_ddpm_params(config) -> dict:
    """The original DDPM's betas and alphas over 1000 steps. (utils.py:73-97)"""
    num_diffusion_timesteps = 1000
    beta_start = config.beta_min / config.num_scales
    beta_end = config.beta_max / config.num_scales
    betas = np.linspace(beta_start, beta_end, num_diffusion_timesteps, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    return {
        "betas": betas,
        "alphas": alphas,
        "alphas_cumprod": alphas_cumprod,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_1m_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "beta_min": beta_start * (num_diffusion_timesteps - 1),
        "beta_max": beta_end * (num_diffusion_timesteps - 1),
        "num_diffusion_timesteps": num_diffusion_timesteps,
    }


def create_model(config, generator=None):
    """The registered model `config.name`, built from the config.
    (utils.py:100-106; one device, so no DataParallel wrap.)"""
    return get_model(config.name).from_config(config, generator=generator)


def get_model_fn(model, train: bool = False):
    """A callable (x, labels, *rest) -> output that runs `model` in train
    or eval mode. (utils.py:109-134)"""

    def model_fn(x, labels, *rest):
        model.train(train)
        return model(x, labels, *rest)

    return model_fn
