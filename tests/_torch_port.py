"""Shared helpers for the tests that hold `ddgan_torch` against `ddgan_tpu`.

Inputs come from numpy seeds and cross as numpy arrays; images are
transposed NHWC (JAX package) <-> NCHW (port). Weights are drawn once on
the port's side with `randomize_parameters_` (non-trivial, unlike the
DDPM init whose 1e-10 layers make every output ~0) and carried to the JAX
package through its own importer.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ddgan_tpu.compat import convert_torch_state_dict


def nchw(a) -> torch.Tensor:
    """NHWC numpy/jax array -> NCHW torch tensor (a copy)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)).copy())


def nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW torch tensor -> NHWC numpy array (a copy)."""
    return t.detach().float().cpu().numpy().transpose(0, 2, 3, 1).copy()


def randn(seed: int, *shape) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def flax_params_from_port(module: torch.nn.Module, template):
    """The port module's weights as the JAX module's (params, buffers)."""
    sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    params, _ = convert_torch_state_dict(sd, template.get("params", {}), template.get("buffers"))
    return jax.tree.map(jnp.asarray, params)


def tiny_config(**overrides):
    from __graft_entry__ import _flagship_config

    return _flagship_config(tiny=True).replace(**overrides)
