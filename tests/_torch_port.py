"""Shared helpers for the tests that hold `ddgan_torch` against `ddgan_tpu`.

Inputs come from numpy seeds and cross as numpy arrays; images are
transposed NHWC (JAX package) <-> NCHW (port). Weights are drawn once on
the port's side with `randomize_parameters_` (non-trivial, unlike the
DDPM init whose 1e-10 layers make every output ~0) and carried to the JAX
package through its own importer.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddgan_tpu.compat import convert_torch_state_dict


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread. The suite runs several
    workers on a few cores, and on the small ops of these tests torch's own
    thread pool on top of them spins more than it works (two orders of
    magnitude slower in the parallel run). Import it into a test module to
    use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def random_flax_params(params, seed: int):
    """Every leaf of a flax parameter tree redrawn N(0,1)/sqrt(fan_in) from a
    numpy seed (fan_in: all but the last axis of a kernel, the size of a
    vector); the JAX-side counterpart of `randomize_parameters_`."""
    rng = np.random.RandomState(seed)

    def draw(a):
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else a.size
        return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, params)


def tiny_config(**overrides):
    from __graft_entry__ import _flagship_config

    return _flagship_config(tiny=True).replace(**overrides)


def celeba256_config(tiny: bool = False, **overrides):
    """The CelebA-HQ 256 paper recipe of `tools/bench_extra.py:105-113` (nf 64,
    ch_mult 1 1 2 2 4 4, 2 BigGAN resblocks, attention at 16, n_mlp 3, T=2,
    bf16). `tiny`: the same six levels at image 64, nf 16, f32."""
    from ddgan_tpu.config import Config

    cfg = Config(
        dataset="celeba_256", image_size=256, num_channels=3,
        num_channels_dae=64, ch_mult=[1, 1, 2, 2, 4, 4], num_res_blocks=2,
        attn_resolutions=[16], nz=100, z_emb_dim=256, n_mlp=3,
        t_emb_dim=256, ngf=64, num_timesteps=2, batch_size=16,
        dropout=0.0, compute_dtype="bfloat16",
    )
    if tiny:
        cfg = cfg.replace(image_size=64, num_channels_dae=16, nz=16, z_emb_dim=32,
                          batch_size=4, compute_dtype="float32")
    return cfg.replace(**overrides)


def count_pallas_calls(jaxpr) -> int:
    """pallas_call equations in a jaxpr and all its sub-jaxprs."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            n += 1
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                sub = getattr(sub, "jaxpr", sub)  # a ClosedJaxpr holds its Jaxpr
                if hasattr(sub, "eqns"):
                    n += count_pallas_calls(sub)
    return n


def count_routed(monkeypatch) -> list:
    """Record the input shape of each call of `pair_conv.pair_conv3x3`, the
    route `Conv3x3` takes for a gated conv (on the CPU it runs the plain
    version, so the kernel's launch count cannot show it)."""
    from ddgan_torch.ops import pair_conv

    calls = []
    inner = pair_conv.pair_conv3x3

    def counting(x, w, b):
        calls.append(tuple(x.shape))
        return inner(x, w, b)

    monkeypatch.setattr(pair_conv, "pair_conv3x3", counting)
    return calls
