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


# ---------------------------------------------------------------- train steps
def np_step_draws(cfg, batch: int, seed: int) -> list:
    """One train step's t, q-noises, z and posterior noise (D's, then G's),
    NHWC, from a numpy seed: the order of `ddgan_torch.train.StepDraws`."""
    rs = np.random.RandomState(seed)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.num_channels)
    out = []
    for _ in range(2):
        out += [rs.randint(0, cfg.num_timesteps, batch).astype(np.int32),
                rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32),
                rs.randn(batch, cfg.nz).astype(np.float32), rs.randn(*shape).astype(np.float32)]
    return out


def torch_step_draws(np_draws):
    from ddgan_torch.train import StepDraws

    return StepDraws(*[torch.from_numpy(a).long() if a.ndim == 1 else
                       (nchw(a) if a.ndim == 4 else torch.from_numpy(a)) for a in np_draws])


def jax_forward_losses(jgen, jdisc, cfg):
    """The PSO step's forward-only losses composed from the JAX package's
    functions (`ddgan_tpu/train/pso_step.py:113-130` with injected noise,
    dropout off): f(params_G, params_D, real, *draws) -> (errD_real,
    errD_fake, errG)."""
    from ddgan_tpu.diffusion import DiffusionCoefficients as JCoeff
    from ddgan_tpu.diffusion import PosteriorCoefficients as JPos
    from ddgan_tpu.diffusion import q_sample_pairs_with_noise as jq_pairs
    from ddgan_tpu.diffusion import sample_posterior_with_noise as jposterior

    coeff = JCoeff.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max)
    pos = JPos.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max)

    def apply_D(p, x, t, x_t):
        return jdisc.apply({"params": p}, x, t, x_t).reshape(-1).astype(jnp.float32)

    @jax.jit
    def losses(pG, pD, real, t, nq, nn, z, npost, t2, nq2, nn2, z2, npost2):
        x_t, x_tp1 = jq_pairs(coeff, real, t, nq, nn)
        errD_real = jax.nn.softplus(-apply_D(pD, x_t, t, x_tp1)).mean()
        x0 = jgen.apply({"params": pG}, x_tp1, t, z, train=True)
        errD_fake = jax.nn.softplus(apply_D(pD, jposterior(pos, x0, x_tp1, t, npost), t,
                                            x_tp1)).mean()
        _, x_tp1_g = jq_pairs(coeff, real, t2, nq2, nn2)
        x0g = jgen.apply({"params": pG}, x_tp1_g, t2, z2, train=True)
        errG = jax.nn.softplus(-apply_D(pD, jposterior(pos, x0g, x_tp1_g, t2, npost2), t2,
                                        x_tp1_g)).mean()
        return errD_real, errD_fake, errG

    return losses


def port_list(tree, module: torch.nn.Module, lead: int = 0) -> list:
    """A flax parameter tree (each leaf with `lead` leading axes) as the
    port's tensors in `module.parameters()` order."""
    from ddgan_torch.compat import state_dict_from_flax

    sd = state_dict_from_flax(jax.tree.map(np.asarray, tree), lead=lead)
    return [sd[k] for k, _ in module.named_parameters()]


class Flat:
    """A flax parameter tree as one float32 numpy vector (leaves in flatten
    order) and back; `to_port` maps a (lead..., P) vector onto a module's tensors.
    The JAX package's AdaptivePSO is elementwise, so it gives the same
    values over the vector as over the tree, and its ops then run eagerly
    over one shape instead of compiling once for every parameter's shape."""

    def __init__(self, tree):
        leaves, self.treedef = jax.tree.flatten(tree)
        self.shapes = [l.shape for l in leaves]
        self.cuts = np.cumsum([int(np.prod(sh)) for sh in self.shapes])[:-1]

    def vec(self, tree, lead: int = 0) -> np.ndarray:
        leaves = [np.asarray(l) for l in jax.tree.leaves(tree)]
        return np.concatenate([l.reshape(l.shape[:lead] + (-1,)) for l in leaves], axis=-1)

    def tree(self, vec):
        vec = np.asarray(vec)
        lead = vec.shape[:-1]
        parts = np.split(vec, self.cuts, axis=-1)
        return jax.tree.unflatten(self.treedef, [p.reshape(lead + sh)
                                                 for p, sh in zip(parts, self.shapes)])

    def to_port(self, vec, module):
        return port_list(self.tree(vec), module, vec.ndim - 1)

    def draws(self, key, vec, swarm: int, module):
        """The r1, r2 of `AdaptivePSO.step` over the vector under `key` (the
        2n = 2 keys of a one-leaf step), as the port's `PSODraws`."""
        from ddgan_torch.train import PSODraws

        k1, k2 = jax.random.split(key)
        return PSODraws(self.to_port(jax.random.uniform(k1, (swarm,) + vec.shape), module),
                        self.to_port(jax.random.uniform(k2, (swarm,) + vec.shape), module))

    def noise(self, key, vec, swarm: int, module):
        """The N(0, 1) draws of `AdaptivePSO.init` over the vector under `key`."""
        return self.to_port(jax.random.normal(jax.random.split(key, 1)[0],
                                              (swarm,) + vec.shape), module)
