"""Every initial parameter of the port's seeded models against the JAX
package's `init`.

The port builds G and D through its training path
(`train.loop.build_models(args, torch.Generator)`, which runs
`NCSNpp.from_config(cfg, generator=)` and `build_discriminator`); the JAX
package through its own `build_models` and `init`, as `create_train_state`
does. The JAX tensors become torch keys through `export_torch_state_dict`
(G) and `state_dict_from_flax` (D). Models: G at the tiny flagship shape
(`tiny_config`, ch_mult [1, 2]) and at each option family of
`chip_smoke.FAMILIES` over it; DiscriminatorSmall and DiscriminatorLarge at
ngf 8.

For each key: the same shape; where the JAX init is a constant (two
distinct values at most: the AdaGN style bias [1]*C + [0]*C, the norms'
ones and zeros, every zero bias; the port's constants, equal under two
seeds, must be the same keys), exact equality; where it is random and has at least 256 elements,
the std within STD_TOL of the JAX initializer's and the max-abs within
BOUND_TOL of its bound. Every random initializer of both packages at that
size is a uniform(±bound) variance scaling: the bound is the JAX draw's
max-abs (within ~0.4% of it at 256 elements), the std bound/sqrt(3). The
two packages draw from different streams, so random tensors agree in law
only.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ddgan_tpu.compat import export_torch_state_dict
from ddgan_tpu.train.loop import build_models as jax_build_models

from ddgan_torch.compat import state_dict_from_flax
from ddgan_torch.config import Config
from ddgan_torch.train.loop import build_models

from _torch_port import one_torch_thread, tiny_config  # noqa: F401

STD_TOL = 0.10  # relative, port std against the JAX initializer's
BOUND_TOL = 0.05  # relative, port max-abs against the JAX initializer's bound
MIN_RANDOM = 256  # elements a random tensor needs for the statistics

G_CASES = ["flagship"] + sorted(chip_smoke.FAMILIES)
D_CASES = ["disc_small", "disc_large"]


def _config(case: str):
    cfg = tiny_config()
    if case in chip_smoke.FAMILIES:
        cfg = chip_smoke.family_config(cfg, case)
    if case == "disc_large":  # six halvings need 64² (D's parameters do not depend on it)
        cfg = cfg.replace(disc_small="no", image_size=64)
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_state_dict(case: str) -> dict[str, np.ndarray]:
    """The JAX package's initial G (or D) as torch keys. `lazy_init` runs
    only the parameter draws of `init` (the same initializers and key
    tree). The keys are RBG keys: their draws follow the same laws as the
    default Threefry keys' and their initializer programs compile in about
    half the time."""
    cfg = _config(case)
    gen, disc = jax_build_models(cfg)
    kg, kd, kdrop = jax.random.split(jax.random.key(3, impl="rbg"), 3)
    x = jax.ShapeDtypeStruct((2, cfg.image_size, cfg.image_size, cfg.num_channels), jnp.float32)
    t = jax.ShapeDtypeStruct((2,), jnp.int32)
    if case in D_CASES:
        sd = state_dict_from_flax(disc.lazy_init(kd, x, t, x)["params"])
    else:
        z = jax.ShapeDtypeStruct((2, cfg.nz), jnp.float32)
        v = gen.lazy_init({"params": kg, "dropout": kdrop}, x, t, z)
        sd = export_torch_state_dict(v["params"], v.get("buffers"))
    return {k: np.array(v, np.float32) for k, v in sd.items()}


def _jax_random(want: dict) -> set:
    """The keys JAX draws at random: more than two distinct values (its
    constants are zeros, ones, or the style bias's [1]*C + [0]*C)."""
    return {k for k, w in want.items() if np.unique(w).size > 2}


def _port_model(cfg, case: str, generator: torch.Generator) -> torch.nn.Module:
    g, d = build_models(Config(**dataclasses.asdict(cfg)), generator)
    return d if case in D_CASES else g


@pytest.mark.parametrize("case", G_CASES + D_CASES)
def test_initial_parameters_match_jax(case):
    cfg = _config(case)
    want = _jax_state_dict(case)
    model = _port_model(cfg, case, torch.Generator().manual_seed(0))
    other = _port_model(cfg, case, torch.Generator().manual_seed(1))
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    # the port's constants (equal under two seeds) are the tensors JAX does not draw
    constant = {k for k, v in other.state_dict().items() if np.array_equal(v.numpy(), got[k])}
    assert constant == set(want) - _jax_random(want)
    wrong = []
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if key in constant:
            if not np.array_equal(g, w):
                wrong.append(f"{key}: constant, port max-abs diff {np.abs(g - w).max()}")
        elif w.size >= MIN_RANDOM:
            bound = np.abs(w).max()
            std = bound / np.sqrt(3.0)  # the initializer's: uniform(±bound)
            if abs(g.std() - std) > STD_TOL * std:
                wrong.append(f"{key}: std {g.std()} against {std}")
            if abs(np.abs(g).max() - bound) > BOUND_TOL * bound:
                wrong.append(f"{key}: max-abs {np.abs(g).max()} against bound {bound}")
    assert not wrong, "\n".join(wrong)


@pytest.mark.parametrize("case", G_CASES + D_CASES)
def test_each_parameter_is_drawn_once(case, monkeypatch):
    """Every draw from the build's generator fills a parameter or buffer of
    G or D, each once, and each tensor of the model that JAX draws at
    random is drawn."""
    cfg = _config(case)
    gen = torch.Generator().manual_seed(0)
    drawn = []
    for name in ("uniform_", "normal_"):
        inner = getattr(torch.Tensor, name)

        def draw(t, *args, _inner=inner, **kwargs):
            if kwargs.get("generator") is gen:
                drawn.append(t.data_ptr())
            return _inner(t, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, draw)
    g, d = build_models(Config(**dataclasses.asdict(cfg)), gen)
    monkeypatch.undo()
    assert len(drawn) == len(set(drawn)), "a tensor was drawn more than once"
    model, other = (d, g) if case in D_CASES else (g, d)
    owner = {v.data_ptr(): k for k, v in model.state_dict().items()}
    others = {v.data_ptr() for v in other.state_dict().values()}
    assert set(drawn) <= set(owner) | others
    random = _jax_random(_jax_state_dict(case))
    assert {owner[p] for p in drawn if p in owner} >= random
