"""The port's NCSN++ generator against the JAX package, at the tiny shape
of the flagship recipe (`_flagship_config(tiny=True)`: image 16, nf 16,
ch_mult [1,2], 1 resblock, attention at 8).

Weights are non-trivial (`randomize_parameters_`), guarded by the std of
the output; the DDPM init would make the output ~0 and the comparison
vacuous. f32 tolerance atol 1e-4 over the whole network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddgan_tpu.compat import export_torch_state_dict
from ddgan_tpu.models import NCSNpp as JNCSNpp

from ddgan_torch.compat import state_dict_from_flax
from ddgan_torch.models import NCSNpp, get_model
from ddgan_torch.ops import fir2x
from ddgan_torch.utils import randomize_parameters_

from _torch_port import flax_params_from_port, nchw, nhwc, randn, tiny_config

B = 4


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def jax_model(cfg):
    gen = JNCSNpp.from_config(cfg)
    k = jax.random.PRNGKey(0)
    template = gen.init(
        {"params": k, "dropout": k},
        jnp.zeros((1, cfg.image_size, cfg.image_size, cfg.num_channels)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, cfg.nz)),
    )
    return gen, template


@pytest.fixture(scope="module")
def inputs(cfg):
    x = randn(10, B, cfg.image_size, cfg.image_size, cfg.num_channels)
    t = np.array([0, 1, 2, 3], np.int32)
    z = randn(11, B, cfg.nz)
    return x, t, z


def _port(cfg, seed=0, **overrides):
    net = NCSNpp.from_config(cfg.replace(**overrides) if overrides else cfg)
    return randomize_parameters_(net, seed).eval()


def _run(net, x, t, z):
    with torch.no_grad():
        return net(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(z))


def test_generator_matches_jax(cfg, jax_model, inputs):
    gen, template = jax_model
    net = _port(cfg)
    params = flax_params_from_port(net, template)
    x, t, z = inputs
    want = np.asarray(gen.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(z), train=False))
    assert np.std(want) > 0.05, "weights are trivial: the comparison would be vacuous"
    fir2x.reset_launch_counts()
    got = _run(net, x, t, z)
    assert fir2x.LAUNCHES == {"down2x": 0, "up2x": 0}  # CPU tensors take the plain path
    assert got.dtype == torch.float32 and got.shape == (B, 3, 16, 16)
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-4)


def test_bf16_close_to_f32(cfg, inputs):
    """compute_dtype=bfloat16 keeps parameters f32 and runs the conv and
    attention path in bf16; on the same weights it stays within a loose
    0.03 (max-abs on tanh outputs in [-1, 1]) of the f32 port: bf16 keeps 8
    mantissa bits, and the error of ~20 layers adds up."""
    f32, bf16 = _port(cfg), _port(cfg, compute_dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    a, b = _run(f32, *inputs), _run(bf16, *inputs)
    assert b.dtype == torch.float32
    assert float(a.std()) > 0.05
    assert float((a - b).abs().max()) < 0.03


def test_state_dict_from_flax_equals_export(cfg, jax_model):
    _, template = jax_model
    params = jax.tree.map(np.asarray, template["params"])
    ours = state_dict_from_flax(params)
    theirs = export_torch_state_dict(params)
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(), err_msg=k)
    net = NCSNpp.from_config(cfg)
    net.load_state_dict(ours, strict=True)
    assert set(net.state_dict()) == set(theirs)


@pytest.mark.parametrize("key,value", [
    ("resblock_type", "ddpm"), ("progressive", "output_skip"), ("progressive_input", "none"),
    ("embedding_type", "fourier"), ("fir", False), ("conditional", False),
    ("not_use_tanh", True), ("centered", False),
])
def test_unported_options_raise(cfg, key, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NCSNpp.from_config(cfg.replace(**{key: value}))


def test_registry_and_dtype_names(cfg):
    assert get_model("ncsnpp") is NCSNpp
    with pytest.raises(ValueError, match="compute_dtype"):
        NCSNpp.from_config(cfg.replace(compute_dtype="float16"))


def test_init_is_drawn_from_the_generator(cfg):
    a = NCSNpp.from_config(cfg, generator=torch.Generator().manual_seed(3))
    b = NCSNpp.from_config(cfg, generator=torch.Generator().manual_seed(3))
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka
