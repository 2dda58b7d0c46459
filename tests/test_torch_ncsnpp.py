"""The port's NCSN++ generator against the JAX package, at the tiny shape
of the flagship recipe (`_flagship_config(tiny=True)`: image 16, nf 16,
ch_mult [1,2], 1 resblock, attention at 8) and at the six levels of the
CelebA-HQ 256 recipe cut to image 64 and nf 16; the bf16 route through
the gated 3x3 conv (K2) at 128x128; and the full-width CelebA-HQ 256
parameter tree, by shape only.

Weights are non-trivial (`randomize_parameters_`), guarded by the std of
the output; the DDPM init would make the output ~0 and the comparison
vacuous. f32 tolerance atol 1e-4 over the whole network; bf16 against the
JAX package's bf16 with its Pallas conv, max-abs 0.03 (the bound of
`test_bf16_close_to_f32`).
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

from _torch_port import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    celeba256_config,
    count_pallas_calls,
    count_routed,
    flax_params_from_port,
    nchw,
    nhwc,
    one_torch_thread,
    randn,
    tiny_config,
)

B = 4


def _jax_shapes(gen, cfg):
    """The JAX generator's variables as ShapeDtypeStructs (no init run)."""
    k = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: gen.init(
        {"params": k, "dropout": k},
        jnp.zeros((1, cfg.image_size, cfg.image_size, cfg.num_channels)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, cfg.nz)),
    ))


def _jax_template(gen, cfg):
    """A zero-filled variables tree: the port's weights fill it."""
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), _jax_shapes(gen, cfg))


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def jax_model(cfg):
    gen = JNCSNpp.from_config(cfg)
    return gen, _jax_template(gen, cfg)


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
    apply = jax.jit(lambda p, x_, t_, z_: gen.apply({"params": p}, x_, t_, z_, train=False))
    want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z)))
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
    rng = np.random.RandomState(5)  # distinct values, so a wrong transpose shows
    params = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                          template["params"])
    ours = state_dict_from_flax(params)
    theirs = export_torch_state_dict(params)
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(), err_msg=k)
    net = NCSNpp.from_config(cfg)
    net.load_state_dict(ours, strict=True)
    assert set(net.state_dict()) == set(theirs)


def test_registry_and_dtype_names(cfg):
    assert get_model("ncsnpp") is NCSNpp
    with pytest.raises(ValueError, match="compute_dtype"):
        NCSNpp.from_config(cfg.replace(compute_dtype="float16"))


def test_init_is_drawn_from_the_generator(cfg):
    a = NCSNpp.from_config(cfg, generator=torch.Generator().manual_seed(3))
    b = NCSNpp.from_config(cfg, generator=torch.Generator().manual_seed(3))
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka


def test_six_level_generator_matches_jax():
    """The CelebA-HQ 256 structure (six levels, 2 resblocks, attention at
    16, n_mlp 3) at image 64, nf 16, in f32."""
    cfg = celeba256_config(tiny=True)
    gen = JNCSNpp.from_config(cfg)
    net = _port(cfg, seed=1)
    params = flax_params_from_port(net, _jax_template(gen, cfg))
    b, s = 2, cfg.image_size
    x, t, z = randn(12, b, s, s, 3), np.array([0, 1], np.int32), randn(13, b, cfg.nz)
    apply = jax.jit(lambda p, x_, t_, z_: gen.apply({"params": p}, x_, t_, z_, train=False))
    want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z)))
    assert np.std(want) > 0.05, "weights are trivial: the comparison would be vacuous"
    got = _run(net, x, t, z)
    assert got.shape == (b, 3, s, s)
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-4)


def test_bf16_gated_convs_match_jax_pallas(monkeypatch):
    """Image 128, nf 64, ch_mult [1, 2], 1 resblock, bf16: the 128x128 level
    passes the K2 gate. The JAX package runs its Pallas conv
    (DDGAN_TPU_PALLAS_CONV=1, s2d closure off, interpret mode on the CPU);
    the port routes the same convs to `pair_conv3x3` (its plain version on
    the CPU)."""
    monkeypatch.setenv("DDGAN_TPU_PALLAS_CONV", "1")
    monkeypatch.setenv("DDGAN_TPU_S2D_CONV", "0")
    cfg = tiny_config(image_size=128, num_channels_dae=64, ch_mult=[1, 2],
                      num_res_blocks=1, compute_dtype="bfloat16")
    gen = JNCSNpp.from_config(cfg)
    net = _port(cfg, seed=2)
    params = flax_params_from_port(net, _jax_template(gen, cfg))
    x, t, z = randn(14, 1, 128, 128, 3), np.array([1], np.int32), randn(15, 1, cfg.nz)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(z))

    def apply(p, x_, t_, z_):
        return gen.apply({"params": p}, x_, t_, z_, train=False)

    n_pallas = count_pallas_calls(jax.make_jaxpr(apply)(params, *args).jaxpr)
    want = np.asarray(jax.jit(apply)(params, *args))
    calls = count_routed(monkeypatch)
    got = _run(net, x, t, z)
    # conv 0/1 of the 128² down block, conv 1 of the first up block (C_in
    # 192 fails the gate) and conv 0/1 of the second
    assert len(calls) == n_pallas == 5
    assert np.std(want) > 0.05
    assert float(np.abs(nhwc(got) - want).max()) < 0.03


def test_celeba256_parameter_tree_matches_jax():
    """The full-width CelebA-HQ 256 generator, by shape: `jax.eval_shape` of
    the JAX package's init against the port's state_dict (on the meta
    device), through `state_dict_from_flax`."""
    cfg = celeba256_config()
    gen = JNCSNpp.from_config(cfg)
    shapes = _jax_shapes(gen, cfg)["params"]
    zeros = jax.tree.map(lambda a: np.broadcast_to(np.zeros((), np.float32), a.shape), shapes)
    theirs = state_dict_from_flax(zeros)
    with torch.device("meta"):
        net = NCSNpp.from_config(cfg)
    ours = net.state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in theirs.items()}
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in net.parameters()) == n_jax == 39_726_979
