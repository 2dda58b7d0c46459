"""Every NCSN++ generator option of the port against the JAX package, on
the CPU, through the option families of `chip_smoke.FAMILIES` over the
tiny flagship config (`tiny_config()`: image 16, nf 16, ch_mult [1, 2], 1
resblock): DDPM and one-adaGN resblocks, the output and input pyramids
(skip and residual, combined by sum and by cat), the Fourier embedding,
naive resampling with and without conv, no time conditioning, inputs in
[0, 1] and no tanh.

Weights are non-trivial (`randomize_parameters_`), guarded by the std of
the output, and carried to the JAX package with the Fourier projection W
in its 'buffers' collection. f32 tolerance atol 1e-4 over the network;
gradients within 1e-4 of each tensor's largest magnitude (the attention
key's bias, whose gradient is zero in exact arithmetic, below 1e-7 of the
largest); bf16 within the 0.03 of `test_bf16_close_to_f32`. With
embedding_type fourier both packages embed log(t), so the row at t = 0 is
not finite in either; the comparison holds t >= 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddgan_tpu.compat import export_torch_state_dict
from ddgan_tpu.models import NCSNpp as JNCSNpp

from ddgan_torch.compat import state_dict_from_flax
from ddgan_torch.models import NCSNpp
from ddgan_torch.ops import fir2x
from ddgan_torch.utils import randomize_parameters_

from _torch_port import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    chip_smoke,
    count_pallas_calls,
    jax_variables,
    nchw,
    nhwc,
    one_torch_thread,
    randn,
    tiny_config,
)

SMOKE = chip_smoke()
FAMILIES = SMOKE.FAMILIES
B = 2
T_ROWS = np.array([1, 3], np.int32)  # t >= 1: the Fourier embedding takes log(t)


def _family(name, **extra):
    return tiny_config(**FAMILIES[name], **extra)


def _port(cfg, seed=0):
    return randomize_parameters_(NCSNpp.from_config(cfg), seed).eval()


def _inputs(cfg, seed=20, t=T_ROWS):
    x = randn(seed, len(t), cfg.image_size, cfg.image_size, cfg.num_channels)
    if not cfg.centered:
        x = (x - x.min()) / (x.max() - x.min())  # inputs in [0, 1]
    return x, t, randn(seed + 1, len(t), cfg.nz)


def _jax_apply(gen):
    return jax.jit(lambda v, x_, t_, z_: gen.apply(v, x_, t_, z_, train=False))


def _run(net, x, t, z):
    with torch.no_grad():
        return net(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(z))


def _compare(cfg, seed=0):
    gen, net = JNCSNpp.from_config(cfg), _port(cfg, seed)
    variables = jax_variables(gen, cfg, net)
    x, t, z = _inputs(cfg)
    want = np.asarray(_jax_apply(gen)(variables, jnp.asarray(x), jnp.asarray(t),
                                      jnp.asarray(z)))
    assert np.std(want) > 0.05, "weights are trivial: the comparison would be vacuous"
    got = _run(net, x, t, z)
    assert got.dtype == torch.float32 and got.shape == (len(t), cfg.num_channels,
                                                        cfg.image_size, cfg.image_size)
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-4)
    return net, variables


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(family):
    _compare(_family(family))


@pytest.mark.parametrize("family", ["naive", "ddpm_naive"])
def test_three_level_family_matches_jax(family):
    """Two transitions each way: naive resampling between 16, 8 and 4."""
    _compare(_family(family, ch_mult=[1, 2, 2]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_dict_keys_are_the_exports(family):
    """The key set of `state_dict()` is `export_torch_state_dict`'s of the
    JAX variables, W included; the port loads those with strict=True and its
    own state_dict round-trips through the JAX tree unchanged."""
    cfg = _family(family)
    gen, net = JNCSNpp.from_config(cfg), _port(cfg, seed=3)
    variables = jax_variables(gen, cfg, net)
    exported = export_torch_state_dict(variables["params"], variables.get("buffers"))
    assert set(exported) == set(net.state_dict())
    other = NCSNpp.from_config(cfg)
    other.load_state_dict(exported, strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    ours = state_dict_from_flax(jax.tree.map(np.asarray, variables["params"]),
                                jax.tree.map(np.asarray, variables.get("buffers", {})))
    assert set(ours) == set(exported)
    # the buffer is never a parameter: Adam, the EMA and the swarms see params only
    n_params = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in net.parameters()) == n_params
    assert [k for k, _ in net.named_buffers()] == (
        ["all_modules.0.W"] if cfg.embedding_type == "fourier" else [])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fir_route_matches_jax_pallas_count(family, monkeypatch):
    """The port's fir2x calls in one forward equal the JAX package's
    pl.pallas_call count with its Pallas FIR on (DDGAN_TPU_PALLAS_FIR=1), and
    `chip_smoke.expected_g_fir` for the family."""
    monkeypatch.setenv("DDGAN_TPU_PALLAS_FIR", "1")
    cfg = _family(family)
    gen, net = JNCSNpp.from_config(cfg), _port(cfg)
    variables = jax_variables(gen, cfg, net)
    x, t, z = _inputs(cfg)
    jaxpr = jax.make_jaxpr(lambda v, x_, t_, z_: gen.apply(v, x_, t_, z_, train=False))(
        variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z))
    fir2x.reset_launch_counts()
    _run(net, x, t, z)
    calls = {k: v["forward"] for k, v in fir2x.CALLS.items()}
    assert calls == SMOKE.expected_g_fir(len(cfg.ch_mult) - 1, **SMOKE.FAMILY_FIR[family])
    assert sum(calls.values()) == count_pallas_calls(jaxpr.jaxpr)
    assert fir2x.LAUNCHES == {"down2x": 0, "up2x": 0}  # CPU tensors take the plain path


@pytest.mark.parametrize("family", ["pyramid_sum", "ddpm_fir", "residual_pyramid"])
def test_gradients_match_jax(family):
    """d/dθ of sum(out · r) for a fixed random r, every parameter against
    `jax.grad`, within 1e-4 of each tensor's largest magnitude."""
    cfg = _family(family)
    gen, net = JNCSNpp.from_config(cfg), _port(cfg, seed=4)
    variables = jax_variables(gen, cfg, net)
    x, t, z = _inputs(cfg)
    r = randn(30, *x.shape)

    def loss(p):
        out = gen.apply({**variables, "params": p}, jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(z), train=False)
        return (out * jnp.asarray(r)).sum()

    want = state_dict_from_flax(jax.tree.map(np.asarray,
                                             jax.jit(jax.grad(loss))(variables["params"])))
    out = net(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(z))
    (out * nchw(r)).sum().backward()
    top = max(float(v.abs().max()) for v in want.values())
    for k, p in net.named_parameters():
        if k.endswith("NIN_1.b"):  # attention's key bias: zero in exact arithmetic
            assert max(float(p.grad.abs().max()), float(want[k].abs().max())) < 1e-7 * top, k
            continue
        scale = float(want[k].abs().max())
        assert scale > 1e-6 * top, k
        assert float((p.grad - want[k]).abs().max()) <= 1e-4 * scale, k


def test_pyramid_sum_bf16_close_to_f32():
    cfg = _family("pyramid_sum")
    f32, bf16 = _port(cfg), _port(cfg.replace(compute_dtype="bfloat16"))
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    x, t, z = _inputs(cfg)
    a, b = _run(f32, x, t, z), _run(bf16, x, t, z)
    assert b.dtype == torch.float32 and float(a.std()) > 0.05
    assert float((a - b).abs().max()) < 0.03


def test_fourier_row_at_t0_is_not_finite_in_both():
    """log(0) = -inf: the row at t = 0 is non-finite in both packages (the
    JAX package's behaviour, kept); the rows at t >= 1 agree."""
    cfg = _family("pyramid_cat_fourier_one")
    gen, net = JNCSNpp.from_config(cfg), _port(cfg)
    variables = jax_variables(gen, cfg, net)
    x, t, z = _inputs(cfg, t=np.array([0, 2], np.int32))
    want = np.asarray(_jax_apply(gen)(variables, jnp.asarray(x), jnp.asarray(t),
                                      jnp.asarray(z)))
    got = nhwc(_run(net, x, t, z))
    assert not np.isfinite(want[0]).any() and not np.isfinite(got[0]).any()
    assert np.isfinite(want[1]).all() and np.std(want[1]) > 0.05
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)


@pytest.mark.parametrize("key,value", [
    ("resblock_type", "ddpm++"), ("progressive", "input_skip"), ("progressive_input", "output_skip"),
    ("progressive_combine", "concat"), ("embedding_type", "sinusoidal"),
])
def test_unknown_option_values_raise(key, value):
    with pytest.raises(ValueError, match=key):
        NCSNpp.from_config(tiny_config(**{key: value}))


def test_from_config_ignores_the_tpu_knobs():
    """use_remat and remat_policy change no parameter (tests/test_torch_remat.py
    holds what they do); s2d_conv, a TPU layout, is still ignored."""
    cfg = tiny_config(use_remat="no")
    a = NCSNpp.from_config(cfg, generator=torch.Generator().manual_seed(1))
    b = NCSNpp.from_config(cfg.replace(use_remat="yes", remat_policy="save-convs"),
                           generator=torch.Generator().manual_seed(1))
    c = NCSNpp.from_config(cfg.replace(s2d_conv="off"), generator=torch.Generator().manual_seed(1))
    assert not a.use_remat and b.use_remat and b.remat_policy == "save-convs"
    assert not c.use_remat and vars(c).keys() == vars(a).keys()
    for other in (b, c):
        assert a.state_dict().keys() == other.state_dict().keys()
        for (k, va), vb in zip(a.state_dict().items(), other.state_dict().values()):
            assert torch.equal(va, vb), k


def test_fourier_w_is_drawn_from_the_generator():
    cfg = _family("pyramid_cat_fourier_one")
    a = NCSNpp.from_config(cfg, generator=torch.Generator().manual_seed(5))
    b = NCSNpp.from_config(cfg, generator=torch.Generator().manual_seed(5))
    w = a.all_modules[0].W
    assert torch.equal(w, b.all_modules[0].W) and w.shape == (cfg.num_channels_dae,)
    assert 8.0 < float(w.std()) < 32.0  # N(0, 1) * fourier_scale 16
