"""Layers and blocks of the port (`ddgan_torch.nn`) against the JAX package.

Each case builds the port module, gives it non-trivial weights with
`randomize_parameters_`, carries them to the flax module through the JAX
package's importer and compares outputs on the same numpy inputs. The
resblocks cover the up and down FIR paths that reach the fir2x kernel on
the GPU. Tolerance rtol 1e-4 / atol 1e-5: f32 sums in another order
through a few convs and norms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddgan_tpu import nn as jnn
from ddgan_tpu.nn import layers as jlayers

from ddgan_torch import nn as pnn
from ddgan_torch.utils import randomize_parameters_

from _torch_port import flax_params_from_port, nchw, nhwc, randn

TOL = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(0)


def _apply(jmod, port, *args_np, torch_args=None, seed=0, **kw):
    """Run flax `jmod` and torch `port` on the same inputs and weights."""
    randomize_parameters_(port, seed)
    jargs = [jnp.asarray(a) for a in args_np]
    template = jmod.init({"params": KEY, "dropout": KEY}, *jargs, **kw)
    params = flax_params_from_port(port, template)
    want = jmod.apply({"params": params}, *jargs, **kw)
    with torch.no_grad():
        got = port.eval()(*torch_args)
    return got, np.asarray(want)


def test_adaptive_group_norm():
    x, z = randn(0, 2, 8, 8, 16) * 3 + 1, randn(1, 2, 12)
    got, want = _apply(jnn.AdaptiveGroupNorm(4, 12), pnn.AdaptiveGroupNorm(4, 16, 12),
                       x, z, torch_args=(nchw(x), torch.from_numpy(z)))
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_head_group_norm():
    x = randn(2, 2, 4, 4, 32) + 2
    got, want = _apply(jnn.HeadGroupNorm(8), pnn.HeadGroupNorm(8, 32), x, torch_args=(nchw(x),))
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_attention_block():
    x = randn(3, 2, 8, 8, 32)
    got, want = _apply(jnn.AttnBlockpp(skip_rescale=True, init_scale=0.0),
                       pnn.AttnBlockpp(32, skip_rescale=True), x, torch_args=(nchw(x),))
    assert np.std(want - x) > 1e-2  # the attention branch is not ~0
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.mark.parametrize("mode,in_ch,out_ch,fir", [
    ("up", 16, 16, True), ("down", 16, 16, True), ("none", 24, 16, True),
    ("up", 16, 16, False), ("down", 16, 16, False)])
def test_biggan_resblock(mode, in_ch, out_ch, fir):
    x, temb, zemb = randn(4, 2, 8, 8, in_ch), randn(5, 2, 32), randn(6, 2, 12)
    jmod = jnn.ResnetBlockBigGANppAdagn(
        act=jax.nn.silu, out_ch=out_ch, up=mode == "up", down=mode == "down",
        dropout=0.0, fir=fir, fir_kernel=(1, 3, 3, 1), skip_rescale=True)
    port = pnn.ResnetBlockBigGANppAdagn(
        in_ch, out_ch, temb_dim=32, zemb_dim=12, up=mode == "up", down=mode == "down",
        dropout=0.0, fir=fir, fir_kernel=(1, 3, 3, 1), skip_rescale=True)
    got, want = _apply(jmod, port, x, temb, zemb,
                       torch_args=(nchw(x), torch.from_numpy(temb), torch.from_numpy(zemb)))
    assert got.shape == nchw(want).shape
    assert np.std(want) > 0.05
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.mark.parametrize("fir,with_conv", [(True, True), (True, False), (False, True),
                                           (False, False)])
@pytest.mark.parametrize("kind", ["Upsample", "Downsample"])
def test_resample_blocks(kind, fir, with_conv):
    x = randn(7, 2, 8, 8, 3)
    out_ch = 16 if with_conv else 3
    jmod = getattr(jnn, kind)(features=out_ch, with_conv=with_conv, fir=fir)
    port = getattr(pnn, kind)(3, out_ch, with_conv=with_conv, fir=fir)
    got, want = _apply(jmod, port, x, torch_args=(nchw(x),))
    assert got.shape == nchw(want).shape
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_dense_nin_pixelnorm_and_embedding():
    v = randn(8, 4, 10)
    got, want = _apply(jlayers.Dense(6), pnn.Dense(10, 6), v, torch_args=(torch.from_numpy(v),))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    x = randn(9, 2, 4, 4, 10)
    got, want = _apply(jlayers.NIN(6), pnn.NIN(10, 6), x, torch_args=(nchw(x),))
    np.testing.assert_allclose(nhwc(got), want, **TOL)
    want = jlayers.PixelNorm().apply({}, jnp.asarray(v))
    np.testing.assert_allclose(pnn.PixelNorm()(torch.from_numpy(v)).numpy(), want, **TOL)
    t = np.array([0, 1, 3, 999])
    for dim in (16, 17):
        np.testing.assert_allclose(
            pnn.get_timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jlayers.get_timestep_embedding(jnp.asarray(t), dim)), **TOL)


@pytest.mark.parametrize("init_scale", [1.0, 0.0])
def test_initializer_bounds_match_jax(init_scale):
    """default_init / dense_init draw uniform(±bound) with the JAX package's
    bound: fan_avg for convs, fan_out (the reference quirk) for dense."""
    conv = pnn.Conv3x3(64, 32, init_scale=init_scale)
    jconv = jlayers.Conv3x3(32, init_scale=init_scale)
    jk = jconv.init(KEY, jnp.zeros((1, 8, 8, 64)))["params"]["conv"]["kernel"]
    dense = pnn.Dense(64, 256)
    jd = jlayers.Dense(256).init(KEY, jnp.zeros((1, 64)))["params"]["linear"]["kernel"]
    for ours, theirs in ((conv.weight, jk), (dense.weight, jd)):
        a, b = ours.abs().max().item(), float(jnp.abs(theirs).max())
        assert abs(a - b) <= 0.02 * b
    assert torch.all(conv.bias == 0)
