"""The blocks of the generator options (`ddgan_torch.nn.blocks`) against the
JAX package on the CPU: the Gaussian Fourier projection, Combine, the DDPM
and the one-adaGN resblocks, and the fused FIR upsample-conv
(`ops.resample.upsample_conv_2d`, the residual pyramid's and the DDPM
Upsample's) with its gradient; and a JAX `netG_*.ckpt` that holds
`buffers` into the port.

Weights as in tests/test_torch_blocks.py (`randomize_parameters_`, carried
to the flax module through the JAX package's importer, the Fourier W in
'buffers'); tolerance rtol 1e-4 / atol 1e-5, the gradients within 1e-4 of
their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddgan_tpu import nn as jnn
from ddgan_tpu.compat import convert_torch_state_dict
from ddgan_tpu.models import NCSNpp as JNCSNpp
from ddgan_tpu.ops import resample as jresample
from ddgan_tpu.train import checkpoint as jckpt

from ddgan_torch import nn as pnn
from ddgan_torch.compat import load_netg_ckpt
from ddgan_torch.models import NCSNpp
from ddgan_torch.ops import resample
from ddgan_torch.utils import randomize_parameters_

from _torch_port import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    chip_smoke,
    jax_variables,
    nchw,
    nhwc,
    one_torch_thread,
    randn,
    tiny_config,
)

TOL = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(0)


def _apply(jmod, port, *args_np, torch_args, seed=0, **kw_np):
    """flax `jmod` and torch `port` on the same inputs and weights (the
    port's parameters and buffers)."""
    randomize_parameters_(port, seed)
    jargs = [jnp.asarray(a) for a in args_np]
    jkw = {k: jnp.asarray(v) for k, v in kw_np.items()}
    template = jmod.init({"params": KEY, "dropout": KEY}, *jargs, **jkw)
    params, buffers = convert_torch_state_dict(
        {k: v.detach() for k, v in port.state_dict().items()}, template.get("params", {}),
        template.get("buffers"))
    variables = {"params": params, **({"buffers": buffers} if buffers else {})}
    want = jmod.apply(variables, *jargs, **jkw)
    with torch.no_grad():
        got = port.eval()(*torch_args)
    return got, np.asarray(want)


def test_gaussian_fourier_projection():
    t = np.array([0.5, 1.0, 3.0, 7.0], np.float32)
    port = pnn.GaussianFourierProjection(8, scale=16.0)
    got, want = _apply(jnn.GaussianFourierProjection(embedding_size=8, scale=16.0), port, t,
                       torch_args=(torch.from_numpy(t),))
    assert got.shape == (4, 16) and dict(port.named_parameters()) == {}
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("method", ["sum", "cat"])
def test_combine(method):
    x, y = randn(0, 2, 8, 8, 3), randn(1, 2, 8, 8, 16)
    got, want = _apply(jnn.Combine(16, method=method), pnn.Combine(3, 16, method), x, y,
                       torch_args=(nchw(x), nchw(y)))
    assert got.shape == nchw(want).shape
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.mark.parametrize("in_ch,out_ch,conv_shortcut,temb", [
    (16, 16, False, True), (16, 24, False, True), (16, 24, True, True), (24, 16, False, False)])
def test_ddpm_resblock(in_ch, out_ch, conv_shortcut, temb):
    x, t_emb, zemb = randn(2, 2, 8, 8, in_ch), randn(3, 2, 32), randn(4, 2, 12)
    jmod = jnn.ResnetBlockDDPMppAdagn(act=jax.nn.silu, out_ch=out_ch,
                                      conv_shortcut=conv_shortcut, dropout=0.0,
                                      skip_rescale=True)
    port = pnn.ResnetBlockDDPMppAdagn(in_ch, out_ch, temb_dim=32 if temb else None, zemb_dim=12,
                                      conv_shortcut=conv_shortcut, dropout=0.0,
                                      skip_rescale=True)
    got, want = _apply(
        jmod, port, x, **({"temb": t_emb} if temb else {}), zemb=zemb,
        torch_args=(nchw(x), torch.from_numpy(t_emb) if temb else None, torch.from_numpy(zemb)))
    assert np.std(want) > 0.05
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.mark.parametrize("mode,in_ch,out_ch,fir", [
    ("up", 16, 16, True), ("down", 16, 16, True), ("none", 24, 16, True),
    ("up", 16, 16, False), ("down", 16, 16, False)])
def test_oneadagn_resblock(mode, in_ch, out_ch, fir):
    x, temb, zemb = randn(5, 2, 8, 8, in_ch), randn(6, 2, 32), randn(7, 2, 12)
    jmod = jnn.ResnetBlockBigGANppAdagnOne(
        act=jax.nn.silu, out_ch=out_ch, up=mode == "up", down=mode == "down",
        dropout=0.0, fir=fir, fir_kernel=(1, 3, 3, 1), skip_rescale=True)
    port = pnn.ResnetBlockBigGANppAdagnOne(
        in_ch, out_ch, temb_dim=32, zemb_dim=12, up=mode == "up", down=mode == "down",
        dropout=0.0, fir=fir, fir_kernel=(1, 3, 3, 1), skip_rescale=True)
    assert isinstance(port.GroupNorm_1, pnn.GroupNorm)
    got, want = _apply(jmod, port, x, temb, zemb,
                       torch_args=(nchw(x), torch.from_numpy(temb), torch.from_numpy(zemb)))
    assert got.shape == nchw(want).shape and np.std(want) > 0.05
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.mark.parametrize("side", [4, 7])
def test_upsample_conv_2d_and_its_gradient(side):
    """f32, the (1, 3, 3, 1) FIR and a 3x3 weight: the output and the
    gradients of sum(out · r) with respect to x and w."""
    x, w = randn(8, 2, side, side, 5), randn(9, 3, 3, 5, 6) / np.float32(np.sqrt(45))
    r = randn(10, 2, 2 * side, 2 * side, 6)

    def jloss(x_, w_):
        out = jresample.upsample_conv_2d(x_, w_, k=(1, 3, 3, 1))
        return (out * jnp.asarray(r)).sum(), out

    (_, want), (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt = nchw(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).requires_grad_()
    out = resample.upsample_conv_2d(xt, wt, k=(1, 3, 3, 1))
    np.testing.assert_allclose(nhwc(out), np.asarray(want), **TOL)
    (out * nchw(r)).sum().backward()
    for got, ref in ((nhwc(xt.grad), np.asarray(jgx)),
                     (wt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(jgw))):
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_jax_netg_ckpt_with_buffers_loads_strictly(tmp_path):
    """A Fourier generator's `save_netg` (params and buffers) loads into the
    port with strict=True, W included, and gives the JAX output at t >= 1."""
    cfg = tiny_config(**chip_smoke().FAMILIES["pyramid_cat_fourier_one"])
    src = randomize_parameters_(NCSNpp.from_config(cfg), 6).eval()
    gen = JNCSNpp.from_config(cfg)
    variables = jax_variables(gen, cfg, src)
    assert "buffers" in variables
    jckpt.save_netg(tmp_path, 3, variables["params"], variables["buffers"])
    net = NCSNpp.from_config(cfg)
    net.load_state_dict(load_netg_ckpt(str(tmp_path / "netG_3.ckpt")), strict=True)
    assert torch.equal(net.all_modules[0].W, src.all_modules[0].W)
    x, t, z = randn(11, 2, 16, 16, 3), np.array([1, 2], np.int32), randn(12, 2, cfg.nz)
    want = np.asarray(gen.apply(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z)))
    with torch.no_grad():
        got = net.eval()(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(z))
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-4)
