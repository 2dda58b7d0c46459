"""The port's legacy layer library (`ddgan_torch/nn/legacy.py`), its fused
bias-activation ops (`ops/fused_act.py`) and its registry helpers
(`models/registry.py`) against the JAX package's, on the CPU.

Each block is built in the port with N(0,1)/sqrt(fan_in) weights
(`randomize_parameters_`), its weights carried into the JAX block's
parameter tree (NCHW <-> NHWC, OIHW <-> HWIO), and both run on the same
input: max-abs within 1e-5 of max|ref| in f32. The numpy helpers are
equal to the last bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddgan_tpu.models import registry as jregistry
from ddgan_tpu.nn import legacy as jlegacy
from ddgan_tpu.ops import fused_act as jfused

from ddgan_torch.models import NCSNpp, create_model, get_ddpm_params, get_model_fn, get_sigmas
from ddgan_torch.nn import legacy
from ddgan_torch.nn.layers import Conv2d
from ddgan_torch.ops import fused_act
from ddgan_torch.utils import randomize_parameters_

from _torch_port import nchw, nhwc, one_torch_thread, randn, tiny_config  # noqa: F401

K = jax.random.PRNGKey(0)


def _flax_params(module: torch.nn.Module) -> dict:
    """The port block's parameters as the JAX block's tree: a ModuleList
    index joins its list's name (`convs.0` -> `convs_0`), a conv gains the
    JAX package's "conv" wrapper, and leaves take flax's names and layouts."""
    tree: dict = {}
    for key, p in module.named_parameters():
        parts = key.split(".")
        owner = module.get_submodule(".".join(parts[:-1]))
        path: list[str] = []
        for seg in parts[:-1]:
            if seg.isdigit():
                path[-1] = f"{path[-1]}_{seg}"
            else:
                path.append(seg)
        if isinstance(owner, Conv2d):
            path.append("conv")
        arr = p.detach().numpy()
        leaf = parts[-1]
        if leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
        elif leaf == "weight":
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = tree
        for seg in path:
            node = node.setdefault(seg, {})
        node[leaf] = jnp.asarray(np.ascontiguousarray(arr))
    return tree


def _same(port_block, jax_block, *inputs, seed=0, shape=None):
    """Run both blocks on NCHW/NHWC copies of `inputs` (4-D arrays are
    images; others pass as they are) with the port's weights; with `shape`,
    as block([inputs...], shape), the multi-input blocks' call."""
    randomize_parameters_(port_block, seed).eval()
    j_in = [jnp.asarray(a) for a in inputs]
    t_in = [nchw(a) if np.ndim(a) == 4 else torch.from_numpy(np.asarray(a)) for a in inputs]
    if shape is not None:
        j_in, t_in = [j_in, shape], [t_in, shape]
    template = jax_block.init({"params": K, "dropout": K}, *j_in)["params"]
    params = _flax_params(port_block)
    flat_t = jax.tree_util.tree_flatten_with_path(template)[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert {k for k, _ in flat_t} == set(flat_p)
    for k, v in flat_t:
        assert flat_p[k].shape == v.shape, k
    want = np.asarray(jax_block.apply({"params": params}, *j_in))
    with torch.no_grad():
        got = port_block(*t_in)
    got = nhwc(got) if got.ndim == 4 else got.numpy()
    assert got.shape == want.shape and np.isfinite(want).all()
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    assert float(np.abs(got - want).max()) <= 1e-5 * scale
    return got


X = randn(0, 2, 8, 8, 16)  # NHWC


@pytest.mark.parametrize("maxpool", [True, False])
def test_crp_block(maxpool):
    _same(legacy.CRPBlock(16, 2, maxpool=maxpool), jlegacy.CRPBlock(16, 2, maxpool=maxpool), X)


def test_rcu_block():
    _same(legacy.RCUBlock(16, 2, 2), jlegacy.RCUBlock(16, 2, 2), X)


@pytest.mark.parametrize("block", ["msf", "refine", "refine_end_avgpool", "refine_single"])
def test_msf_and_refine_blocks(block):
    xs = [X, randn(1, 2, 4, 4, 8)]
    port, jax_ = {
        "msf": (legacy.MSFBlock([16, 8], 12), jlegacy.MSFBlock(12)),
        "refine": (legacy.RefineBlock([16, 8], 12), jlegacy.RefineBlock(12)),
        "refine_end_avgpool": (legacy.RefineBlock([16, 8], 12, end=True, maxpool=False),
                               jlegacy.RefineBlock(12, end=True, maxpool=False)),
        "refine_single": (legacy.RefineBlock([16], 16, start=True),
                          jlegacy.RefineBlock(16, start=True)),
    }[block]
    _same(port, jax_, *(xs[:1] if block == "refine_single" else xs), shape=(8, 8))


def test_resize_bilinear_is_align_corners():
    x = randn(2, 2, 3, 5, 4)
    want = np.asarray(jlegacy._resize_bilinear(jnp.asarray(x), (7, 9)))
    got = nhwc(legacy._resize_bilinear(nchw(x), (7, 9)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert legacy._resize_bilinear(nchw(x), (3, 5)).shape == (2, 4, 3, 5)


@pytest.mark.parametrize("adjust_padding", [False, True])
def test_pool_convs(adjust_padding):
    # the (1, 0, 1, 0) pad makes an odd side even, as the mean pool needs
    x = randn(14, 2, 7, 7, 16) if adjust_padding else X
    _same(legacy.ConvMeanPool(16, 8, adjust_padding=adjust_padding),
          jlegacy.ConvMeanPool(8, adjust_padding=adjust_padding), x)
    _same(legacy.MeanPoolConv(16, 8), jlegacy.MeanPoolConv(8), X)
    _same(legacy.UpsampleConv(16, 8), jlegacy.UpsampleConv(8), X)


@pytest.mark.parametrize("out,resample,dilation", [
    (16, None, 1), (24, None, 1), (24, "down", 1), (16, None, 2), (24, "down", 2)])
def test_residual_block(out, resample, dilation):
    if dilation > 1:  # JAX's pad 1 with dilation 2 trims each conv's output by 2
        x = randn(3, 2, 12, 12, 16)
    else:
        x = X
    try:
        want_err = None
        jlegacy.ResidualBlock(out, resample=resample, dilation=dilation).init(K, jnp.asarray(x))
    except Exception as e:  # the JAX block's own shape error, if any
        want_err = type(e)
    port = legacy.ResidualBlock(16, out, resample=resample, dilation=dilation)
    if want_err is not None:
        with pytest.raises(Exception):
            port(nchw(x))
        return
    _same(port, jlegacy.ResidualBlock(out, resample=resample, dilation=dilation), x)


def test_ddpm_blocks():
    x32 = randn(4, 1, 4, 4, 32)
    _same(legacy.AttnBlock(32), jlegacy.AttnBlock(), x32)
    for with_conv in (True, False):
        if with_conv:
            _same(legacy.UpsampleDDPM(32, with_conv), jlegacy.UpsampleDDPM(32, with_conv), x32)
            _same(legacy.DownsampleDDPM(32, with_conv), jlegacy.DownsampleDDPM(32, with_conv),
                  x32)
        else:  # no parameters: the functions alone
            got = nhwc(legacy.UpsampleDDPM(32)(nchw(x32)))
            np.testing.assert_array_equal(got, np.asarray(jlegacy.UpsampleDDPM(32).apply(
                {}, jnp.asarray(x32))))
            got = nhwc(legacy.DownsampleDDPM(32)(nchw(x32)))
            np.testing.assert_allclose(got, np.asarray(jlegacy.DownsampleDDPM(32).apply(
                {}, jnp.asarray(x32))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("out_ch,conv_shortcut,temb", [
    (64, False, True), (64, True, True), (32, False, False)])
def test_resnet_block_ddpm(out_ch, conv_shortcut, temb):
    x32 = randn(5, 2, 4, 4, 32)
    extra = [randn(6, 2, 16)] if temb else []
    port = legacy.ResnetBlockDDPM(torch.nn.functional.silu, 32, out_ch,
                                  temb_dim=16 if temb else None, conv_shortcut=conv_shortcut)
    _same(port, jlegacy.ResnetBlockDDPM(act=jax.nn.silu, out_ch=out_ch,
                                        conv_shortcut=conv_shortcut), x32, *extra)


@pytest.mark.parametrize("name", ["elu", "relu", "lrelu", "swish"])
def test_get_act(name):
    x = randn(7, 64)
    np.testing.assert_allclose(legacy.get_act(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(jlegacy.get_act(name)(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


def test_get_act_unknown_raises():
    with pytest.raises(NotImplementedError):
        legacy.get_act("nope")


@pytest.mark.parametrize("act,scale,bias", [
    ("lrelu", None, True), ("lrelu", 1.0, False), ("linear", None, True), ("linear", 3.0, True)])
def test_fused_bias_act(act, scale, bias):
    x, b = randn(8, 2, 5, 6, 4), randn(9, 4)
    want = np.asarray(jfused.fused_bias_act(jnp.asarray(x), jnp.asarray(b) if bias else None,
                                            act=act, alpha=0.2, scale=scale))
    got = fused_act.fused_bias_act(nchw(x), torch.from_numpy(b) if bias else None, act=act,
                                   alpha=0.2, scale=scale)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        fused_act.fused_bias_act(nchw(x), act="gelu")


def test_fused_leaky_relu_2d_and_grad():
    x, b = randn(10, 3, 7), randn(11, 7)
    want = np.asarray(jfused.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    xt = torch.from_numpy(x).requires_grad_()
    got = fused_act.fused_leaky_relu(xt, torch.from_numpy(b))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    got.sum().backward()
    jg = jax.grad(lambda v: jfused.fused_leaky_relu(v, jnp.asarray(b)).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sigma_max,sigma_min,num_scales", [(50.0, 0.01, 10), (378.0, 0.01, 1000)])
def test_get_sigmas_bit_equal(sigma_max, sigma_min, num_scales):
    cfg = types.SimpleNamespace(sigma_max=sigma_max, sigma_min=sigma_min, num_scales=num_scales)
    got, want = get_sigmas(cfg), jregistry.get_sigmas(cfg)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("beta_min,beta_max,num_scales", [(0.1, 20.0, 1000), (0.01, 5.0, 250)])
def test_get_ddpm_params_bit_equal(beta_min, beta_max, num_scales):
    cfg = types.SimpleNamespace(beta_min=beta_min, beta_max=beta_max, num_scales=num_scales)
    got, want = get_ddpm_params(cfg), jregistry.get_ddpm_params(cfg)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_create_model_and_model_fn():
    cfg = types.SimpleNamespace(**tiny_config().to_dict(), name="ncsnpp")
    net = create_model(cfg, generator=torch.Generator().manual_seed(0))
    assert isinstance(net, NCSNpp)
    assert jregistry.get_model(cfg.name).__name__ == "NCSNpp"
    randomize_parameters_(net, 1)
    x, t = nchw(randn(12, 2, 16, 16, 3)), torch.tensor([0, 3])
    z = torch.from_numpy(randn(13, 2, cfg.nz))
    with torch.no_grad():
        out = get_model_fn(net, train=False)(x, t, z)
        assert not net.training
        want = net.eval()(x, t, z)
        assert torch.equal(out, want)
        get_model_fn(net, train=True)(x, t, z)
        assert net.training
