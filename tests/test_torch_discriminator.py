"""The port's discriminators (`ddgan_torch.models.discriminator`) against the
JAX package's, on the CPU.

Both discriminators take the JAX package's parameters through
`compat.state_dict_from_flax` with a strict load. The parameters are
redrawn N(0,1)/sqrt(fan_in) with numpy (the init's `final_conv` of
DiscriminatorSmall is ~1e-10, which would make the output ~0 and the
comparison vacuous; each test guards the size of the output and of its
input gradient). DiscriminatorSmall
runs at the tiny config of `tests/test_train_step.py` (image 8, one
channel, ngf 4, t_emb_dim 8); DiscriminatorLarge at 64², its minimum (six
stride-2 stages). In float32 the outputs and the input gradients match
within 1e-4 of each tensor's largest magnitude (the same f32 sums in
another order); in bfloat16
both sides round at the same places and the outputs agree within 2e-2 of
their largest magnitude; the parameter gradients of D's update loss
(R1 included) are held against JAX's bf16 ones at the size of bf16 noise,
with JAX's f32 gradients as the control.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddgan_tpu.models import DiscriminatorLarge as JLarge
from ddgan_tpu.models import DiscriminatorSmall as JSmall
from ddgan_tpu.models.discriminator import minibatch_stddev as jminibatch_stddev

from ddgan_torch.compat import state_dict_from_flax
from ddgan_torch.models import (
    DiscriminatorLarge,
    DiscriminatorSmall,
    build_discriminator,
    get_model,
    minibatch_stddev,
)
from ddgan_torch.config import Config

from _torch_port import nchw, nhwc, one_torch_thread, randn, random_flax_params  # noqa: F401



def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())

# name -> (JAX class, port class, image side, batch)
CASES = {"small": (JSmall, DiscriminatorSmall, 8, 4), "large": (JLarge, DiscriminatorLarge, 64, 2)}
R1_GAMMA = 2.0  # the CelebA-HQ 256 recipe's


def make_pair(name, seed=0, jax_dtype=None, torch_dtype=None):
    """(JAX module, its random params, the port module loaded from them)."""
    jcls, cls, side, _ = CASES[name]
    jd = jcls(nc=2, ngf=4, t_emb_dim=8, dtype=jax_dtype)
    x = jnp.zeros((2, side, side, 1))
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), x, jnp.zeros((2,), jnp.int32), x)
    params = random_flax_params(shapes["params"], seed)
    disc = cls(nc=2, ngf=4, t_emb_dim=8, dtype=torch_dtype)
    disc.load_state_dict(state_dict_from_flax(params), strict=True)
    return jd, params, disc


def _inputs(name, seed):
    _, _, side, b = CASES[name]
    x, x_t = randn(seed, b, side, side, 1), randn(seed + 1, b, side, side, 1)
    t = np.arange(b, dtype=np.int32) % 2
    return x, t, x_t


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_output_and_input_grads_match_jax(name):
    jd, params, disc = make_pair(name)
    x, t, x_t = _inputs(name, 10)

    def f(x_, x_t_):
        return jd.apply({"params": params}, x_, jnp.asarray(t), x_t_)

    want = np.asarray(jax.jit(f)(jnp.asarray(x), jnp.asarray(x_t)))
    jgx, jgxt = jax.jit(jax.grad(lambda a, c: f(a, c).sum(), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(x_t))
    xt_, xtt_ = nchw(x).requires_grad_(True), nchw(x_t).requires_grad_(True)
    got = disc(xt_, torch.from_numpy(t).long(), xtt_)
    assert got.shape == (x.shape[0], 1) and got.dtype == torch.float32
    assert np.abs(want).max() > 0.1 and np.abs(np.asarray(jgx)).max() > 1e-7, \
        "weights are trivial: the comparison would be vacuous"
    assert rel_err(got.detach().numpy(), want) < 1e-4
    gx, gxt = torch.autograd.grad(got.sum(), (xt_, xtt_))
    assert rel_err(nhwc(gx), jgx) < 1e-4
    assert rel_err(nhwc(gxt), jgxt) < 1e-4


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_output_matches_jax(name):
    jd, params, disc = make_pair(name, seed=1, jax_dtype=jnp.bfloat16,
                                 torch_dtype=torch.bfloat16)
    x, t, x_t = _inputs(name, 20)
    want = np.asarray(jax.jit(lambda a, c: jd.apply({"params": params}, a, jnp.asarray(t), c))(
        jnp.asarray(x), jnp.asarray(x_t)))
    with torch.no_grad():
        got = disc(nchw(x), torch.from_numpy(t).long(), nchw(x_t))
    assert got.dtype == torch.float32 and all(p.dtype == torch.float32
                                              for p in disc.parameters())
    assert np.abs(want).max() > 0.1
    assert rel_err(got.numpy(), want) <= 2e-2


def _jax_update_grads(jd, params, x, t, x_t, x_f):
    """(loss, grads) of D's update loss in the JAX package: errD_real +
    errD_fake + the R1 penalty (gamma 2) by `jax.grad` of D's input."""
    def apply(p, a):
        return jd.apply({"params": p}, a, jnp.asarray(t), jnp.asarray(x_t)).reshape(-1).astype(
            jnp.float32)

    def loss(p):
        g = jax.grad(lambda a: apply(p, a).sum())(jnp.asarray(x))
        penalty = R1_GAMMA / 2 * (g.astype(jnp.float32).reshape(g.shape[0], -1) ** 2).sum(1).mean()
        return (jax.nn.softplus(-apply(p, jnp.asarray(x))).mean()
                + jax.nn.softplus(apply(p, jnp.asarray(x_f))).mean() + penalty)

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), state_dict_from_flax(jax.tree.map(np.asarray, grads))


def _port_update_grads(disc, x, t, x_t, x_f):
    """The same loss and its parameter gradients in the port, as
    `train.make_train_step` forms them."""
    tt, xt = torch.from_numpy(t).long(), nchw(x_t)
    xi = nchw(x).requires_grad_(True)
    d_real = disc(xi, tt, xt).reshape(-1).float()
    (g,) = torch.autograd.grad(d_real.sum(), xi, create_graph=True)
    penalty = R1_GAMMA / 2 * g.float().reshape(g.shape[0], -1).square().sum(1).mean()
    loss = (F.softplus(-d_real).mean() + F.softplus(disc(nchw(x_f), tt, xt).reshape(-1).float())
            .mean() + penalty)
    loss.backward(inputs=list(disc.parameters()))
    return float(loss.detach()), {k: p.grad for k, p in disc.named_parameters()}



@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_update_grads_match_jax(name):
    """D's parameter gradients of its update loss (errD_real + errD_fake +
    R1, a grad-of-grad) in bf16 against `jax.grad` of the same loss in the
    JAX package's bf16 D. The two sides round to bf16 at different places,
    so their gradients differ by bf16 noise, about as far as either is from
    float32; the control is the distance of JAX's f32 gradient from its
    bf16 one (relative L2: 2.9e-3 small, 2.3e-2 large). Bounds:
    - the loss within 1e-3 relative;
    - all tensors as one vector: the port's bf16 within 1.5× the control
      of JAX's bf16 (read: 3.3e-3, 2.5e-2), and at least half the control
      away from the port's own f32 (read: 3.0e-3, 2.1e-2), so a port that
      skipped the bf16 rounding fails;
    - each tensor: within 3× its own control plus 2e-3 (the head's bias,
      whose control happens to be ~1e-6)."""
    jd16, params, disc16 = make_pair(name, seed=3, jax_dtype=jnp.bfloat16,
                                     torch_dtype=torch.bfloat16)
    jd32, _, disc32 = make_pair(name, seed=3)
    x, t, x_t = _inputs(name, 40)
    x_f = randn(41, *x.shape)
    want_loss, want = _jax_update_grads(jd16, params, x, t, x_t, x_f)
    _, control = _jax_update_grads(jd32, params, x, t, x_t, x_f)
    got_loss, got = _port_update_grads(disc16, x, t, x_t, x_f)
    _, got32 = _port_update_grads(disc32, x, t, x_t, x_f)
    assert abs(got_loss - want_loss) <= 1e-3 * abs(want_loss)
    names = sorted(want)
    assert set(got) == set(names)

    def vec(d):
        return torch.cat([d[k].reshape(-1).float() for k in names])

    def rl2(a, b):
        return float((a - b).norm() / b.norm())

    g16, g32, w16, ctl = vec(got), vec(got32), vec(want), vec(control)
    assert float(w16.norm()) > 1e-2
    err, c = rl2(g16, w16), rl2(ctl, w16)
    assert err < 1.5 * c and rl2(g16, g32) > 0.5 * c, (err, c, rl2(g16, g32))
    for k in names:
        assert rl2(got[k].float(), want[k]) <= 3 * rl2(control[k], want[k]) + 2e-3, k


@pytest.mark.parametrize("batch,feat", [(2, 1), (4, 1), (8, 1), (8, 2), (6, 1)])
def test_minibatch_stddev_matches_jax(batch, feat):
    """Strided grouping (group = min(B, 4)), biased variance, f32 statistic."""
    x = randn(30 + batch, batch, 3, 5, 4)
    if batch % min(batch, 4):
        with pytest.raises(RuntimeError):
            minibatch_stddev(nchw(x), stddev_feat=feat)
        return
    want = np.asarray(jminibatch_stddev(jnp.asarray(x), stddev_feat=feat))
    got = minibatch_stddev(nchw(x), stddev_feat=feat)
    assert got.shape == (batch, 4 + feat, 3, 5)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-6)
    got16 = minibatch_stddev(nchw(x).to(torch.bfloat16), stddev_feat=feat)
    assert got16.dtype == torch.bfloat16
    want16 = np.asarray(jminibatch_stddev(jnp.asarray(x, jnp.bfloat16), stddev_feat=feat),
                        np.float32)
    np.testing.assert_array_equal(nhwc(got16), want16)


def test_registry_keys_and_build():
    assert get_model("discriminator_small") is DiscriminatorSmall
    assert get_model("discriminator_large") is DiscriminatorLarge
    keys = set(DiscriminatorLarge(nc=6, ngf=4, t_emb_dim=8).state_dict())
    for k in ("t_embed.main.0.weight", "t_embed.main.2.bias", "start_conv.weight",
              "conv1.conv1.0.weight", "conv1.dense_t1.weight", "conv1.skip.0.weight",
              "conv6.conv2.0.bias", "final_conv.weight", "end_linear.weight"):
        assert k in keys, k
    assert "conv1.skip.0.bias" not in keys
    cfg = Config(num_channels=3, ngf=4, t_emb_dim=8, compute_dtype="bfloat16", disc_small="no")
    a = build_discriminator(cfg, generator=torch.Generator().manual_seed(3))
    b = build_discriminator(cfg, generator=torch.Generator().manual_seed(3))
    assert isinstance(a, DiscriminatorLarge) and a.dtype == torch.bfloat16
    assert a.start_conv.weight.shape == (8, 6, 1, 1)
    assert a.final_conv.weight.shape == (32, 33, 3, 3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert isinstance(build_discriminator(cfg.replace(disc_small="yes")), DiscriminatorSmall)
