"""The port's train step (`ddgan_torch.train`) against the JAX package's
functions composed under `jax.value_and_grad`, on the CPU.

The model is the tiny flagship config (`_flagship_config(tiny=True)`:
NCSN++ image 16, nf 16, ch_mult [1, 2], 1 resblock, attention at 8, T=4;
DiscriminatorSmall ngf 8), batch 4, dropout 0, r1_gamma 1, lazy_reg 2.
G's weights are redrawn with `randomize_parameters_` and carried to JAX;
D's are drawn on the JAX tree and carried to the port through
`state_dict_from_flax`. t, z and every noise come from numpy seeds and are
injected on both sides (`draws` in the port, the `*_with_noise` functions
in JAX). The JAX reference is the composition the JAX step makes:
`q_sample_pairs_with_noise`, `gen.apply`, `sample_posterior_with_noise`,
`disc.apply`, the R1 penalty by `jax.grad` of D's input, `make_optimizer`
(clip, Adam), `apply_lr` and `ema_update`, over two steps: step 0 with R1
and step 1 without.

Bounds: losses and penalty within 1e-4 relative, each gradient tensor
within 1e-4 of its own largest magnitude (the same f32 sums in another
order, through a grad-of-grad), parameters and the EMA within 1e-5
absolute (1% of lr 1e-3). Adam's first steps move a parameter by
lr · g / (|g| + 1e-8): a gradient near 1e-8 (some of D's are ~1e-9 here)
turns a 1e-6 relative difference in g into a few 1e-6 in the parameter,
and that reaches the next losses at ~1e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddgan_tpu.diffusion import DiffusionCoefficients as JCoeff
from ddgan_tpu.diffusion import PosteriorCoefficients as JPos
from ddgan_tpu.diffusion import q_sample as jq_sample
from ddgan_tpu.diffusion import q_sample_pairs_with_noise as jq_pairs
from ddgan_tpu.diffusion import sample_posterior_with_noise as jposterior
from ddgan_tpu.models import DiscriminatorSmall as JSmall
from ddgan_tpu.models import NCSNpp as JNCSNpp
from ddgan_tpu.train import cosine_lr as jcosine_lr
from ddgan_tpu.train import make_optimizer as jmake_optimizer
from ddgan_tpu.train.ema import ema_update as jema_update
from ddgan_tpu.train.optim import apply_lr

from ddgan_torch.compat import state_dict_from_flax
from ddgan_torch.diffusion import (
    DiffusionCoefficients,
    PosteriorCoefficients,
    q_sample,
    q_sample_pairs,
    q_sample_pairs_with_noise,
)
from ddgan_torch.models import DiscriminatorLarge, DiscriminatorSmall, NCSNpp
from ddgan_torch.ops import fir2x, pair_conv
from ddgan_torch.train import (
    ClippedAdam,
    StepDraws,
    cosine_lr,
    create_train_state,
    draw_step,
    ema_update,
    make_train_step,
)
from ddgan_torch.utils import randomize_parameters_

from _torch_port import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    celeba256_config,
    chip_smoke,
    count_pallas_calls,
    flax_params_from_port,
    nchw,
    nhwc,
    one_torch_thread,
    randn,
    random_flax_params,
    tiny_config,
)

B = 4
LR = 1e-3
R1_GAMMA = 1.0
LAZY_REG = 2
EMA = 0.9


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _np_draws(cfg, seed):
    rs = np.random.RandomState(seed)
    shape = (B, cfg.image_size, cfg.image_size, cfg.num_channels)
    out = []
    for _ in range(2):
        out += [rs.randint(0, cfg.num_timesteps, B).astype(np.int32),
                rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32),
                rs.randn(B, cfg.nz).astype(np.float32), rs.randn(*shape).astype(np.float32)]
    return out


def _torch_draws(np_draws) -> StepDraws:
    return StepDraws(*[torch.from_numpy(a).long() if a.ndim == 1 else
                       (nchw(a) if a.ndim == 4 else torch.from_numpy(a)) for a in np_draws])


@pytest.fixture(scope="module")
def world():
    """The tiny models with shared random weights, the batch, two steps'
    draws, and the JAX reference of those two steps."""
    return _world(tiny_config(dropout=0.0))


@pytest.fixture(scope="module", params=["pyramid_sum", "ddpm_fir"])
def family_world(request):
    """`world` for a generator option family of `chip_smoke.FAMILIES`."""
    return _world(tiny_config(dropout=0.0, **chip_smoke().FAMILIES[request.param]))


def _world(cfg):
    jgen = JNCSNpp.from_config(cfg)
    jdisc = JSmall(nc=2 * cfg.num_channels, ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim)
    s = cfg.image_size
    x0 = jnp.zeros((2, s, s, cfg.num_channels))
    t0 = jnp.zeros((2,), jnp.int32)
    g_shapes = jax.eval_shape(lambda: jgen.init({"params": jax.random.PRNGKey(0),
                                                 "dropout": jax.random.PRNGKey(0)},
                                                x0, t0, jnp.zeros((2, cfg.nz))))
    gen = randomize_parameters_(NCSNpp.from_config(cfg), seed=0)
    params_G = flax_params_from_port(
        gen, jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), g_shapes))
    d_shapes = jax.eval_shape(jdisc.init, jax.random.PRNGKey(0), x0, t0, x0)["params"]
    params_D = random_flax_params(d_shapes, seed=1)
    real = np.random.RandomState(2).uniform(-1, 1, (B, s, s, cfg.num_channels)).astype(
        np.float32)
    draws = [_np_draws(cfg, 10), _np_draws(cfg, 11)]
    ref = _jax_two_steps(cfg, jgen, jdisc, params_G, jax.tree.map(jnp.asarray, params_D),
                         jnp.asarray(real), draws)
    return cfg, gen.state_dict(), state_dict_from_flax(params_D), real, draws, ref


def _jax_two_steps(cfg, jgen, jdisc, params_G, params_D, real, draws):
    """The JAX package's step composed from its functions, at steps 0 and 1.
    The R1 branch is one compiled function for both steps: its penalty is
    scaled by 1 on the R1 step and by 0 (an exact zero, gradient included)
    on the other."""
    coeff = JCoeff.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max)
    pos = JPos.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max)
    tx_d = jmake_optimizer(cfg.beta1_d, cfg.beta2_d, 0.0, cfg.grad_clip_norm)
    tx_g = jmake_optimizer(cfg.beta1_g, cfg.beta2_g, 0.0, cfg.grad_clip_norm)
    clip = optax.clip_by_global_norm(cfg.grad_clip_norm)
    b = real.shape[0]

    def apply_G(p, x, t, z):
        return jgen.apply({"params": p}, x, t, z, train=True)

    def apply_D(p, x, t, x_t):
        return jdisc.apply({"params": p}, x, t, x_t).reshape(-1).astype(jnp.float32)

    @jax.jit
    def d_step(r1_on, pD, opt_D, pG, t, nq, nn, z, npost):
        x_t, x_tp1 = jq_pairs(coeff, real, t, nq, nn)
        x_pos = jposterior(pos, apply_G(pG, x_tp1, t, z), x_tp1, t, npost)

        def loss(p):
            errD_fake = jax.nn.softplus(apply_D(p, x_pos, t, x_tp1)).mean()
            errD_real = jax.nn.softplus(-apply_D(p, x_t, t, x_tp1)).mean()
            g = jax.grad(lambda xi: apply_D(p, xi, t, x_tp1).sum())(x_t)
            penalty = r1_on * R1_GAMMA / 2.0 * (g.reshape(b, -1) ** 2).sum(axis=1).mean()
            return errD_real + errD_fake + penalty, (errD_real, errD_fake, penalty)

        (_, aux), grads = jax.value_and_grad(loss, has_aux=True)(pD)
        upd, opt_D = tx_d.update(grads, opt_D, pD)
        return optax.apply_updates(pD, apply_lr(upd, LR)), opt_D, aux, clip.update(grads, None)[0]

    @jax.jit
    def g_step(pG, opt_G, ema, pD, t, nq, nn, z, npost):
        _, x_tp1 = jq_pairs(coeff, real, t, nq, nn)

        def loss(p):
            x_pos = jposterior(pos, apply_G(p, x_tp1, t, z), x_tp1, t, npost)
            return jax.nn.softplus(-apply_D(pD, x_pos, t, x_tp1)).mean()

        errG, grads = jax.value_and_grad(loss)(pG)
        upd, opt_G = tx_g.update(grads, opt_G, pG)
        pG = optax.apply_updates(pG, apply_lr(upd, LR))
        return pG, opt_G, jema_update(ema, pG, EMA), errG, clip.update(grads, None)[0]

    opt_D, opt_G, ema = tx_d.init(params_D), tx_g.init(params_G), params_G
    steps = []
    for i, dr in enumerate(draws):
        dr = [jnp.asarray(a) for a in dr]
        r1_on = jnp.float32(i % LAZY_REG == 0)
        params_D, opt_D, (errD_real, errD_fake, penalty), gD = d_step(
            r1_on, params_D, opt_D, params_G, *dr[:5])
        params_G, opt_G, ema, errG, gG = g_step(params_G, opt_G, ema, params_D, *dr[5:])
        steps.append(jax.tree.map(np.asarray, dict(
            errD_real=errD_real, errD_fake=errD_fake, grad_penalty=penalty, errG=errG,
            gD=gD, gG=gG, params_G=params_G, params_D=params_D, ema=ema)))
    return steps


def _port_state(cfg, g_sd, d_sd, r1_shared="auto", update_g=True):
    gen = NCSNpp.from_config(cfg)
    gen.load_state_dict(g_sd, strict=True)
    disc = DiscriminatorSmall(nc=2 * cfg.num_channels, ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim)
    disc.load_state_dict(d_sd, strict=True)
    state = create_train_state(
        gen, disc,
        ClippedAdam(gen.parameters(), cfg.beta1_g, cfg.beta2_g, 0.0, cfg.grad_clip_norm),
        ClippedAdam(disc.parameters(), cfg.beta1_d, cfg.beta2_d, 0.0, cfg.grad_clip_norm),
    )
    step = make_train_step(
        DiffusionCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max, device="cpu"),
        PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max, device="cpu"),
        num_timesteps=cfg.num_timesteps, nz=cfg.nz, r1_gamma=R1_GAMMA, lazy_reg=LAZY_REG,
        ema_decay=EMA, use_ema=True, update_g=update_g, r1_shared=r1_shared,
    )
    return state, step


def _grads(module):
    return {k: p.grad for k, p in module.named_parameters()}


def _assert_tree_close(port: dict, jax_tree, bound, what):
    """Each tensor within `bound` absolute, or with bound "rel" within 1e-4 of
    its largest magnitude; a gradient that is zero in exact arithmetic (the
    attention key's bias: softmax ignores a shift) is rounding noise on both
    sides and is held below 1e-10 of the tree's largest gradient instead."""
    want = state_dict_from_flax(jax_tree)
    assert set(port) == set(want), what
    floor = 1e-10 * max(float(v.abs().max()) for v in want.values())
    for k, v in port.items():
        if bound != "rel":
            assert float((v.detach() - want[k]).abs().max()) <= bound, (what, k)
        elif float(want[k].abs().max()) < floor:
            assert float(v.abs().max()) < 10 * floor, (what, k)
        else:
            assert rel_err(v.detach().numpy(), want[k].numpy()) < 1e-4, (what, k)


@pytest.mark.parametrize("r1_shared", ["yes", "no"])
def test_two_steps_match_jax(world, r1_shared):
    """Step 0 (R1) and step 1 (no R1): losses, penalty, D and G gradients,
    parameters and EMA; the shared and the recomputed R1 forward both."""
    cfg, g_sd, d_sd, real, draws, ref = world
    state, step = _port_state(cfg, g_sd, d_sd, r1_shared)
    for i, (dr, want) in enumerate(zip(draws, ref)):
        m = step(state, nchw(real), None, LR, LR, draws=_torch_draws(dr))
        assert state.step == i + 1
        for name in ("errD_real", "errD_fake", "errG", "grad_penalty"):
            assert abs(float(getattr(m, name)) - want[name]) <= 1e-4 * abs(want[name]), name
        assert float(m.errD) == pytest.approx(want["errD_real"] + want["errD_fake"], rel=1e-4)
        assert (want["grad_penalty"] > 0) == (i == 0)
        _assert_tree_close(_grads(state.disc), want["gD"], "rel", f"D grads, step {i}")
        _assert_tree_close(_grads(state.gen), want["gG"], "rel", f"G grads, step {i}")
        _assert_tree_close(dict(state.disc.named_parameters()), want["params_D"], 1e-5, "D")
        _assert_tree_close(dict(state.gen.named_parameters()), want["params_G"], 1e-5, "G")
        _assert_tree_close(state.ema_G, want["ema"], 1e-5, "EMA")


def test_family_two_steps_match_jax(family_world):
    """`test_two_steps_match_jax` for the output and input pyramids (sum) and
    for DDPM resblocks with FIR resampling and no tanh: step 0 with R1, step
    1 without; losses, penalty, gradients and the EMA at its bounds. The
    parameters are held at 1e-5 wherever G's step-0 gradient is at least
    1e-4 of its tensor's largest: below that the gradient bound (1e-4 of
    the largest) does not fix the sign-like first Adam step lr·g/(|g| + 1e-8),
    and those elements are held within 3·lr, the most two Adam steps move
    them."""
    cfg, g_sd, d_sd, real, draws, ref = family_world
    state, step = _port_state(cfg, g_sd, d_sd)
    g0 = state_dict_from_flax(ref[0]["gG"])
    for i, (dr, want) in enumerate(zip(draws, ref)):
        m = step(state, nchw(real), None, LR, LR, draws=_torch_draws(dr))
        for name in ("errD_real", "errD_fake", "errG", "grad_penalty"):
            assert abs(float(getattr(m, name)) - want[name]) <= 1e-4 * abs(want[name]), name
        assert (want["grad_penalty"] > 0) == (i == 0)
        _assert_tree_close(_grads(state.disc), want["gD"], "rel", f"D grads, step {i}")
        _assert_tree_close(_grads(state.gen), want["gG"], "rel", f"G grads, step {i}")
        _assert_tree_close(dict(state.disc.named_parameters()), want["params_D"], 1e-5, "D")
        _assert_tree_close(state.ema_G, want["ema"], 1e-5, "EMA")
        params_G = state_dict_from_flax(want["params_G"])
        for k, p in state.gen.named_parameters():
            determined = g0[k].abs() >= 1e-4 * g0[k].abs().max()
            err = (p.detach() - params_G[k]).abs()
            assert float(err[determined].max()) <= 1e-5, (i, k)
            assert float(err.max()) <= 3 * LR, (i, k)


def test_update_g_false_updates_d_only(world):
    cfg, g_sd, d_sd, real, draws, ref = world
    state, step = _port_state(cfg, g_sd, d_sd, update_g=False)
    ema0 = {k: v.clone() for k, v in state.ema_G.items()}
    m = step(state, nchw(real), None, LR, LR, draws=_torch_draws(draws[0]))
    assert float(m.errG) == 0.0 and state.step == 1
    assert abs(float(m.errD_real) - ref[0]["errD_real"]) <= 1e-4 * ref[0]["errD_real"]
    _assert_tree_close(dict(state.disc.named_parameters()), ref[0]["params_D"], 1e-5, "D")
    for k, p in state.gen.named_parameters():
        assert torch.equal(p.detach(), g_sd[k]) and torch.equal(state.ema_G[k], ema0[k]), k
        assert p.grad is None, k


def test_seeded_steps_repeat_with_dropout():
    """Draws and dropout masks come from the step's generator: two runs
    from one seed (dropout 0.1) end on the same parameters; another seed
    does not."""
    cfg = tiny_config(dropout=0.1)

    def run(seed):
        torch.manual_seed(123 + seed)  # the default generators must not matter
        gen = NCSNpp.from_config(cfg, generator=torch.Generator().manual_seed(0))
        disc = DiscriminatorSmall(nc=6, ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim)
        disc.init_weights(torch.Generator().manual_seed(1))
        state = create_train_state(gen, disc, ClippedAdam(gen.parameters(), 0.5, 0.9),
                                   ClippedAdam(disc.parameters(), 0.5, 0.9))
        step = make_train_step(
            DiffusionCoefficients.create(4, 0.1, 20.0, device="cpu"),
            PosteriorCoefficients.create(4, 0.1, 20.0, device="cpu"),
            num_timesteps=4, nz=cfg.nz, r1_gamma=0.02, lazy_reg=15, ema_decay=0.99,
            use_ema=True)
        rng = torch.Generator().manual_seed(seed)
        real = torch.rand((B, 3, 16, 16), generator=torch.Generator().manual_seed(5)) * 2 - 1
        ms = [step(state, real, rng, LR, LR) for _ in range(2)]
        return [float(m.errG) for m in ms], torch.cat([p.detach().reshape(-1)
                                                      for p in gen.parameters()])

    (l1, p1), (l2, p2), (l3, p3) = run(0), run(0), run(1)
    assert l1 == l2 and torch.equal(p1, p2)
    assert l1 != l3 and not torch.equal(p1, p3)
    d = draw_step(torch.zeros(2, 3, 8, 8), 4, 5, torch.Generator().manual_seed(0))
    assert d.t.dtype == torch.int64 and d.z.shape == (2, 5) and d.noise_post_g.shape == (2, 3, 8, 8)


@pytest.mark.parametrize("case", ["flagship_structure", "celeba256_structure",
                                  "pyramid_sum", "ddpm_fir"])
def test_fir_calls_by_role_follow_the_chip_smoke_formula(case):
    """The FIR Functions' calls per step by pattern and order, on an R1 and a
    non-R1 step, are the counts `chip_smoke.py` asserts on the GPU: the
    tiny flagship (DiscriminatorSmall, R1 recomputed below 256²), alone and
    with the option families `pyramid_sum` (the pyramids' up2x and down2x;
    no backward for the input pyramid's, which acts on x_{t+1}) and
    `ddpm_fir` (one call per DDPM Upsample / Downsample), and the six
    CelebA-HQ 256 levels at image 64 with DiscriminatorLarge and the shared
    R1 forward."""
    smoke = chip_smoke()
    family = {}
    if case != "celeba256_structure":
        family = smoke.FAMILY_FIR.get(case, {})
        cfg = tiny_config(**smoke.FAMILIES.get(case, {}))
        disc = DiscriminatorSmall(nc=6, ngf=4, t_emb_dim=cfg.t_emb_dim)
        shared, b = "auto", 4
    else:
        cfg = celeba256_config(tiny=True)
        disc = DiscriminatorLarge(nc=6, ngf=2, t_emb_dim=cfg.t_emb_dim)
        shared, b = "yes", 2
    gen = NCSNpp.from_config(cfg)
    state = create_train_state(gen, disc, ClippedAdam(gen.parameters(), 0.5, 0.9),
                               ClippedAdam(disc.parameters(), 0.5, 0.9))
    step = make_train_step(
        DiffusionCoefficients.create(cfg.num_timesteps, 0.1, 20.0, device="cpu"),
        PosteriorCoefficients.create(cfg.num_timesteps, 0.1, 20.0, device="cpu"),
        num_timesteps=cfg.num_timesteps, nz=cfg.nz, r1_gamma=1.0, lazy_reg=2, ema_decay=0.9,
        use_ema=True, r1_shared=shared)
    real = torch.zeros((b, 3, cfg.image_size, cfg.image_size))
    rng = torch.Generator().manual_seed(0)
    n_g = len(cfg.ch_mult) - 1
    for r1 in (True, False):
        fir2x.reset_launch_counts()
        step(state, real, rng, LR, LR)
        n_d = sum(getattr(disc, f"conv{i}").downsample for i in range(1, disc.n_blocks + 1))
        want = smoke.expected_fir_calls(n_d, n_g, r1, shared == "yes", **family)
        assert fir2x.CALLS == want, (case, r1)
    assert fir2x.LAUNCHES == {"down2x": 0, "up2x": 0}


@pytest.mark.parametrize("geometric,beta_min,beta_max", [(False, 0.1, 20.0), (True, 0.01, 0.5)])
def test_forward_process_matches_jax(geometric, beta_min, beta_max):
    """The forward-process tables equal JAX's; q_sample and the training
    pairs with injected noise match it; q_sample_pairs draws its two noises
    from its generator, in order."""
    ours = DiffusionCoefficients.create(4, beta_min, beta_max, geometric, device="cpu")
    theirs = JCoeff.create(4, beta_min, beta_max, geometric)
    for field in ("sigmas", "a_s", "a_s_cum", "sigmas_cum", "a_s_prev"):
        a = getattr(ours, field)
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(theirs, field)), field)
    x0, nq, nn = randn(20, 4, 8, 8, 3), randn(21, 4, 8, 8, 3), randn(22, 4, 8, 8, 3)
    t = np.array([0, 1, 2, 3])
    tt = torch.from_numpy(t)
    want = jq_pairs(theirs, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(nq), jnp.asarray(nn))
    got = q_sample_pairs_with_noise(ours, nchw(x0), tt, nchw(nq), nchw(nn))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        nhwc(q_sample(ours, nchw(x0), tt, nchw(nq))),
        np.asarray(jq_sample(theirs, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(nq))),
        rtol=1e-6, atol=1e-6)
    rng = torch.Generator().manual_seed(3)
    n1, n2 = (torch.randn((4, 3, 8, 8), generator=rng) for _ in range(2))
    drawn = q_sample_pairs(ours, nchw(x0), tt, torch.Generator().manual_seed(3))
    for g, w in zip(drawn, q_sample_pairs_with_noise(ours, nchw(x0), tt, n1, n2)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("epoch,num_epoch", [(0, 10), (3, 10), (5, 10), (10, 10), (12, 10),
                                             (0, 0), (4, -1)])
def test_cosine_lr_matches_jax(epoch, num_epoch):
    got = cosine_lr(3e-4, epoch, num_epoch)
    assert got == pytest.approx(float(jcosine_lr(3e-4, epoch, num_epoch)), rel=1e-6)


@pytest.mark.parametrize("wd,clip", [(0.0, 1.0), (0.01, 1.0), (0.01, 100.0), (0.0, None)])
def test_optimizer_matches_optax(wd, clip):
    """Clip by global norm (above and below the threshold), L2 into the
    gradient, Adam with eps 1e-8, -lr: three steps with fresh gradients."""
    rs = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (2, 2, 3, 3)]
    params = [torch.nn.Parameter(torch.from_numpy(rs.randn(*s).astype(np.float32)))
              for s in shapes]
    jparams = [jnp.array(p.detach().numpy().copy()) for p in params]  # no shared buffer
    tx = jmake_optimizer(0.5, 0.9, wd, clip)
    jstate = tx.init(jparams)
    opt = ClippedAdam(params, 0.5, 0.9, wd, clip)
    for i in range(3):
        grads = [rs.randn(*s).astype(np.float32) * 2.0 for s in shapes]
        opt.zero_grad()
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step(1e-2 * (i + 1))
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, apply_lr(upd, 1e-2 * (i + 1)))
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_ema_update_matches_jax():
    net = randomize_parameters_(torch.nn.Linear(3, 4), seed=0)
    ema = {k: torch.from_numpy(randn(1 + i, *p.shape)) for i, (k, p) in
           enumerate(net.named_parameters())}
    want = jema_update({k: jnp.array(v.numpy().copy()) for k, v in ema.items()},
                       {k: jnp.array(p.detach().numpy().copy())
                        for k, p in net.named_parameters()}, 0.999)
    ema_update(ema, net, 0.999)
    for k, v in ema.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_bf16_gated_generator_grads_match_jax_pallas(monkeypatch):
    """Image 128, nf 64, ch_mult [1, 2], 1 resblock, batch 1, bf16: the
    128² level passes K2's gate. The JAX package runs its Pallas conv and
    its custom VJP (DDGAN_TPU_PALLAS_CONV=1, s2d off, interpret mode); the
    port routes the same convs, and the same dx convs, to `pair_conv3x3`.

    The two sides round to bf16 at different places (XLA fuses elementwise
    chains and rounds once), so their bf16 gradients differ by bf16 noise,
    about as far as either is from float32. The control is the port's f32
    gradient (equal to JAX's f32 within 1e-4, `test_two_steps_match_jax`),
    whose distance from JAX's bf16 gradient is the size of that noise
    (3.4e-2 relative L2 here). G's parameter gradients of sum(G(x) · r):
    - all tensors as one vector: the port's bf16 within 1.5× the control
      of JAX's bf16 (read: 2.9e-2 against 3.4e-2), and at least half the
      control away from the port's own f32 (read: 2.3e-2), so a port that
      skipped the bf16 rounding fails;
    - each tensor: within 3× its own control plus 1e-2 (the attention
      key's bias has a true gradient of 0 and is rounding noise on both
      sides)."""
    monkeypatch.setenv("DDGAN_TPU_PALLAS_CONV", "1")
    monkeypatch.setenv("DDGAN_TPU_S2D_CONV", "0")
    cfg = tiny_config(image_size=128, num_channels_dae=64, ch_mult=[1, 2],
                      num_res_blocks=1, compute_dtype="bfloat16")
    jgen = JNCSNpp.from_config(cfg)
    net = randomize_parameters_(NCSNpp.from_config(cfg), seed=2)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jgen.init({"params": k, "dropout": k},
                                              jnp.zeros((1, 128, 128, 3)),
                                              jnp.zeros((1,), jnp.int32), jnp.zeros((1, cfg.nz))))
    params = flax_params_from_port(net, jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                                     shapes))
    x, t, z = randn(14, 1, 128, 128, 3), np.array([1], np.int32), randn(15, 1, cfg.nz)
    r = randn(16, 1, 128, 128, 3)

    def loss(p, x_, t_, z_):
        return (jgen.apply({"params": p}, x_, t_, z_, train=True) * jnp.asarray(r)).sum()

    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(z))
    n_pallas = count_pallas_calls(jax.make_jaxpr(jax.grad(loss))(params, *args).jaxpr)
    jgrads = jax.jit(jax.grad(loss))(params, *args)

    pair_conv.reset_launch_counts()
    out = net.train()(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(z))
    (out * nchw(r)).sum().backward()
    # forward: conv 0/1 of the 128² down block, conv 1 of the first up block
    # and conv 0/1 of the second; dx: those with C_in 64 (conv 0 of the
    # second up block has C_in 128 and takes the library)
    assert pair_conv.CALLS == {"forward": 5, "dx": 4, "dx_library": 1}
    assert n_pallas == pair_conv.CALLS["forward"] + pair_conv.CALLS["dx"]
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    names = sorted(want)
    got_v = torch.cat([dict(net.named_parameters())[k].grad.reshape(-1) for k in names])
    want_v = torch.cat([want[k].reshape(-1) for k in names])
    assert float(want_v.norm()) > 1.0
    net32 = NCSNpp.from_config(cfg.replace(compute_dtype="float32"))
    net32.load_state_dict(net.state_dict(), strict=True)
    out32 = net32.train()(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(z))
    (out32 * nchw(r)).sum().backward()
    g16, g32 = dict(net.named_parameters()), dict(net32.named_parameters())
    f32_v = torch.cat([g32[k].grad.reshape(-1) for k in names])

    def rl2(a, b):
        return float((a - b).norm() / b.norm())

    err, control = rl2(got_v, want_v), rl2(f32_v, want_v)
    print(f"bf16 G grads: port vs JAX {err:.4g}, port f32 vs JAX bf16 {control:.4g}, "
          f"port bf16 vs f32 {rl2(got_v, f32_v):.4g}")
    assert err < 1.5 * control and rl2(got_v, f32_v) > 0.5 * control
    for k in names:
        ctl_k = rl2(g32[k].grad, want[k])
        assert rl2(g16[k].grad, want[k]) <= 3 * ctl_k + 1e-2, k
