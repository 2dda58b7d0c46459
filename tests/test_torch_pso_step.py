"""The port's PSO train step and epoch end (`ddgan_torch.train.pso_step`)
against the JAX package's, on the CPU.

- The protocol of tests/test_pso_step.py on the port: forward-only losses
  accumulate in the ring buffer; the swarm fires only once more than
  `trigger` losses have accumulated, the parameters change only then, the
  buffer restarts; the EMA steps every iteration; the epoch-end update
  fires on a short epoch's +inf-padded losses and resets the buffers.
- trigger + 2 steps and an epoch end of the tiny flagship (image 16, nf 16,
  DiscriminatorSmall ngf 8, batch 2, dropout 0) with injected draws,
  against the JAX package's functions composed as its PSO step composes
  them (`q_sample_pairs_with_noise`, the generator, `sample_posterior_with_noise`,
  the discriminator; the ring buffer; `AdaptivePSO.step` with its own keys,
  whose r1 and r2 the port takes as `PSODraws`; `ema_update`). Both swarms
  start from the same draws of `AdaptivePSO.init`. The JAX swarm runs over
  each network's parameters concatenated into one vector (`_torch_port.Flat`:
  the update is elementwise, so that changes no value); the draws are split
  back into the parameters' layouts for the port.

Swarm 5 and trigger 5, as tests/test_pso_step.py runs the protocol. Bounds:
losses within 1e-4 relative (the train-step tests' bound for the same
forwards), the parameters after each firing, every swarm tensor and the
EMA within 1e-6 of their largest magnitude, the counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddgan_tpu.models import DiscriminatorSmall as JSmall
from ddgan_tpu.models import NCSNpp as JNCSNpp
from ddgan_tpu.train.ema import ema_update as jema_update
from ddgan_tpu.train.pso_optim import AdaptivePSO as JAdaptivePSO
from ddgan_tpu.train.pso_step import pad_epoch_losses as jpad_epoch_losses

from ddgan_torch.compat import state_dict_from_flax
from ddgan_torch.config import Config
from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients
from ddgan_torch.models import DiscriminatorSmall, NCSNpp
from ddgan_torch.train import (
    AdaptivePSO,
    PSOTrainState,
    create_pso_train_state,
    ema_init,
    make_pso_epoch_end,
    make_pso_train_step,
    pad_epoch_losses,
)
from ddgan_torch.utils import randomize_parameters_

from _torch_port import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    Flat,
    flax_params_from_port,
    jax_forward_losses,
    nchw,
    np_step_draws,
    one_torch_thread,
    random_flax_params,
    tiny_config,
    torch_step_draws,
)

TRIGGER = 5
SWARM = 5
EMA = 0.9
B = 2


def _coeffs(cfg):
    return (DiffusionCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                         device="cpu"),
            PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                         device="cpu"))


def _l2diff(a, b) -> float:
    return sum(float(((x.detach() - y.detach()) ** 2).sum()) for x, y in zip(a, b))


def test_pso_step_protocol():
    cfg = Config(
        image_size=8, num_channels=1, num_channels_dae=8, ch_mult=[1],
        num_res_blocks=1, attn_resolutions=[4], nz=4, z_emb_dim=8, n_mlp=1,
        t_emb_dim=8, ngf=4, num_timesteps=2, dropout=0.0, ema_decay=0.9,
    )
    g = torch.Generator().manual_seed(0)
    gen = NCSNpp.from_config(cfg, generator=g)
    disc = DiscriminatorSmall(nc=2, ngf=4, t_emb_dim=8)
    pso = AdaptivePSO(swarm_size=SWARM)
    state = create_pso_train_state(gen, disc, pso, g, buf_len=TRIGGER + 1)
    step = make_pso_train_step(*_coeffs(cfg), pso, num_timesteps=2, nz=4, ema_decay=0.9,
                               use_ema=True, trigger=TRIGGER)
    batch = nchw(np.random.RandomState(0).uniform(-1, 1, (16, 8, 8, 1)).astype(np.float32))

    params0 = [p.detach().clone() for p in gen.parameters()]
    ema0 = {k: v.clone() for k, v in state.ema_G.items()}
    for i in range(TRIGGER):
        m = step(state, batch, torch.Generator().manual_seed(i), 0.0, 0.0)
        assert np.isfinite(float(m.errD)) and np.isfinite(float(m.errG))
        assert float(m.errD) == pytest.approx(float(m.errD_real + m.errD_fake))
    # TRIGGER losses accumulated, not yet more: the parameters are untouched
    assert state.buf_count_G == state.buf_count_D == TRIGGER and state.step == TRIGGER
    assert _l2diff(params0, gen.parameters()) == 0.0
    assert torch.equal(state.loss_buf_G[TRIGGER], torch.zeros(()))
    # the EMA of still parameters stays put, up to 0.9 p + 0.1 p rounding
    assert all(torch.allclose(state.ema_G[k], ema0[k], rtol=1e-6, atol=0) for k in ema0)

    # the (TRIGGER+1)th loss fires the swarm: the parameters become the gbest
    step(state, batch, torch.Generator().manual_seed(100), 0.0, 0.0)
    assert state.buf_count_G == state.buf_count_D == 0
    assert _l2diff(params0, gen.parameters()) > 0.0
    assert float(state.pso_G.gbest_score) < float("inf")
    assert int(state.pso_G.iteration) == int(state.pso_D.iteration) == 1
    assert all(torch.equal(p, q) for p, q in zip(gen.parameters(), state.pso_G.gbest_pos))
    assert _l2diff(ema0.values(), state.ema_G.values()) > 0.0  # the EMA follows

    # the epoch-end update (ddgan.py:528-533) fires on a short epoch that
    # never reaches the trigger, and resets the ring buffers
    gen2 = NCSNpp.from_config(cfg, generator=torch.Generator().manual_seed(1))
    disc2 = DiscriminatorSmall(nc=2, ngf=4, t_emb_dim=8)
    fresh = create_pso_train_state(gen2, disc2, pso, torch.Generator().manual_seed(1),
                                   buf_len=TRIGGER + 1)
    params0 = [p.detach().clone() for p in gen2.parameters()]
    n_short = TRIGGER - 2
    losses_d, losses_g = [], []
    for i in range(n_short):
        m = step(fresh, batch, torch.Generator().manual_seed(300 + i), 0.0, 0.0)
        losses_d.append(float(m.errD))
        losses_g.append(float(m.errG))
    assert _l2diff(params0, gen2.parameters()) == 0.0
    ld, lg = pad_epoch_losses(losses_d, SWARM), pad_epoch_losses(losses_g, SWARM)
    assert ld.shape == (SWARM,) and np.isinf(ld[n_short:]).all()
    np.testing.assert_array_equal(ld, jpad_epoch_losses(losses_d, SWARM))
    make_pso_epoch_end(pso)(fresh, ld, lg, torch.Generator().manual_seed(400))
    assert _l2diff(params0, gen2.parameters()) > 0.0
    assert fresh.buf_count_G == fresh.buf_count_D == 0
    assert float(fresh.loss_buf_G.abs().sum()) == 0.0 == float(fresh.loss_buf_D.abs().sum())
    assert float(fresh.pso_G.gbest_score) < float("inf")


# ---------------------------------------------------------------- against JAX
def _close(got, want, what):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert np.array_equal(np.isinf(got), np.isinf(want)), what
    fin = np.isfinite(want)
    scale = max(float(np.abs(want[fin]).max(initial=0.0)), 1e-30)
    err = float(np.abs(got[fin] - want[fin]).max(initial=0.0))
    assert err <= 1e-6 * scale, f"{what}: max-abs {err} against max|ref| {scale}"


def _close_list(got, want, module, what):
    for (k, _), g, w in zip(module.named_parameters(), got, want):
        _close(g, w, f"{what} {k}")


def _check_swarm(swarm, jswarm, flat, module, what):
    for field in ("particles", "velocities", "pbest_pos", "gbest_pos"):
        _close_list(getattr(swarm, field), flat.to_port(getattr(jswarm, field), module), module,
                    f"{what} {field}")
    for field in ("pbest_scores", "gbest_score", "c1", "c2"):
        _close(getattr(swarm, field), getattr(jswarm, field), f"{what} {field}")
    assert int(swarm.iteration) == int(jswarm.iteration), what


@pytest.fixture(scope="module")
def world():
    cfg = tiny_config(dropout=0.0)
    jgen = JNCSNpp.from_config(cfg)
    jdisc = JSmall(nc=2 * cfg.num_channels, ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim)
    s = cfg.image_size
    x0 = jnp.zeros((2, s, s, cfg.num_channels))
    t0 = jnp.zeros((2,), jnp.int32)
    g_shapes = jax.eval_shape(lambda: jgen.init({"params": jax.random.PRNGKey(0),
                                                 "dropout": jax.random.PRNGKey(0)},
                                                x0, t0, jnp.zeros((2, cfg.nz))))
    gen = randomize_parameters_(NCSNpp.from_config(cfg), seed=0)
    # copies: a jax array made from a numpy view of a torch tensor may share
    # its memory on the CPU, and the port's swarm writes its parameters in place
    params_G = jax.tree.map(lambda a: jnp.array(np.array(a)), flax_params_from_port(
        gen, jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), g_shapes)))
    d_shapes = jax.eval_shape(jdisc.init, jax.random.PRNGKey(0), x0, t0, x0)["params"]
    params_D = random_flax_params(d_shapes, seed=1)
    disc = DiscriminatorSmall(nc=2 * cfg.num_channels, ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim)
    disc.load_state_dict(state_dict_from_flax(params_D))
    params_D = jax.tree.map(lambda a: jnp.array(np.array(a)), params_D)
    real = np.random.RandomState(2).uniform(-1, 1, (B, s, s, cfg.num_channels)).astype(
        np.float32)
    return cfg, jgen, jdisc, gen, disc, params_G, params_D, real


def test_steps_and_epoch_end_match_jax(world):
    cfg, jgen, jdisc, gen, disc, pG_tree, pD_tree, real = world
    jpso, pso = JAdaptivePSO(swarm_size=SWARM), AdaptivePSO(swarm_size=SWARM)
    losses_fn = jax_forward_losses(jgen, jdisc, cfg)
    fG, fD = Flat(pG_tree), Flat(pD_tree)
    pG, pD = fG.vec(pG_tree), fD.vec(pD_tree)

    kG, kD = jax.random.PRNGKey(5), jax.random.PRNGKey(6)
    jsG, jsD = jpso.init(kG, pG), jpso.init(kD, pD)
    ema = pG
    state = PSOTrainState(
        gen, disc,
        pso_G=pso.init(list(gen.parameters()), noise=fG.noise(kG, pG, SWARM, gen)),
        pso_D=pso.init(list(disc.parameters()), noise=fD.noise(kD, pD, SWARM, disc)),
        ema_G=ema_init(gen), loss_buf_G=torch.zeros(TRIGGER + 1),
        loss_buf_D=torch.zeros(TRIGGER + 1))
    _check_swarm(state.pso_G, jsG, fG, gen, "init G")
    step = make_pso_train_step(*_coeffs(cfg), pso, num_timesteps=cfg.num_timesteps, nz=cfg.nz,
                               ema_decay=EMA, use_ema=True, trigger=TRIGGER)

    buf = {"D": np.zeros(TRIGGER + 1, np.float32), "G": np.zeros(TRIGGER + 1, np.float32)}
    count = {"D": 0, "G": 0}
    epoch = {"D": [], "G": []}
    port_epoch = {"D": [], "G": []}
    fired = []
    for i in range(TRIGGER + 2):
        dr = np_step_draws(cfg, B, 10 + i)
        kd, kg = jax.random.PRNGKey(1000 + i), jax.random.PRNGKey(2000 + i)
        # the JAX package's step, composed
        errD_real, errD_fake, errG = (np.float32(v) for v in losses_fn(
            fG.tree(pG), fD.tree(pD), jnp.asarray(real), *[jnp.asarray(a) for a in dr]))
        for net, loss in (("D", errD_real + errD_fake), ("G", errG)):
            buf[net][count[net] % (TRIGGER + 1)] = loss
            count[net] += 1
            epoch[net].append(loss)
        pso_draws = None
        if count["D"] > TRIGGER or count["G"] > TRIGGER:
            pso_draws = (fD.draws(kd, pD, SWARM, disc), fG.draws(kg, pG, SWARM, gen))
            fired.append(i)
        if count["D"] > TRIGGER:
            jsD, pD = jpso.step(jsD, pD, jnp.asarray(buf["D"]), kd)
            count["D"] = 0
        if count["G"] > TRIGGER:
            jsG, pG = jpso.step(jsG, pG, jnp.asarray(buf["G"]), kg)
            count["G"] = 0
        ema = jema_update(ema, pG, EMA)

        m = step(state, nchw(real), None, 0.0, 0.0, draws=torch_step_draws(dr),
                 pso_draws=pso_draws)
        for name, want in (("errD_real", errD_real), ("errD_fake", errD_fake), ("errG", errG),
                           ("errD", errD_real + errD_fake)):
            assert float(getattr(m, name)) == pytest.approx(want, rel=1e-4), (i, name)
        port_epoch["D"].append(float(m.errD))
        port_epoch["G"].append(float(m.errG))

        assert (state.buf_count_D, state.buf_count_G) == (count["D"], count["G"]), i
        np.testing.assert_allclose(state.loss_buf_D.numpy(), buf["D"], rtol=1e-4)
        np.testing.assert_allclose(state.loss_buf_G.numpy(), buf["G"], rtol=1e-4)
        _close_list(list(gen.parameters()), fG.to_port(pG, gen), gen, f"step {i} params_G")
        _close_list(list(disc.parameters()), fD.to_port(pD, disc), disc, f"step {i} params_D")
        _close_list([state.ema_G[k] for k, _ in gen.named_parameters()], fG.to_port(ema, gen),
                    gen, f"step {i} EMA")
    assert fired == [TRIGGER] and state.step == TRIGGER + 2
    _check_swarm(state.pso_G, jsG, fG, gen, "fired G")
    _check_swarm(state.pso_D, jsD, fD, disc, "fired D")

    # the epoch end, on the epoch's first SWARM losses
    kd, kg = jax.random.split(jax.random.PRNGKey(77))
    ld = jpad_epoch_losses(epoch["D"], SWARM)
    lg = jpad_epoch_losses(epoch["G"], SWARM)
    pso_draws = (fD.draws(kd, pD, SWARM, disc), fG.draws(kg, pG, SWARM, gen))
    jsD, pD = jpso.step(jsD, pD, jnp.asarray(ld), kd)
    jsG, pG = jpso.step(jsG, pG, jnp.asarray(lg), kg)
    make_pso_epoch_end(pso)(
        state, pad_epoch_losses(port_epoch["D"], SWARM), pad_epoch_losses(port_epoch["G"], SWARM),
        None, pso_draws=pso_draws)
    _check_swarm(state.pso_G, jsG, fG, gen, "epoch end G")
    _check_swarm(state.pso_D, jsD, fD, disc, "epoch end D")
    _close_list(list(gen.parameters()), fG.to_port(pG, gen), gen, "epoch end params_G")
    _close_list([state.ema_G[k] for k, _ in gen.named_parameters()], fG.to_port(ema, gen), gen,
                "epoch end EMA (not stepped)")
    assert state.buf_count_G == state.buf_count_D == 0
    assert not state.loss_buf_G.any() and not state.loss_buf_D.any()
