"""A training run between the packages (`ddgan_torch.compat.content`), on
the CPU: the JAX package's `content.ckpt` resumed by the port, and the
port's state written back and loaded by `ddgan_tpu.train.checkpoint.
load_content`, for Adam runs (with clip and weight decay, and without) and
PSO runs. Not to be confused with the JAX package's own
tests/test_torch_ckpt_e2e.py.

The model is small (image 8, nf 8, one level, DiscriminatorSmall ngf 4,
batch 2, dropout 0) with N(0,1)/sqrt(fan_in) weights. The JAX side is its
package's functions composed as its steps compose them, with injected
noise (the Adam step as in tests/test_torch_train_step.py, without R1; the
PSO step as in tests/test_torch_pso_step.py, its swarm over one vector per
network). Bounds: what crosses a file is equal to the last bit; one step
after it, losses within 1e-4 relative and parameters, EMA and Adam moments
within 1e-5 absolute (the train-step tests' bounds), every swarm tensor
within 1e-6 of its largest magnitude.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from ddgan_tpu.diffusion import DiffusionCoefficients as JCoeff
from ddgan_tpu.diffusion import PosteriorCoefficients as JPos
from ddgan_tpu.diffusion import q_sample_pairs_with_noise as jq_pairs
from ddgan_tpu.diffusion import sample_posterior_with_noise as jposterior
from ddgan_tpu.models import DiscriminatorSmall as JSmall
from ddgan_tpu.models import NCSNpp as JNCSNpp
from ddgan_tpu.train import checkpoint as jckpt
from ddgan_tpu.train import make_optimizer as jmake_optimizer
from ddgan_tpu.train.ema import ema_update as jema_update
from ddgan_tpu.train.optim import apply_lr
from ddgan_tpu.train.pso_optim import AdaptivePSO as JAdaptivePSO
from ddgan_tpu.train.pso_step import PSOTrainState as JPSOTrainState
from ddgan_tpu.train.state import TrainState as JTrainState

from ddgan_torch.compat import content, msgpack, state_dict_from_flax
from ddgan_torch.config import Config
from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients
from ddgan_torch.train import (
    AdaptivePSO,
    PSOTrainState,
    TrainState,
    loop,
    make_pso_train_step,
    make_train_step,
)
from ddgan_torch.utils import randomize_parameters_

from _torch_port import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    Flat,
    jax_variables,
    nchw,
    np_step_draws,
    one_torch_thread,
    random_flax_params,
    torch_step_draws,
)

B = 2
LR = 1e-3
EMA = 0.9
SWARM = 5
TRIGGER = 5
SMALL = dict(dataset="synthetic", image_size=8, num_channels=1, num_channels_dae=8,
             ch_mult=[1], num_res_blocks=1, attn_resolutions=[4], nz=4, z_emb_dim=8, n_mlp=1,
             t_emb_dim=8, ngf=4, num_timesteps=2, dropout=0.0, ema_decay=EMA, lazy_reg=1000,
             r1_gamma=1.0, batch_size=B, seed=3)
ADAM = {"clip_and_wd": dict(grad_clip_norm=1.0, weight_decay_G=1e-3, weight_decay_D=2e-3),
        "neither": dict(grad_clip_norm=0.0, weight_decay_G=0.0, weight_decay_D=0.0)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _np_in_order(tree):
    """A state dict's leaves as numpy arrays, its maps' order kept (jax's
    tree functions sort dict keys)."""
    if isinstance(tree, dict):
        return {k: _np_in_order(v) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)


def _assert_tree_equal(got, want, path="") -> None:
    """Two state dicts (nested dicts of arrays) equal key for key and bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), path


def _world(cfg):
    """The small models with shared random weights, and the batch: (cfg,
    jgen, jdisc, params_G, params_D, real, buffers_G)."""
    jgen, jdisc = JNCSNpp.from_config(cfg), JSmall(nc=2, ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim)
    x0, t0 = jnp.zeros((2, 8, 8, 1)), jnp.zeros((2,), jnp.int32)
    gen = randomize_parameters_(loop.build_models(cfg)[0], seed=0)
    # copies: a jax array may share the memory of the torch tensor it came from
    variables = jax.tree.map(lambda a: jnp.array(np.array(a)),
                             jax_variables(jgen, cfg, gen, batch=2))
    d_shapes = jax.eval_shape(jdisc.init, jax.random.PRNGKey(0), x0, t0, x0)["params"]
    pD = jax.tree.map(jnp.asarray, random_flax_params(d_shapes, seed=1))
    real = np.random.RandomState(2).uniform(-1, 1, (B, 8, 8, 1)).astype(np.float32)
    return cfg, jgen, jdisc, variables["params"], pD, real, variables.get("buffers", {})


@pytest.fixture(scope="module")
def world():
    return _world(Config(**SMALL))[:6]


@pytest.fixture(scope="module")
def fourier_world():
    """`world` with the Fourier embedding (a non-empty buffers_G) at T = 4,
    with its buffers_G last."""
    return _world(Config(**SMALL).replace(embedding_type="fourier", num_timesteps=4))


def _draws(cfg, seed):
    return np_step_draws(cfg, B, seed)


def _fourier_draws(cfg, seed):
    """A step's draws with t >= 1: the Fourier embedding takes log(t)."""
    dr = _draws(cfg, seed)
    for i in (0, 5):
        dr[i] = (1 + dr[i] % (cfg.num_timesteps - 1)).astype(np.int32)
    return dr


def _coeffs(cfg):
    return (DiffusionCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                         device="cpu"),
            PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                         device="cpu"))


# ---------------------------------------------------------------- Adam
@pytest.fixture(scope="module")
def jax_fns(world):
    return _jax_fns(world)


@pytest.fixture(scope="module")
def fourier_fns(fourier_world):
    return _jax_fns(fourier_world)


def _jax_fns(world):
    """The JAX package's functions of the small models, each compiled once:
    the D update's loss gradient and the G update's (without R1, as
    `ddgan_tpu/train/step.py` composes them), and from them the PSO step's
    forward losses (`ddgan_tpu/train/pso_step.py:113-130`); G's buffers, if
    any, ride along as the JAX steps pass them."""
    cfg, jgen, jdisc = world[:3]
    buffers = {"buffers": world[6]} if len(world) > 6 and world[6] else {}
    coeff = JCoeff.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max)
    pos = JPos.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max)

    def apply_D(p, x, t, x_t):
        return jdisc.apply({"params": p}, x, t, x_t).reshape(-1).astype(jnp.float32)

    @jax.jit
    def d_grads(pG, pD, real, t, nq, nn, z, npost):
        x_t, x_tp1 = jq_pairs(coeff, real, t, nq, nn)
        x_pos = jposterior(pos, jgen.apply({"params": pG, **buffers}, x_tp1, t, z, train=True),
                           x_tp1, t, npost)

        def d_loss(p):
            real_ = jax.nn.softplus(-apply_D(p, x_t, t, x_tp1)).mean()
            fake_ = jax.nn.softplus(apply_D(p, x_pos, t, x_tp1)).mean()
            return real_ + fake_, (real_, fake_)

        return jax.value_and_grad(d_loss, has_aux=True)(pD)[::-1]

    @jax.jit
    def g_grads(pG, pD, real, t2, nq2, nn2, z2, npost2):
        _, x_tp1_g = jq_pairs(coeff, real, t2, nq2, nn2)

        def g_loss(p):
            x0 = jgen.apply({"params": p, **buffers}, x_tp1_g, t2, z2, train=True)
            return jax.nn.softplus(-apply_D(pD, jposterior(pos, x0, x_tp1_g, t2, npost2), t2,
                                            x_tp1_g)).mean()

        return jax.value_and_grad(g_loss)(pG)[::-1]

    def losses(pG, pD, real, *draws):
        """The PSO step's forward losses, from the same two compiled functions."""
        _, (_, (errD_real, errD_fake)) = d_grads(pG, pD, real, *draws[:5])
        return errD_real, errD_fake, g_grads(pG, pD, real, *draws[5:])[1]

    return losses, d_grads, g_grads


def _jax_adam_step(cfg, jax_fns, opt):
    """The JAX package's train step without R1, composed: D update, then the
    G update against the updated D, then the EMA."""
    _, d_grads, g_grads = jax_fns
    tx_g = jmake_optimizer(cfg.beta1_g, cfg.beta2_g, opt["weight_decay_G"], opt["grad_clip_norm"])
    tx_d = jmake_optimizer(cfg.beta1_d, cfg.beta2_d, opt["weight_decay_D"], opt["grad_clip_norm"])

    @functools.partial(jax.jit, static_argnums=0)
    def update(tx_is_g, grads, opt_state, params):
        upd, opt_state = (tx_g if tx_is_g else tx_d).update(grads, opt_state, params)
        return optax.apply_updates(params, apply_lr(upd, LR)), opt_state

    def step(st, real, *draws):
        gD, (_, (errD_real, errD_fake)) = d_grads(st.params_G, st.params_D, real, *draws[:5])
        pD, opt_D = update(False, gD, st.opt_D, st.params_D)
        gG, errG = g_grads(st.params_G, pD, real, *draws[5:])
        pG, opt_G = update(True, gG, st.opt_G, st.params_G)
        return st.replace(params_G=pG, params_D=pD, opt_G=opt_G, opt_D=opt_D,
                          ema_G=jax.jit(jema_update)(st.ema_G, pG, EMA), step=st.step + 1), \
            (errD_real, errD_fake, errG)

    return step, tx_g, tx_d


def _assert_adam_close(state: TrainState, jst, what):
    for net, tree in ((state.gen, jst.params_G), (state.disc, jst.params_D)):
        want = state_dict_from_flax(_np_tree(tree))
        for k, p in net.named_parameters():
            assert float((p.detach() - want[k]).abs().max()) <= 1e-5, (what, k)
    want = state_dict_from_flax(_np_tree(jst.ema_G))
    for k, v in state.ema_G.items():
        assert float((v - want[k]).abs().max()) <= 1e-5, (what, "ema", k)
    for opt, jopt, net in ((state.opt_G, jst.opt_G, state.gen), (state.opt_D, jst.opt_D,
                                                                 state.disc)):
        adam = content._adam_element(serialization.to_state_dict(_np_tree(jopt)))
        mu, nu = state_dict_from_flax(adam["mu"]), state_dict_from_flax(adam["nu"])
        for (k, _), p in zip(net.named_parameters(), opt.params):
            st = opt.adam.state[p]
            assert int(st["step"]) == int(adam["count"]), (what, k)
            assert float((st["exp_avg"] - mu[k]).abs().max()) <= 1e-5, (what, "mu", k)
            assert float((st["exp_avg_sq"] - nu[k]).abs().max()) <= 1e-5, (what, "nu", k)


@pytest.mark.parametrize("opt", list(ADAM))
def test_adam_run_crosses_both_ways(world, jax_fns, opt, tmp_path):
    _adam_run_crosses(world, jax_fns, opt, tmp_path, _draws)


def test_fourier_adam_run_crosses_both_ways(fourier_world, fourier_fns, tmp_path):
    """The same with the Fourier embedding: buffers_G crosses into the
    generator's state_dict and back, and Adam and the EMA hold params_G's
    leaves only."""
    _adam_run_crosses(fourier_world, fourier_fns, "clip_and_wd", tmp_path, _fourier_draws)


def _adam_run_crosses(world, jax_fns, opt, tmp_path, draw):
    cfg0, jgen, jdisc, pG, pD, real = world[:6]
    bG = world[6] if len(world) > 6 else {}
    cfg = cfg0.replace(**ADAM[opt])
    jstep, tx_g, tx_d = _jax_adam_step(cfg, jax_fns, ADAM[opt])
    jst = JTrainState(params_G=pG, params_D=pD, buffers_G=bG, opt_G=tx_g.init(pG),
                      opt_D=tx_d.init(pD), ema_G=pG, step=jnp.int32(0), epoch=jnp.int32(0))
    draws = [draw(cfg, 20 + i) for i in range(3)]

    def jax_next(st, i):
        st, losses = jstep(st, jnp.asarray(real), *[jnp.asarray(a) for a in draws[i]])
        return st.replace(epoch=jnp.int32(i + 1)), [float(v) for v in losses]

    jst, _ = jax_next(jst, 0)  # Adam's moments and count are no longer their init
    jckpt.save_content(tmp_path / "jax", jst, cfg.to_dict())

    # JAX → port: every array equal, then the next step equal to JAX's
    state = content.empty_state(cfg, "cpu")
    content.load_content_ckpt(tmp_path / "jax", state)
    assert (state.step, state.epoch) == (1, 1)
    _assert_tree_equal(content.flax_content(state),
                       serialization.to_state_dict(_np_tree(jst)))
    assert isinstance(state, TrainState) and state.opt_G.grad_clip_norm == cfg.grad_clip_norm
    _assert_params_only(state, pG)
    port_step = make_train_step(*_coeffs(cfg), num_timesteps=cfg.num_timesteps, nz=cfg.nz,
                                r1_gamma=cfg.r1_gamma, lazy_reg=cfg.lazy_reg, ema_decay=EMA,
                                use_ema=True)
    for i in (1, 2):
        m = port_step(state, nchw(real), None, LR, LR, draws=torch_step_draws(draws[i]))
        jst, (errD_real, errD_fake, errG) = jax_next(jst, i)
        state.epoch = i + 1
        for got, want in ((m.errD_real, errD_real), (m.errD_fake, errD_fake), (m.errG, errG)):
            assert float(got) == pytest.approx(want, rel=1e-4), i
        _assert_adam_close(state, jst, f"step {i}")
        if i == 1:
            # port → JAX: `load_content` takes the port's file; every array equal
            content.write_content_ckpt(tmp_path / "port", state, cfg.to_dict())
            loaded = jckpt.load_content(tmp_path / "port", jst)
            _assert_tree_equal(serialization.to_state_dict(_np_tree(loaded)),
                               content.flax_content(state))
            jst = loaded  # JAX's next step starts from the port's state


# ---------------------------------------------------------------- PSO
def _jax_pso_state(cfg, pG, pD, bG=None):
    """A JAX PSOTrainState one step short of firing both swarms: the swarms
    as `AdaptivePSO.init` draws them (over one vector per network), TRIGGER
    losses in each ring buffer."""
    jpso = JAdaptivePSO(swarm_size=SWARM)
    rs = np.random.RandomState(4)

    def swarm(params, key):
        f = Flat(params)
        flat = jpso.init(key, f.vec(params))
        return flat.replace(**{k: f.tree(getattr(flat, k)) for k in
                               ("particles", "velocities", "pbest_pos", "gbest_pos")})

    return JPSOTrainState(
        params_G=pG, params_D=pD, buffers_G=bG or {},
        pso_G=swarm(pG, jax.random.PRNGKey(5)), pso_D=swarm(pD, jax.random.PRNGKey(6)),
        ema_G=jax.tree.map(lambda p: np.asarray(p) * np.float32(0.5), pG),
        loss_buf_G=jnp.asarray(np.r_[rs.uniform(0.5, 1.5, TRIGGER), 0].astype(np.float32)),
        loss_buf_D=jnp.asarray(np.r_[rs.uniform(1, 2, TRIGGER), 0].astype(np.float32)),
        buf_count_G=jnp.int32(TRIGGER), buf_count_D=jnp.int32(TRIGGER),
        step=jnp.int32(TRIGGER), epoch=jnp.int32(1)), jpso


def _jax_pso_next(losses_fn, jst, jpso, real, draws, keys):
    """The JAX package's PSO step composed: losses, ring buffers, each swarm
    when past the trigger (over one vector per network), the EMA."""
    fG, fD = Flat(jst.params_G), Flat(jst.params_D)
    errD_real, errD_fake, errG = (np.float32(v) for v in losses_fn(
        jst.params_G, jst.params_D, jnp.asarray(real), *[jnp.asarray(a) for a in draws]))
    out, swarm_draws = {}, {}
    for name, loss, f, key in (("D", errD_real + errD_fake, fD, keys[0]),
                               ("G", errG, fG, keys[1])):
        buf = np.array(getattr(jst, "loss_buf_" + name))
        cnt = int(getattr(jst, "buf_count_" + name))
        buf[cnt % len(buf)] = loss
        cnt += 1
        params, swarm = getattr(jst, "params_" + name), getattr(jst, "pso_" + name)
        if cnt > TRIGGER:
            flat = swarm.replace(**{k: f.vec(getattr(swarm, k), lead) for k, lead in
                                    (("particles", 1), ("velocities", 1), ("pbest_pos", 1),
                                     ("gbest_pos", 0))})
            vec = f.vec(params)
            swarm_draws[name] = (f, key, vec)
            flat, vec = jpso.step(flat, vec, jnp.asarray(buf), key)
            swarm = flat.replace(**{k: f.tree(getattr(flat, k)) for k in
                                    ("particles", "velocities", "pbest_pos", "gbest_pos")})
            params, cnt = f.tree(vec), 0
        out.update({"params_" + name: params, "pso_" + name: swarm,
                    "loss_buf_" + name: jnp.asarray(buf), "buf_count_" + name: jnp.int32(cnt)})
    jst = jst.replace(**out)
    jst = jst.replace(ema_G=jax.jit(jema_update)(jst.ema_G, jst.params_G, EMA),
                      step=jst.step + 1)
    return jst, (errD_real, errD_fake, errG), swarm_draws


def _assert_swarm_close(state: PSOTrainState, jst, what):
    got = content.flax_content(state)
    want = serialization.to_state_dict(_np_tree(jst))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want), what
    for path, g in flat_got:
        w = np.asarray(flat_want[path])
        if w.dtype == np.int32:
            assert np.array_equal(g, w), (what, path)
            continue
        scale = max(float(np.abs(w[np.isfinite(w)]).max(initial=0.0)), 1e-30)
        assert np.array_equal(np.isinf(g), np.isinf(w)), (what, path)
        err = float(np.abs(np.where(np.isfinite(w), g - w, 0)).max(initial=0.0))
        bound = 1e-4 * scale if "loss_buf" in jax.tree_util.keystr(path) else 1e-6 * scale
        assert err <= bound, (what, jax.tree_util.keystr(path), err, scale)


def test_pso_run_crosses_both_ways(world, jax_fns, tmp_path):
    _pso_run_crosses(world, jax_fns, tmp_path, _draws)


def test_fourier_pso_run_crosses_both_ways(fourier_world, fourier_fns, tmp_path):
    """The same with the Fourier embedding: the swarms hold params_G's
    leaves, never W."""
    _pso_run_crosses(fourier_world, fourier_fns, tmp_path, _fourier_draws)


def _assert_params_only(state, pG):
    """Adam's, the EMA's and the swarms' tensors are G's parameters, leaf
    for leaf JAX's params_G, and never its buffer."""
    names = [k for k, _ in state.gen.named_parameters()]
    assert set(names) == set(state_dict_from_flax(_np_tree(pG)))
    assert not any(k.endswith(".W") and "NIN" not in k for k in names)
    assert list(state.ema_G) == names
    if isinstance(state, PSOTrainState):
        assert len(state.pso_G.particles) == len(names)
    else:
        assert len(state.opt_G.params) == len(names)


def _pso_run_crosses(world, jax_fns, tmp_path, draw):
    cfg0, jgen, jdisc, pG, pD, real = world[:6]
    bG = world[6] if len(world) > 6 else {}
    cfg = cfg0.replace(kind_of_optim="pso")
    jst, jpso = _jax_pso_state(cfg, pG, pD, bG)
    jckpt.save_content(tmp_path / "jax", jst, cfg.to_dict())

    state = content.empty_state(cfg, "cpu")
    assert state.pso_G is None  # a state for a checkpoint to fill
    content.load_content_ckpt(tmp_path / "jax", state)
    _assert_tree_equal(content.flax_content(state), serialization.to_state_dict(_np_tree(jst)))
    assert (state.buf_count_G, state.step, state.epoch) == (TRIGGER, TRIGGER, 1)
    _assert_params_only(state, pG)

    pso = AdaptivePSO(swarm_size=SWARM)
    step = make_pso_train_step(*_coeffs(cfg), pso, num_timesteps=cfg.num_timesteps, nz=cfg.nz,
                               ema_decay=EMA, use_ema=True, trigger=TRIGGER)
    for i in (0, 1):  # step 0 fires both swarms, step 1 only accumulates
        dr = draw(cfg, 30 + i)
        keys = (jax.random.PRNGKey(40 + i), jax.random.PRNGKey(50 + i))
        jst, (errD_real, errD_fake, errG), fired = _jax_pso_next(jax_fns[0], jst, jpso, real,
                                                                 dr, keys)
        assert sorted(fired) == (["D", "G"] if i == 0 else [])
        pso_draws = None
        if fired:
            pso_draws = tuple(f.draws(key, vec, SWARM, net) for (f, key, vec), net in
                              ((fired["D"], state.disc), (fired["G"], state.gen)))
        m = step(state, nchw(real), None, 0.0, 0.0, draws=torch_step_draws(dr),
                 pso_draws=pso_draws)
        for got, want in ((m.errD_real, errD_real), (m.errD_fake, errD_fake), (m.errG, errG)):
            assert float(got) == pytest.approx(float(want), rel=1e-4), i
        _assert_swarm_close(state, jst, f"step {i}")
        if i == 0:
            content.write_content_ckpt(tmp_path / "port", state, cfg.to_dict())
            loaded = jckpt.load_content(tmp_path / "port", jst)
            _assert_tree_equal(serialization.to_state_dict(_np_tree(loaded)),
                               content.flax_content(state))
            jst = loaded
    assert state.buf_count_G == 1 and state.step == TRIGGER + 2


# ---------------------------------------------------------------- files
def test_write_msgpack_is_what_flax_writes_and_restores(world, monkeypatch):
    """The writer's bytes are `flax.serialization.to_bytes`'s for both train
    states, and flax restores them, and a tree of every type and a chunked
    leaf, to an equal tree."""
    cfg, _, _, pG, pD, _ = world
    jst, _ = _jax_pso_state(cfg, pG, pD)
    for state in (jst, JTrainState(params_G=pG, params_D=pD, buffers_G={},
                                   opt_G=jmake_optimizer(0.5, 0.9, 1e-4, 1.0).init(pG),
                                   opt_D=jmake_optimizer(0.5, 0.9, 0.0, 0.0).init(pD),
                                   ema_G=None, step=jnp.int32(7), epoch=jnp.int32(2))):
        tree = _np_in_order(serialization.to_state_dict(state))
        assert msgpack.write_msgpack(tree) == serialization.to_bytes(state)
    import ml_dtypes

    tree = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3), "i": np.int32(3),
            "bf16": np.ones((2,), ml_dtypes.bfloat16), "scalar0d": np.zeros((), np.int32),
            "t": torch.arange(4, dtype=torch.bfloat16), "empty": {}, "none": None,
            "list": [1, -1, 200, -200, 70000, -(2**40), 1.5, "x" * 40, True, b"\x00" * 300],
            "many": {str(i): i for i in range(20)}}
    restored = serialization.msgpack_restore(msgpack.write_msgpack(tree))
    assert restored["list"] == tree["list"] and restored["many"] == tree["many"]
    assert restored["empty"] == {} and restored["none"] is None
    assert restored["bf16"].dtype == tree["bf16"].dtype
    for k in ("f32", "i", "scalar0d"):
        assert np.asarray(restored[k]).dtype == np.asarray(tree[k]).dtype
        np.testing.assert_array_equal(restored[k], tree[k])
    np.testing.assert_array_equal(np.asarray(restored["t"], np.float32), np.arange(4))
    monkeypatch.setattr(msgpack, "_MAX_CHUNK", 64)
    big = {"q": np.arange(100, dtype=np.float32)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = msgpack.write_msgpack(big)
    assert data == serialization.msgpack_serialize(dict(big), in_place=True)
    np.testing.assert_array_equal(serialization.msgpack_restore(data)["q"], big["q"])


def test_cli_converts_and_the_loop_resumes_from_content_ckpt(world, tmp_path, monkeypatch):
    """`python -m ddgan_torch.compat.content` both ways reproduces the JAX
    file's state, and `train --resume` takes a directory that holds only
    `content.ckpt` and continues its epoch and global step."""
    cfg0, _, _, pG, pD, _ = world
    cfg = cfg0.replace(limited_iter=2, num_epoch=2, exp="cross")
    tx = jmake_optimizer(cfg.beta1_g, cfg.beta2_g, 0.0, cfg.grad_clip_norm)
    jst = JTrainState(params_G=pG, params_D=pD, buffers_G={}, opt_G=tx.init(pG),
                      opt_D=tx.init(pD), ema_G=pG, step=jnp.int32(2), epoch=jnp.int32(1))
    monkeypatch.chdir(tmp_path)
    exp = tmp_path / "saved_info" / "dd_gan" / "synthetic" / "cross"
    jckpt.save_content(exp, jst, cfg.to_dict())
    want = serialization.to_state_dict(_np_tree(jst))

    out = content.main([str(exp), "--to", "pth", "--device", "cpu"])
    assert out["epoch"] == 1 and out["step"] == 2 and (exp / "content.pth").exists()
    (exp / "content.ckpt").unlink()
    content.main([str(exp), "--to", "ckpt", "--device", "cpu"])
    _assert_tree_equal(msgpack.read_msgpack((exp / "content.ckpt").read_bytes()), want)
    assert json.loads((exp / "content_args.json").read_text())["exp"] == "cross"

    (exp / "content.pth").unlink()
    state = loop.train(cfg.replace(resume=True), device="cpu")
    assert state.epoch == 3 and state.step == 2 + 2 * 2
    with pytest.raises(ValueError, match="Adam run"):
        content.load_content_ckpt(exp, content.empty_state(cfg.replace(kind_of_optim="pso"),
                                                           "cpu"))
