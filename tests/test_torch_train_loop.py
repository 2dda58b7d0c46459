"""The port's train loop, checkpoints and train CLIs (`ddgan_torch.train.loop`,
`train.checkpoint`, `cli.train_cli`, `cli.main_cli`) against the JAX
package's, on the CPU.

- The schedule: each package's `make_train_step` swapped for a recorder,
  both `train`s run the same `synthetic` config, and every step's batch
  (NHWC against NCHW, exact), learning rates (the JAX package computes the
  cosine in float32: rtol 1e-6), update_g flag, and the files on disk
  before it, are compared call for call.
- Resume, the EMA snapshot and DiscriminatorLarge with real steps on the
  port (the tiny config of tests/test_train_step.py:321-327); a
  port-written netG_*.pth read by the JAX package (atol 1e-4, the sampler
  tests' f32 bound) and by the port's sampler CLI.
- The config merge of both CLIs: same argv, same config and same
  written-back configs/config.json.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ddgan_tpu.train as jtrain
from ddgan_tpu.cli import main_cli as jmain_cli
from ddgan_tpu.cli import train_cli as jtrain_cli
from ddgan_tpu.compat import load_torch_netg
from ddgan_tpu.config import Config as JConfig
from ddgan_tpu.models import NCSNpp as JNCSNpp
from ddgan_tpu.train import loop as jloop
from ddgan_tpu.train.step import StepMetrics as JStepMetrics

import ddgan_torch.train as ttrain
from ddgan_torch.cli import main_cli, test_cli, train_cli
from ddgan_torch.compat import load_netg_pth
from ddgan_torch.config import Config
from ddgan_torch.models import NCSNpp
from ddgan_torch.train import checkpoint as ckpt
from ddgan_torch.train import loop
from ddgan_torch.train.step import StepMetrics
from ddgan_torch.utils import randomize_parameters_

from _torch_port import one_torch_thread, tiny_config  # noqa: F401  (an autouse fixture)

CPU = "cpu"
TINY = dict(
    dataset="synthetic", image_size=8, num_channels=1, num_channels_dae=8, ch_mult=[1],
    num_res_blocks=1, attn_resolutions=[4], nz=4, z_emb_dim=8, n_mlp=1, t_emb_dim=8, ngf=4,
    num_timesteps=2, batch_size=2, limited_iter=2, dropout=0.0, lazy_reg=2,
    ema_decay=0.999, use_ema=True, seed=21,
)


def exp_dir(root, exp) -> "Path":  # noqa: F821
    return root / "saved_info" / "dd_gan" / "synthetic" / exp


def files(path) -> list:
    """The experiment's files, a checkpoint's suffix (.ckpt, .pth) as '.*'."""
    if not path.exists():
        return []
    return sorted(re.sub(r"\.(ckpt|pth)$", ".*", p.name) for p in path.iterdir()
                  if not p.name.endswith(".tmp"))


# ---------------------------------------------------------------- the schedule
SCHEDULES = {
    "cosine_d3_every2": dict(d_updates_per_g_update=3, save_content_every=2, save_ckpt_every=2,
                             limited_iter=4, num_epoch=3),
    "no_lr_decay": dict(no_lr_decay=True, limited_iter=3, num_epoch=2),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_loop_schedule_equals_the_jax_loops(name, tmp_path, monkeypatch):
    """Both loops on the same synthetic set: the JAX package loads
    batch_size × its 8 CPU devices a step, so the port runs at that batch."""
    n_dev = jax.local_device_count()
    common = dict(TINY, exp="sched", **SCHEDULES[name])
    runs = {}

    def recorder(kind, seen):
        def make(*args, update_g=True, **kw):
            def step(state, batch, key_or_rng, lr_g, lr_d, *_, **__):
                exp = exp_dir(tmp_path / kind, "sched")
                if kind == "jax":
                    x = np.asarray(batch)
                else:
                    x = batch.numpy().transpose(0, 2, 3, 1)
                    state.step += 1
                seen.append((update_g, x, float(lr_g), float(lr_d), files(exp)))
                flat = batch.reshape(-1)
                errD, errG = flat[0], flat[-1]  # each loop averages what its step returns
                if kind == "jax":
                    return state, JStepMetrics(errD, errD, errD, errG, errD)
                return StepMetrics(errD, errD, errD, errG, errD)
            return step
        return make

    # the JAX init, jitted once instead of op by op (tens of seconds on the CPU)
    real_init = jloop.create_train_state

    def jit_init(key, gen, disc, tx_g, tx_d, image_shape, nz, batch=2, use_ema=True):
        return jax.jit(lambda k: real_init(k, gen, disc, tx_g, tx_d, image_shape, nz,
                                           batch=batch, use_ema=use_ema))(key)

    monkeypatch.setattr(jloop, "create_train_state", jit_init)
    for kind in ("jax", "port"):
        seen = []
        (tmp_path / kind).mkdir()
        monkeypatch.chdir(tmp_path / kind)
        if kind == "jax":
            monkeypatch.setattr(jloop, "make_train_step", recorder(kind, seen))
            jloop.train(JConfig(**common))
        else:
            monkeypatch.setattr(loop, "make_train_step", recorder(kind, seen))
            loop.train(Config(**{**common, "batch_size": common["batch_size"] * n_dev}),
                       device=CPU)
        exp = exp_dir(tmp_path / kind, "sched")
        runs[kind] = (seen, files(exp), json.loads((exp / "losses.json").read_text()))

    (jseen, jfiles, jlosses), (tseen, tfiles, tlosses) = runs["jax"], runs["port"]
    cfg = SCHEDULES[name]
    assert len(tseen) == len(jseen) == (cfg["num_epoch"] + 1) * cfg["limited_iter"]
    for i, (t, j) in enumerate(zip(tseen, jseen)):
        assert t[0] == j[0], f"step {i}: update_g"
        assert t[1].dtype == j[1].dtype == np.float32 and np.array_equal(t[1], j[1]), f"step {i}"
        np.testing.assert_allclose(t[2:4], j[2:4], rtol=1e-6, err_msg=f"step {i}: lr")
        assert t[4] == j[4], f"step {i}: files"
    assert tfiles == jfiles and tlosses == jlosses
    assert [e["epoch"] for e in tlosses] == list(range(1, cfg["num_epoch"] + 2))
    lrs = sorted({t[2] for t in tseen})
    if cfg.get("no_lr_decay"):
        assert lrs == [TINY.get("lr_g", Config().lr_g)]
    else:
        assert len(lrs) == cfg["num_epoch"] + 1  # one cosine rate per epoch
    flags = [t[0] for t in tseen]
    d = cfg.get("d_updates_per_g_update", 1)
    assert flags == [(i % cfg["limited_iter"]) % d == d - 1 for i in range(len(flags))]


def test_pso_loop_schedule_equals_the_jax_loops(tmp_path, monkeypatch):
    """kind_of_optim 'pso': both loops with recorder steps and recorder
    epoch ends on the same synthetic set. Every step's batch, its learning
    rates (constant), and the files before it; every epoch end's padded
    losses (the recorded steps' errD and errG, +inf past the epoch) and the
    files before it; losses.json."""
    import ddgan_tpu.train.pso_step as jpso_step

    n_dev = jax.local_device_count()
    common = dict(TINY, exp="psosched", kind_of_optim="pso", limited_iter=3, num_epoch=2)
    runs = {}

    def recorders(kind, seen):
        exp = lambda: exp_dir(tmp_path / kind, "psosched")  # noqa: E731

        def make_step(*args, **kw):
            def step(state, batch, key_or_rng, lr_g, lr_d, *_, **__):
                if kind == "jax":
                    x = np.asarray(batch)
                else:
                    x = batch.numpy().transpose(0, 2, 3, 1)
                    state.step += 1
                seen.append(("step", x, float(lr_g), float(lr_d), files(exp())))
                flat = batch.reshape(-1)
                errD, errG = flat[0], flat[-1]
                if kind == "jax":
                    return state, JStepMetrics(errD, errD, errD, errG, errD)
                return StepMetrics(errD, errD, errD, errG, errD)
            return step

        def make_epoch_end(pso):
            assert pso.swarm_size == 20
            def epoch_end(state, loss_d, loss_g, key_or_rng):  # noqa: E306
                seen.append(("epoch_end", np.asarray(loss_d), np.asarray(loss_g), files(exp())))
                return state if kind == "jax" else None
            return epoch_end

        return make_step, make_epoch_end

    real_init = jpso_step.create_pso_train_state

    def zeros_init(key, gen, disc, pso, image_shape, nz, batch=2, use_ema=True):
        # the recorders never read the state: its structure, zero-filled, is
        # enough (compiling the swarms' init takes tens of seconds on the CPU)
        shapes = jax.eval_shape(lambda k: real_init(k, gen, disc, pso, image_shape, nz,
                                                    batch=batch, use_ema=use_ema), key)
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)

    monkeypatch.setattr(jpso_step, "create_pso_train_state", zeros_init)
    for kind, mod in (("jax", jloop), ("port", loop)):
        seen = []
        (tmp_path / kind).mkdir()
        monkeypatch.chdir(tmp_path / kind)
        make_step, make_epoch_end = recorders(kind, seen)
        monkeypatch.setattr(mod, "make_pso_train_step", make_step)
        monkeypatch.setattr(mod, "make_pso_epoch_end", make_epoch_end)
        if kind == "jax":
            jloop.train(JConfig(**common))
        else:
            loop.train(Config(**{**common, "batch_size": common["batch_size"] * n_dev}),
                       device=CPU)
        exp = exp_dir(tmp_path / kind, "psosched")
        runs[kind] = (seen, files(exp), json.loads((exp / "losses.json").read_text()))

    (jseen, jfiles, jlosses), (tseen, tfiles, tlosses) = runs["jax"], runs["port"]
    assert [c[0] for c in tseen] == [c[0] for c in jseen] == (["step"] * 3 + ["epoch_end"]) * 3
    for i, (t, j) in enumerate(zip(tseen, jseen)):
        if t[0] == "step":
            assert t[1].dtype == j[1].dtype == np.float32 and np.array_equal(t[1], j[1]), i
            np.testing.assert_allclose(t[2:4], j[2:4], rtol=1e-6, err_msg=f"call {i}: lr")
            assert t[2:4] == (Config().lr_g, Config().lr_d), i
        else:
            for a, b in zip(t[1:3], j[1:3]):
                assert a.dtype == b.dtype == np.float32 and a.shape == (20,), i
                assert np.array_equal(a, b) and np.isinf(a[3:]).all(), i
        assert t[-1] == j[-1], f"call {i}: files"
    assert tfiles == jfiles and tlosses == jlosses
    assert "content.*" in tfiles and "netG_2.*" in tfiles


def test_pso_resume_loads_the_swarm_exactly(tmp_path, monkeypatch):
    """A PSO run's content.pth holds its swarms, buffers and counters: a
    fresh state loaded from it equals the run's final state bit for bit, and
    a resumed run continues the epoch, the global step and the swarms'
    iteration (one epoch-end update an epoch at limited_iter 3)."""
    monkeypatch.chdir(tmp_path)
    cfg = dict(TINY, kind_of_optim="pso", limited_iter=3, exp="psoresume")
    s1 = loop.train(Config(**cfg, num_epoch=0), device=CPU)
    exp = exp_dir(tmp_path, "psoresume")
    raw = torch.load(exp / "content.pth", weights_only=False)
    assert set(raw) == {"epoch", "global_step", "args", "netG_dict", "netD_dict", "optimizerG",
                        "optimizerD", ckpt.EMA_KEY}
    assert raw["optimizerG"]["buf_count"] == 0 and len(raw["optimizerG"]["loss_buf"]) == 21

    gen, disc = loop.build_models(Config(**cfg), torch.Generator().manual_seed(9))
    fresh = ttrain.create_pso_train_state(gen, disc, ttrain.AdaptivePSO(),
                                          torch.Generator().manual_seed(9))
    ckpt.load_content(exp, fresh)
    for a, b in ((fresh, s1),):
        assert (a.step, a.epoch, a.buf_count_G, a.buf_count_D) == (b.step, b.epoch, 0, 0) == \
            (3, 1, 0, 0)
        for name in ("pso_G", "pso_D"):
            sa, sb = getattr(a, name), getattr(b, name)
            for f in ("particles", "velocities", "pbest_pos", "gbest_pos"):
                assert all(torch.equal(x, y) for x, y in zip(getattr(sa, f), getattr(sb, f)))
            for f in ("pbest_scores", "gbest_score", "c1", "c2", "iteration"):
                assert torch.equal(getattr(sa, f), getattr(sb, f)), (name, f)
        assert all(torch.equal(a.ema_G[k], b.ema_G[k]) for k in b.ema_G)
        assert torch.equal(a.loss_buf_G, b.loss_buf_G)
    assert int(s1.pso_G.iteration) == 1

    s2 = loop.train(Config(**cfg, num_epoch=1, resume=True), device=CPU)
    assert (s2.step, s2.epoch, int(s2.pso_G.iteration), int(s2.pso_D.iteration)) == (6, 2, 2, 2)
    assert [e["epoch"] for e in json.loads((exp / "losses.json").read_text())] == [1, 2]
    with pytest.raises(ValueError, match="holds a PSO run"):
        loop.train(Config(**{**cfg, "kind_of_optim": "adam"}, num_epoch=2, resume=True),
                   device=CPU)


# ---------------------------------------------------------------- resume
def test_resume_continuity_with_real_steps(tmp_path, monkeypatch):
    """Train 2 epochs, resume to 4: epoch, step and Adam's step continue,
    the EMA is finite, losses.json keeps its history; then a resume beside
    a stale content.pth.tmp (a write killed half way) loads the whole file."""
    monkeypatch.chdir(tmp_path)
    exp = exp_dir(tmp_path, "resume")
    s1 = loop.train(Config(num_epoch=1, exp="resume", **TINY), device=CPU)
    assert (exp / "content.pth").exists() and s1.step == 4 and s1.epoch == 2
    losses_1 = json.loads((exp / "losses.json").read_text())
    assert [e["epoch"] for e in losses_1] == [1, 2]

    s2 = loop.train(Config(num_epoch=3, resume=True, exp="resume", **TINY), device=CPU)
    assert s2.epoch == 4 and s2.step == 4 + 2 * 2
    for opt in (s2.opt_G, s2.opt_D):
        steps = {int(st["step"]) for st in opt.adam.state.values()}
        assert steps == {s2.step}
    assert all(torch.isfinite(v).all() for v in s2.ema_G.values())
    losses_2 = json.loads((exp / "losses.json").read_text())
    assert [e["epoch"] for e in losses_2] == [1, 2, 3, 4] and losses_2[:2] == losses_1

    raw = torch.load(exp / "content.pth", weights_only=False)
    assert raw["epoch"] == 4 and raw["global_step"] == 8
    assert set(raw) == {"epoch", "global_step", "args", "netG_dict", "netD_dict", "optimizerG",
                        "optimizerD", "schedulerG", "schedulerD", ckpt.EMA_KEY}
    assert raw["args"]["exp"] == "resume" and raw["schedulerG"]["last_epoch"] == 4

    (exp / "content.pth.tmp").write_bytes(b"half a checkpoint")
    s3 = loop.train(Config(num_epoch=4, resume=True, exp="resume", **TINY), device=CPU)
    assert s3.epoch == 5 and s3.step == 10
    assert not (exp / "content.pth.tmp").exists()
    assert torch.load(exp / "content.pth", weights_only=False)["global_step"] == 10
    assert [e["epoch"] for e in json.loads((exp / "losses.json").read_text())] == [1, 2, 3, 4, 5]


def test_resume_loads_the_checkpoint_exactly(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    state = loop.train(Config(num_epoch=0, exp="exact", **TINY), device=CPU)
    cfg = Config(num_epoch=0, exp="exact", **TINY)
    gen, disc = loop.build_models(cfg, torch.Generator().manual_seed(99))
    other = ttrain.create_train_state(gen, disc, ttrain.ClippedAdam(gen.parameters(), 0.5, 0.9),
                                      ttrain.ClippedAdam(disc.parameters(), 0.5, 0.9))
    ckpt.load_content(exp_dir(tmp_path, "exact"), other)
    assert (other.step, other.epoch) == (state.step, state.epoch) == (2, 1)
    for a, b in ((other.gen, state.gen), (other.disc, state.disc)):
        for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), k
    for k in state.ema_G:
        assert torch.equal(other.ema_G[k], state.ema_G[k]), k
    for a, b in ((other.opt_G, state.opt_G), (other.opt_D, state.opt_D)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
        for i in sb["state"]:
            for k, v in sb["state"][i].items():
                assert torch.equal(sa["state"][i][k], v), (i, k)


# ---------------------------------------------------------------- netG
@pytest.mark.parametrize("ema_decay", [0.0, 0.999])
def test_netg_snapshot_is_the_ema(tmp_path, monkeypatch, ema_decay):
    monkeypatch.chdir(tmp_path)
    state = loop.train(Config(**{**TINY, "ema_decay": ema_decay, "num_epoch": 0, "exp": "ema"}),
                       device=CPU)
    snap = load_netg_pth(str(exp_dir(tmp_path, "ema") / "netG_0.pth"))
    live = state.gen.state_dict()
    assert set(snap) == set(live)
    params = dict(state.gen.named_parameters())
    moved = 0
    for k, v in snap.items():
        want = state.ema_G[k] if (ema_decay > 0 and k in params) else live[k]
        assert torch.equal(v, want), k
        moved += int(k in params and not torch.equal(v, live[k]))
    assert (moved > 0) == (ema_decay > 0)


def _jax_template(gen, cfg):
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: gen.init(
        {"params": k, "dropout": k},
        jnp.zeros((1, cfg.image_size, cfg.image_size, cfg.num_channels)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, cfg.nz))))
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)


def test_port_netg_loads_into_the_jax_package_and_the_sampler_cli(tmp_path, monkeypatch):
    """A loop-written experiment; then `save_netg` of a generator with
    N(0,1)/sqrt(fan_in) weights as the EMA (the DDPM init makes outputs ~0):
    the JAX generator loaded from it by `load_torch_netg` gives the port's
    output (atol 1e-4), and the port's sampler CLI writes PNGs from it."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(**{**tiny_config().to_dict(), "dataset": "synthetic", "exp": "cross",
                    "limited_iter": 1, "num_epoch": 0, "batch_size": 2})
    state = loop.train(cfg, device=CPU)
    exp = exp_dir(tmp_path, "cross")
    jgen = JNCSNpp.from_config(JConfig(**tiny_config().to_dict()))
    template = _jax_template(jgen, cfg)
    load_torch_netg(str(exp / "netG_0.pth"), template["params"], template.get("buffers"))

    ema = dict(randomize_parameters_(NCSNpp.from_config(cfg), 5).named_parameters())
    ckpt.save_netg(exp, 7, state.gen, {k: v.detach() for k, v in ema.items()})
    params, _ = load_torch_netg(str(exp / "netG_7.pth"), template["params"],
                                template.get("buffers"))
    net = NCSNpp.from_config(cfg)
    net.load_state_dict(load_netg_pth(str(exp / "netG_7.pth")), strict=True)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([0, 3])
    z = rs.randn(2, cfg.nz).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: jgen.apply({"params": p}, jnp.asarray(x), jnp.asarray(t),
                                                   jnp.asarray(z), train=False))(params))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(t),
                         torch.from_numpy(z)).numpy().transpose(0, 2, 3, 1)
    assert np.std(want) > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    test_cli.main(["--dataset", "synthetic", "--exp", "cross", "--epoch_id", "7",
                   "--device", "cpu", "--seed", "1"])
    pngs = sorted((tmp_path / "generated_samples" / "synthetic").glob("sample_*.png"))
    assert len(pngs) == 2
    img = np.asarray(Image.open(pngs[0]))
    assert img.shape == (16, 16, 3) and img.std() > 5


def test_discriminator_large_through_the_loop(tmp_path, monkeypatch):
    """The disc_small 'no' path at 64² (DiscriminatorLarge's minimum),
    mirroring tests/test_train_step.py::test_large_d_train_e2e."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(**{**TINY, "image_size": 64, "ch_mult": [1, 2], "attn_resolutions": [8],
                    "seed": 5, "disc_small": "no", "num_epoch": 1, "exp": "larged"})
    state = loop.train(cfg, device=CPU)
    exp = exp_dir(tmp_path, "larged")
    losses = json.loads((exp / "losses.json").read_text())
    assert len(losses) == 2 and all(np.isfinite([e["G_loss"], e["D_loss"]]).all() for e in losses)
    assert type(state.disc).__name__ == "DiscriminatorLarge" and state.step == 4
    assert (exp / "content.pth").exists()
    net = NCSNpp.from_config(cfg)
    net.load_state_dict(load_netg_pth(str(exp / "netG_1.pth")), strict=True)
    assert all(torch.isfinite(p).all() for p in net.parameters())


def test_zero1_trains_at_world_size_one(tmp_path, monkeypatch):
    """optimizer_sharding 'zero1' without a process group: `Zero1Adam` with
    one shard, beside the replicated run of the same config. The first
    step's losses are equal (nothing has been updated yet), the weights stay
    within the JAX package's bounds between the modes (tests/test_zero1.py:
    rtol 3e-4, atol 3e-5), and content.pth holds the reference's Adam state
    in both, so either resumes the other."""
    monkeypatch.chdir(tmp_path)
    runs, first = {}, {}
    real_step = loop.make_train_step
    for mode in ("replicated", "zero1"):

        def recording(*a, **kw):
            step = real_step(*a, **kw)

            def rec(state, *args, **kws):
                m = step(state, *args, **kws)
                first.setdefault(mode, (float(m.errD), float(m.errG)))
                return m
            return rec

        monkeypatch.setattr(loop, "make_train_step", recording)
        runs[mode] = loop.train(Config(**TINY, exp=mode, optimizer_sharding=mode, num_epoch=1),
                                device=CPU)
    rep, z1 = runs["replicated"], runs["zero1"]
    assert type(z1.opt_G).__name__ == "Zero1Adam" and z1.opt_G.world == 1
    assert first["zero1"] == first["replicated"] and z1.step == rep.step == 4
    for a, b in ((z1.gen, rep.gen), (z1.disc, rep.disc)):
        for (k, p), q in zip(a.named_parameters(), b.parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=3e-4,
                                       atol=3e-5, err_msg=k)
    raws = {m: torch.load(exp_dir(tmp_path, m) / "content.pth", weights_only=False)
            for m in runs}
    for name in ("optimizerG", "optimizerD"):
        a, b = raws["zero1"][name], raws["replicated"][name]
        assert a["param_groups"] == b["param_groups"]
        assert [sorted(st) for st in a["state"].values()] == \
            [sorted(st) for st in b["state"].values()]
        for i, st in a["state"].items():
            assert float(st["step"]) == float(b["state"][i]["step"]) == 4.0
            np.testing.assert_allclose(st["exp_avg"].numpy(), b["state"][i]["exp_avg"].numpy(),
                                       rtol=3e-4, atol=3e-5)
    resumed = loop.train(Config(**TINY, exp="zero1", optimizer_sharding="replicated",
                                num_epoch=2, resume=True), device=CPU)
    assert resumed.step == 6 and type(resumed.opt_G).__name__ == "ClippedAdam"


# ---------------------------------------------------------------- the CLIs
ARGVS = {
    "flags_only": ["--batch_size", "9", "--dataset", "synthetic", "--ch_mult", "1", "2"],
    "config_file_default": ["--use_config_file", "True", "--batch_size", "7", "--dataset",
                            "synthetic", "--resume", "--no_lr_decay", "--centered"],
    "config_file_given": ["--use_config_file", "True", "--config_file", "given.json",
                          "--lazy_reg", "5", "--limited_iter", "3"],
    "config_file_existing": ["--use_config_file", "True", "--exp", "again"],
}


def _seed_configs(root):
    (root / "given.json").write_text(json.dumps({**JConfig().to_dict(), "image_size": 16,
                                                 "extra_key": [1, 2]}))
    (root / "configs").mkdir()
    (root / "configs" / "config.json").write_text(json.dumps(
        {**JConfig().to_dict(), "seed": 3, "synthetic_size": 64}))


@pytest.mark.parametrize("name", list(ARGVS))
def test_train_cli_merge_equals_the_jax_clis(name, tmp_path, monkeypatch):
    out = {}
    for kind, mod in (("jax", jtrain_cli), ("port", train_cli)):
        root = tmp_path / kind
        root.mkdir()
        monkeypatch.chdir(root)
        if name in ("config_file_given", "config_file_existing"):
            _seed_configs(root)
        cfg = mod.resolve_config(mod.build_parser().parse_args(ARGVS[name]))
        written = root / "configs" / "config.json"
        out[kind] = (vars(cfg), json.loads(written.read_text()) if written.exists() else None)
    assert out["port"] == out["jax"]
    assert (out["port"][1] is None) == (name == "flags_only")


@pytest.mark.parametrize("cli,argv", [
    ("train_cli", ["--use_config_file", "True", "--batch_size", "4", "--dataset", "synthetic"]),
    ("train_cli", ["--batch_size", "4", "--num_epoch", "1"]),
    ("main_cli", ["--dataset", "synthetic", "--exp", "m", "--batch_size", "4"]),
    ("main_cli", ["--config_file", "given.json", "--save_content"]),
])
def test_cli_mains_write_the_same_config(cli, argv, tmp_path, monkeypatch):
    """Each CLI's main with `train` swapped for a recorder: the config it
    trains from and configs/config.json equal the JAX package's."""
    monkeypatch.setenv("DDGAN_TORCH_DEVICE", "cpu")
    mods = {"jax": (jtrain_cli if cli == "train_cli" else jmain_cli, jtrain),
            "port": (train_cli if cli == "train_cli" else main_cli, ttrain)}
    out = {}
    for kind, (mod, pkg) in mods.items():
        root = tmp_path / kind
        root.mkdir()
        monkeypatch.chdir(root)
        if "given.json" in argv:
            _seed_configs(root)
        got = []
        monkeypatch.setattr(pkg, "train", lambda cfg, **kw: got.append(vars(cfg)))
        mod.main(list(argv))
        written = root / "configs" / "config.json"
        out[kind] = (got, json.loads(written.read_text()) if written.exists() else None)
    assert out["port"] == out["jax"] and len(out["port"][0]) == 1


def test_chip_smoke_reads_the_loop(tmp_path, monkeypatch, capsys):
    """What chip_smoke.py's loop phases read of a run: the loop's epoch
    lines, and the FIR calls by role of every step against
    `expected_run_calls` (counted on the CPU too)."""
    import importlib.util
    from pathlib import Path

    from ddgan_torch.ops import fir2x

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.chdir(tmp_path)
    fir2x.reset_launch_counts()
    loop.train(Config(num_epoch=2, exp="lines", **TINY), device=CPU)
    calls = {k: dict(v) for k, v in fir2x.CALLS.items()}
    epochs = cs.epoch_times(capsys.readouterr().out)
    assert [(e["epoch"], e["iters"]) for e in epochs] == [(0, 2), (1, 2), (2, 2)]
    assert calls == cs.expected_run_calls(range(6), TINY["lazy_reg"], 3, len(TINY["ch_mult"]) - 1,
                                          shared=False)
    rows = cs.loop_vs_bare(epochs, 2, TINY["lazy_reg"], {"bare": {"r1_step": 3.0,
                                                                  "plain_step": 1.0}}, 2)
    assert [(r["epoch"], r["r1_steps"], r["bare_ms_per_step"]) for r in rows] == [(1, 1, 2.0),
                                                                              (2, 1, 2.0)]


def test_profile_dir_traces_the_first_epoch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = Config.from_dict({**TINY, "num_epoch": 1, "exp": "prof",
                            "profile_dir": str(tmp_path / "prof")})
    loop.train(cfg, device=CPU)
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert '"traceEvents"' in traces[0].read_text()


def test_profile_dir_prints_the_spans_of_the_profiled_epoch(tmp_path, monkeypatch, capsys):
    """After the profiled epoch (2 steps, the first with R1) the loop prints
    one line per span of the port, a step, with its counters, and clears the
    recorder; the spans are in the epoch's trace too."""
    from ddgan_torch import trace

    monkeypatch.chdir(tmp_path)
    cfg = Config.from_dict({**TINY, "num_epoch": 1, "exp": "prof",
                            "profile_dir": str(tmp_path / "prof")})
    loop.train(cfg, device=CPU)
    lines = {ln.split(":")[0][len("span "):]: ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("span ")}
    assert {"ddgan.loop.batch", "ddgan.step", "ddgan.step.draws", "ddgan.step.d_update",
            "ddgan.step.r1", "ddgan.step.g_update", "ddgan.optim", "ddgan.ema", "ddgan.D",
            "ddgan.G.embed", "ddgan.G.down8", "ddgan.G.mid", "ddgan.G.up8",
            "ddgan.G.out"} <= set(lines)
    assert lines["ddgan.step"].startswith("span ddgan.step: 1.00 calls, host ")
    assert "ms, device - ms a step (in -)" in lines["ddgan.step"]
    assert lines["ddgan.step.r1"].startswith("span ddgan.step.r1: 0.50 calls")
    assert lines["ddgan.optim"].startswith("span ddgan.optim: 2.00 calls")
    assert "; fir2x.down2x.forward " in lines["ddgan.D"]
    assert trace.summary() == {}
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    assert '"name": "ddgan.step.d_update"' in path.read_text()
