"""Data parallelism in the port (`ddgan_torch.parallel`, the optimizers' and
the PSO step's rank means, `make_sharded_sampler`, the loop's loader and
seeds) against the JAX package's mesh, on the CPU.

Two gloo ranks run `tests/_torch_dist.py` (case "parallel") once for the
module; the JAX references are computed here.

- The train step on two ranks, replicated and ZeRO-1, against the JAX
  package's own composition on a two-device CPU mesh (the tiny flagship
  config, batch 4 per rank, dropout 0, injected draws per rank, weights as
  in tests/test_torch_train_step.py): per shard `value_and_grad` of the
  step's D and G losses (R1 at step 0, not at step 1), then `pmean` and
  `make_optimizer`, or `zero1_update_sharded`, then `apply_lr` and
  `ema_update`. Bounds are that file's: losses within 1e-4 relative, each
  gradient within 1e-4 of its largest magnitude, parameters and the EMA
  within 1e-5 absolute, but for the elements whose gradient is below Adam's
  eps (see the test). The two ranks' parameters and EMA are equal to the
  last bit.
- PSO on two ranks (swarm 3, trigger 2): the swarms stay equal to the last
  bit through an update, and the losses each rank buffers are the mean of
  the ranks' own.
- `make_sharded_sampler`: the two ranks' batch is two one-process
  `sample_from_model` calls with the ranks' generators, to the last bit.
- The loader: the ranks' index sets partition the dataset as the JAX
  `DataLoader` with num_shards=2 orders them; a failing loader raises.
- A run without a group is the one-process run of the tree before data
  parallelism, to the last bit (recorded losses.json and content.pth).
- `train_cli --num_process_per_node 2` spawns two ranks (`parallel.launch`)
  whose rank 0 writes the run, which one process resumes; a rank that
  fails fails the launch, and ranks past the launch's deadline are killed.
"""

import functools
import hashlib
import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh, PartitionSpec as P

from ddgan_tpu.data import DataLoader as JDataLoader
from ddgan_tpu.diffusion import DiffusionCoefficients as JCoeff
from ddgan_tpu.diffusion import PosteriorCoefficients as JPos
from ddgan_tpu.diffusion import q_sample_pairs_with_noise as jq_pairs
from ddgan_tpu.diffusion import sample_posterior_with_noise as jposterior
from ddgan_tpu.models import DiscriminatorSmall as JSmall
from ddgan_tpu.models import NCSNpp as JNCSNpp
from ddgan_tpu.train import make_optimizer as jmake_optimizer
from ddgan_tpu.train.ema import ema_update as jema_update
from ddgan_tpu.train.optim import apply_lr
from ddgan_tpu.train.zero1 import Zero1OptState, make_zero1_optimizer, zero1_update_sharded

from ddgan_torch.cli import train_cli
from ddgan_torch.compat import state_dict_from_flax
from ddgan_torch.config import Config
from ddgan_torch.data import SyntheticDataset
from ddgan_torch.diffusion import PosteriorCoefficients, sample_from_model
from ddgan_torch.models import NCSNpp
from ddgan_torch.parallel import launch
from ddgan_torch.train import loop
from ddgan_torch.utils import randomize_parameters_

from _torch_dist import hang, run_ranks
from _torch_port import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    flax_params_from_port,
    nchw,
    np_step_draws,
    one_torch_thread,
    random_flax_params,
    tiny_config,
)

B = 4  # per rank
WORLD = 2
LR = 1e-3
R1_GAMMA = 1.0
LAZY_REG = 2
EMA = 0.9
MODES = ("replicated", "zero1")


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _torch_draws(np_draws) -> list:
    return [torch.from_numpy(a).long() if a.ndim == 1 else
            (nchw(a) if a.ndim == 4 else torch.from_numpy(a)) for a in np_draws]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The weights, the global batch and draws, the JAX mesh references of
    both modes, and the two ranks' outputs."""
    cfg = tiny_config(dropout=0.0)
    jgen = JNCSNpp.from_config(cfg)
    jdisc = JSmall(nc=2 * cfg.num_channels, ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim)
    s = cfg.image_size
    x0, t0 = jnp.zeros((2, s, s, cfg.num_channels)), jnp.zeros((2,), jnp.int32)
    g_shapes = jax.eval_shape(lambda: jgen.init({"params": jax.random.PRNGKey(0),
                                                 "dropout": jax.random.PRNGKey(0)},
                                                x0, t0, jnp.zeros((2, cfg.nz))))
    gen = randomize_parameters_(NCSNpp.from_config(cfg), seed=0)
    params_G = flax_params_from_port(
        gen, jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), g_shapes))
    d_shapes = jax.eval_shape(jdisc.init, jax.random.PRNGKey(0), x0, t0, x0)["params"]
    params_D = jax.tree.map(jnp.asarray, random_flax_params(d_shapes, seed=1))
    real = np.random.RandomState(2).uniform(
        -1, 1, (WORLD * B, s, s, cfg.num_channels)).astype(np.float32)
    draws = [np_step_draws(cfg, WORLD * B, seed) for seed in (10, 11)]
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    grad_fns = _jax_shard_grads(cfg, jgen, jdisc, mesh)
    refs = {mode: _jax_mesh_steps(cfg, mesh, grad_fns, params_G, params_D, jnp.asarray(real),
                                  draws, mode) for mode in MODES}
    inputs = {"cfg": cfg.to_dict(), "g_sd": gen.state_dict(),
              "d_sd": state_dict_from_flax(jax.tree.map(np.asarray, params_D)),
              "real": nchw(real), "draws": [_torch_draws(d) for d in draws], "lr": LR,
              "r1_gamma": R1_GAMMA, "lazy_reg": LAZY_REG, "ema": EMA, "swarm_seed": 12,
              "data_seed": 13, "per_device_batch": 2, "sample_seed": 14}
    ranks = run_ranks("parallel", tmp_path_factory.mktemp("parallel"), inputs, WORLD)
    return cfg, inputs, refs, ranks


def _jax_mesh_steps(cfg, mesh, grad_fns, params_G, params_D, real, draws, mode):
    """The JAX package's step composed on a two-device mesh, at steps 0 and 1.
    Each network's per-shard `value_and_grad` is one compiled function for
    both modes and both steps (the R1 penalty is scaled by 1 on the R1 step
    and by 0 on the other); `pmean` and the optimizer, or
    `zero1_update_sharded`, are a second one per mode, over each network's
    parameters as one vector (the ZeRO-1 optimizer flattens them so itself;
    optax's clip and Adam are elementwise but for the norm's sum), which
    compiles in a fraction of the time of a tree."""
    zero1 = mode == "zero1"
    if zero1:
        tx_d = make_zero1_optimizer(cfg.beta1_d, cfg.beta2_d, 0.0, cfg.grad_clip_norm, WORLD)
        tx_g = make_zero1_optimizer(cfg.beta1_g, cfg.beta2_g, 0.0, cfg.grad_clip_norm, WORLD)
        opt_spec = Zero1OptState(mu=P("data"), nu=P("data"), count=P())
    else:
        tx_d = jmake_optimizer(cfg.beta1_d, cfg.beta2_d, 0.0, cfg.grad_clip_norm)
        tx_g = jmake_optimizer(cfg.beta1_g, cfg.beta2_g, 0.0, cfg.grad_clip_norm)
        opt_spec = P()
    clip = optax.clip_by_global_norm(cfg.grad_clip_norm)

    def update_local(tx, stacked, opt, params):
        """(new params, opt, the clipped mean gradient or None) from this
        shard's gradient vector (1, P)."""
        grads = stacked[0]
        if zero1:
            upd, opt = zero1_update_sharded(tx, grads, opt, params, "data")
            clipped = None
        else:
            grads = jax.lax.pmean(grads, "data")
            upd, opt = tx.update(grads, opt, params)
            clipped = clip.update(grads, None)[0]
        return optax.apply_updates(params, apply_lr(upd, LR)), opt, clipped

    update = {net: jax.jit(shard_map(functools.partial(update_local, tx), mesh=mesh,
                                     in_specs=(P("data"), opt_spec, P()),
                                     out_specs=(P(), opt_spec, P()), check_vma=False))
              for net, tx in (("D", tx_d), ("G", tx_g))}
    ema_step = jax.jit(lambda e, p: jema_update(e, p, EMA))
    d_grads, g_grads = grad_fns
    (pD, unravel_D), (pG, unravel_G) = ravel_pytree(params_D), ravel_pytree(params_G)
    opt_D, opt_G, ema = tx_d.init(pD), tx_g.init(pG), pG
    steps = []
    for i, dr in enumerate(draws):
        dr = [jnp.asarray(a) for a in dr]
        grads, (errD_real, errD_fake, penalty) = d_grads(
            jnp.float32(i % LAZY_REG == 0), unravel_D(pD), unravel_G(pG), real, *dr[:5])
        pD, opt_D, gD = update["D"](grads, opt_D, pD)
        grads, errG = g_grads(unravel_G(pG), unravel_D(pD), real, *dr[5:])
        pG, opt_G, gG = update["G"](grads, opt_G, pG)
        ema = ema_step(ema, pG)
        steps.append(jax.tree.map(np.asarray, dict(
            errD_real=errD_real, errD_fake=errD_fake, grad_penalty=penalty, errG=errG,
            gD=None if gD is None else unravel_D(gD), gG=None if gG is None else unravel_G(gG),
            params_G=unravel_G(pG), params_D=unravel_D(pD), ema=unravel_G(ema))))
    return steps


def _jax_shard_grads(cfg, jgen, jdisc, mesh):
    """Per-shard D and G gradients (stacked over the shards) and the
    `pmean`ed losses, as the JAX step computes them under shard_map."""
    coeff = JCoeff.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max)
    pos = JPos.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max)

    def apply_G(p, x, t, z):
        return jgen.apply({"params": p}, x, t, z, train=True)

    def apply_D(p, x, t, x_t):
        return jdisc.apply({"params": p}, x, t, x_t).reshape(-1).astype(jnp.float32)

    def stacked(tree):
        return ravel_pytree(tree)[0][None]

    def d_local(r1_on, pD, pG, real, t, nq, nn, z, npost):
        b = real.shape[0]
        x_t, x_tp1 = jq_pairs(coeff, real, t, nq, nn)
        x_pos = jposterior(pos, apply_G(pG, x_tp1, t, z), x_tp1, t, npost)

        def loss(p):
            errD_fake = jax.nn.softplus(apply_D(p, x_pos, t, x_tp1)).mean()
            errD_real = jax.nn.softplus(-apply_D(p, x_t, t, x_tp1)).mean()
            g = jax.grad(lambda xi: apply_D(p, xi, t, x_tp1).sum())(x_t)
            penalty = r1_on * R1_GAMMA / 2.0 * (g.reshape(b, -1) ** 2).sum(axis=1).mean()
            return errD_real + errD_fake + penalty, (errD_real, errD_fake, penalty)

        (_, aux), grads = jax.value_and_grad(loss, has_aux=True)(pD)
        return stacked(grads), jax.lax.pmean(aux, "data")

    def g_local(pG, pD, real, t, nq, nn, z, npost):
        _, x_tp1 = jq_pairs(coeff, real, t, nq, nn)

        def loss(p):
            x_pos = jposterior(pos, apply_G(p, x_tp1, t, z), x_tp1, t, npost)
            return jax.nn.softplus(-apply_D(pD, x_pos, t, x_tp1)).mean()

        errG, grads = jax.value_and_grad(loss)(pG)
        return stacked(grads), jax.lax.pmean(errG, "data")

    sm = functools.partial(shard_map, mesh=mesh, check_vma=False)
    data = (P("data"),) * 6
    return (jax.jit(sm(d_local, in_specs=(P(), P(), P()) + data, out_specs=(P("data"), P()))),
            jax.jit(sm(g_local, in_specs=(P(), P()) + data, out_specs=(P("data"), P()))))


def _assert_close(port: dict, jax_tree, bound, what, eps_floor=None, steps=1):
    """Each tensor within `bound` absolute, or with "rel" within 1e-4 of its
    largest magnitude (a gradient that is zero in exact arithmetic: below
    1e-10 of the tree's largest), as tests/test_torch_train_step.py does.
    `eps_floor`: the elements whose gradient was below Adam's eps (1e-8) at
    a step so far, held within lr per step instead (see the test)."""
    want = state_dict_from_flax(jax_tree)
    assert set(port) == set(want), what
    floor = 1e-10 * max(float(v.abs().max()) for v in want.values())
    for k, v in port.items():
        if bound != "rel":
            err = (v - want[k]).abs()
            if eps_floor is not None:
                assert float(torch.where(eps_floor[k], err, 0).max()) <= steps * LR, (what, k)
                err = torch.where(eps_floor[k], 0, err)
            assert float(err.max()) <= bound, (what, k)
        elif float(want[k].abs().max()) < floor:
            assert float(v.abs().max()) < 10 * floor, (what, k)
        else:
            assert rel_err(v.numpy(), want[k].numpy()) < 1e-4, (what, k)


@pytest.mark.parametrize("mode", MODES)
def test_two_rank_step_matches_the_jax_mesh(world, mode):
    """Parameters and the EMA are held within 1e-5 wherever the step's
    gradient is above Adam's eps, 1e-8. Below it an element moves by
    lr·g/(|g| + 1e-8), which the gradient's last digits decide: an element
    of D at 1.21e-9 here (1.43e-9 in JAX, within the gradient bound of 1e-4
    of its tensor's largest, 2.3e-2) moves 1.7e-5 apart. Those elements, 19
    of D's 195,937 and 5,341 of G's 229,283 at step 0, are held within lr
    per step, the most an Adam step moves a parameter."""
    cfg, _, refs, ranks = world
    floors = {"params_D": None, "params_G": None}
    for i, want in enumerate(refs[mode]):
        got = [r["steps"][mode][i] for r in ranks]
        for name in ("errD_real", "errD_fake", "errG", "grad_penalty"):
            # the loop means each rank's metrics once an epoch; here, per step
            mean = (got[0]["metrics"][name] + got[1]["metrics"][name]) / 2
            assert abs(float(mean) - want[name]) <= 1e-4 * abs(want[name]), (mode, i, name)
        assert (want["grad_penalty"] > 0) == (i == 0)
        for key in ("params_D", "params_G", "ema"):
            assert all(torch.equal(got[0][key][k], got[1][key][k]) for k in got[0][key]), key
        if mode == "replicated":
            _assert_close(got[0]["gD"], want["gD"], "rel", f"D grads, step {i}")
            _assert_close(got[0]["gG"], want["gG"], "rel", f"G grads, step {i}")
        for key, g in (("params_D", "gD"), ("params_G", "gG")):
            below = {k: v.abs() < 1e-8
                     for k, v in state_dict_from_flax(refs["replicated"][i][g]).items()}
            floors[key] = below if floors[key] is None else \
                {k: floors[key][k] | below[k] for k in below}
            share = sum(int(m.sum()) for m in floors[key].values()) / \
                sum(m.numel() for m in floors[key].values())
            assert share < 0.05, (key, share)
        _assert_close(got[0]["params_D"], want["params_D"], 1e-5, f"D, step {i}",
                      floors["params_D"], i + 1)
        _assert_close(got[0]["params_G"], want["params_G"], 1e-5, f"G, step {i}",
                      floors["params_G"], i + 1)
        _assert_close(got[0]["ema"], want["ema"], 1e-5, f"EMA, step {i}", floors["params_G"],
                      i + 1)


def test_pso_swarms_stay_equal_and_losses_are_the_rank_mean(world):
    _, _, _, ranks = world
    a, b = (r["pso"] for r in ranks)
    for name in ("pso_G", "pso_D"):
        assert int(a["swarms"][name]["iteration"]) == 1  # the third step fired
        for key, v in a["swarms"][name].items():
            w = b["swarms"][name][key]
            assert all(torch.equal(x, y) for x, y in zip(v, w)) if isinstance(v, list) \
                else torch.equal(v, w), (name, key)
    for key in ("params_G", "params_D", "ema"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), key
    assert all(torch.equal(x, y) for x, y in zip(a["buf"], b["buf"]))
    for i in range(3):
        for name in ("errD", "errG", "errD_real", "errD_fake"):
            mine, theirs = a["local"][i][name], b["local"][i][name]
            assert not torch.equal(mine, theirs), (i, name)  # the shards differ
            want = (mine + theirs) / 2
            assert torch.equal(a["meaned"][i][name], want), (i, name)
            assert torch.equal(b["meaned"][i][name], want), (i, name)


def test_sharded_sampler_is_one_process_calls_per_rank(world):
    cfg, inputs, _, ranks = world
    gen = NCSNpp.from_config(Config.from_dict(inputs["cfg"]))
    gen.load_state_dict(inputs["g_sd"])
    gen.eval()
    pos = PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                       device="cpu")
    want = []
    for r in range(WORLD):
        rng = torch.Generator().manual_seed(inputs["sample_seed"] + r)
        x = torch.randn((inputs["per_device_batch"], cfg.num_channels, cfg.image_size,
                         cfg.image_size), generator=rng)
        want.append(sample_from_model(pos, gen, cfg.num_timesteps, x, cfg.nz, rng))
    want = torch.cat(want)
    assert want.shape[0] == WORLD * inputs["per_device_batch"] and float(want.std()) > 0.05
    for r in ranks:
        assert torch.equal(r["sample"], want)


def test_loader_shards_partition_like_jax():
    ds = SyntheticDataset(n=20, image_size=4, num_channels=1, seed=0)
    args = Config(seed=9, num_workers=0)
    seen = []
    for shard in range(WORLD):
        port = loop.build_loader(args, ds, 3, WORLD, shard)
        ref = JDataLoader(ds, batch_size=3, shuffle=True, drop_last=True, num_shards=WORLD,
                          shard_id=shard, seed=9)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert np.array_equal(port._indices(), ref._indices())
            assert [np.array_equal(x, y) for (x, _), (y, _) in zip(port, ref)] == [True] * 3
        port.set_epoch(0)
        seen.append(port._indices())
    assert sorted(np.concatenate(seen).tolist()) == list(range(20))


def test_failing_loader_raises_on_two_ranks():
    class Broken(SyntheticDataset):
        def __len__(self):
            raise OSError("unreadable dataset")

    with pytest.raises(OSError, match="unreadable"):
        loop.build_loader(Config(seed=1), Broken(n=4), 2, WORLD, 1)


# the one-process loop (the run of test_group_less_run_is_unchanged, one
# torch thread), with G's AdaGN style bias starting at [1]*C + [0]*C as
# the JAX package's: losses.json's numbers and the sha256 of content.pth's
# tensors
GOLDEN_LOSSES = [(0.692864179611206, 1.3862614631652832),
                 (0.6925881505012512, 1.386259377002716)]
GOLDEN_CONTENT = {
    "netG_dict": "e73b565866c473a0f70b39cc86a5a45e5afe36095ea93613fcf8a5d8b9de56ad",
    "netD_dict": "c089c5c33a7ed64a2433d51cdca7261cfb6d5127c71fcf8745e52b3f2c3b3cf3",
    "optimizerG": "e3c69cf431200a00d6c1dbf70dbe501d7c88e9976333210110ead97bde4b705e",
    "optimizerD": "4df9fd6418b71c072f883696f136ac71b87451d7ed1580d34473cb88445562af",
    "emaG": "51f5549a24b6786b6835ca99e9cfb346693cbeb301eab676bde8a4fbf893319b",
}


def tensor_digest(obj) -> str:
    """sha256 over every tensor of a nested dict (sorted keys), with its path."""
    h = hashlib.sha256()

    def walk(o, path):
        if isinstance(o, torch.Tensor):
            h.update(path.encode())
            h.update(o.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(o, dict):
            for k in sorted(o, key=str):
                walk(o[k], f"{path}/{k}")
        elif isinstance(o, (list, tuple)):
            for i, v in enumerate(o):
                walk(v, f"{path}/{i}")

    walk(obj, "")
    return h.hexdigest()


def test_group_less_run_is_unchanged(tmp_path, monkeypatch):
    """Two epochs of two steps (R1 at 0 and 2, dropout 0.1, weight decay on
    G) without a process group: the same losses.json and content.pth
    tensors as the one-process loop before data parallelism."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(dataset="synthetic", image_size=8, num_channels=1, num_channels_dae=8,
                 ch_mult=[1], num_res_blocks=1, attn_resolutions=[4], nz=4, z_emb_dim=8,
                 n_mlp=1, t_emb_dim=8, ngf=4, num_timesteps=2, batch_size=2, limited_iter=2,
                 dropout=0.1, lazy_reg=2, ema_decay=0.999, use_ema=True, seed=21, num_epoch=1,
                 exp="golden", weight_decay_G=1e-3)
    loop.train(cfg, device="cpu")
    exp = tmp_path / "saved_info" / "dd_gan" / "synthetic" / "golden"
    losses = json.loads((exp / "losses.json").read_text())
    assert [(e["G_loss"], e["D_loss"]) for e in losses] == GOLDEN_LOSSES
    raw = torch.load(exp / "content.pth", weights_only=False)
    assert {k: tensor_digest(raw[k]) for k in GOLDEN_CONTENT} == GOLDEN_CONTENT


TINY_FLAGS = ["--dataset", "synthetic", "--image_size", "8", "--num_channels", "1",
              "--num_channels_dae", "8", "--ch_mult", "1", "--num_res_blocks", "1",
              "--attn_resolutions", "4", "--nz", "4", "--z_emb_dim", "8", "--n_mlp", "1",
              "--t_emb_dim", "8", "--ngf", "4", "--num_timesteps", "2", "--batch_size", "16"]


def test_train_cli_spawns_two_ranks(tmp_path, monkeypatch):
    """Two gloo ranks on the CPU through the CLI: 256 synthetic images, 8
    steps of 16 a rank in each of two epochs; rank 0 writes losses.json,
    content.pth and the netGs, and one process resumes the run."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DDGAN_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert train_cli.main(TINY_FLAGS + ["--exp", "two", "--num_epoch", "1",
                                        "--num_process_per_node", "2"],
                          init_method=f"file://{tmp_path}/rdzv", deadline_s=150) is None
    exp = tmp_path / "saved_info" / "dd_gan" / "synthetic" / "two"
    losses = json.loads((exp / "losses.json").read_text())
    assert [e["epoch"] for e in losses] == [1, 2]
    assert torch.load(exp / "content.pth", weights_only=False)["global_step"] == 16
    assert sorted(p.name for p in exp.glob("netG_*.pth")) == ["netG_0.pth", "netG_1.pth"]
    state = train_cli.main(TINY_FLAGS + ["--exp", "two", "--num_epoch", "2", "--resume"])
    assert (state.epoch, state.step) == (3, 16 + 16)


def test_a_failing_rank_fails_the_launch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DDGAN_TORCH_DEVICE", "cpu")
    with pytest.raises(RuntimeError, match="exited with"):
        train_cli.main(TINY_FLAGS + ["--dataset", "cifar10", "--data_dir",
                                     str(tmp_path / "absent"), "--num_process_per_node", "2"],
                       init_method=f"file://{tmp_path}/rdzv", deadline_s=150)


def test_launch_kills_ranks_past_its_deadline(tmp_path):
    args = types.SimpleNamespace(num_process_per_node=2, num_proc_node=1, node_rank=0,
                                 what_backend="gloo")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="deadline"):
        launch(args, hang, init_method=f"file://{tmp_path}/rdzv", device="cpu", deadline_s=15)
    assert time.monotonic() - t0 < 60
