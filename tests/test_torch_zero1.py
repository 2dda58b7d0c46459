"""ZeRO-1 in the port (`ddgan_torch.train.zero1.Zero1Adam`) against the JAX
package's (`ddgan_tpu.train.zero1`), on the CPU.

- `Zero1Adam` on one rank and on two gloo ranks (`tests/_torch_dist.py`)
  against `zero1_update_sharded` under `shard_map` on a one- and a
  two-device JAX CPU mesh: the tiny flagship generator's parameter shapes,
  each rank's own gradients (their global norm is far above the clip of 1:
  the clip is engaged), weight decay 1e-3, three steps at lr 1e-3. Each
  step's update and the gathered moments, unpacked per parameter, within
  1e-6 of their largest magnitude (the same float32 formula). The
  gradients are whole quarters in [-1, 1], so that every sum of squares,
  and with it the clip's scale, is exact in float32 whatever the order of
  the sum: with N(0, 1) gradients an element where the clipped gradient
  and wd·p cancel to ~1e-9 turns the norm's last-bit difference into ~1e-4
  of its update, g / (|g| + 1e-8), on either side.
- Resume across modes and world sizes: a one-rank replicated `content.pth`
  loads into two ZeRO-1 ranks, which write it again, and that file loads
  into one replicated rank; every moment, step count and weight is equal
  to the last bit at each stage.
- A JAX ZeRO-1 `content.ckpt` (moment rows of 2 and 4 shards) loads into the
  port equal, to the last bit, to what the JAX package's own
  `_adapt_one_opt` makes of it in the replicated layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from flax import serialization

from ddgan_tpu.train import checkpoint as jckpt
from ddgan_tpu.train import make_optimizer as jmake_optimizer
from ddgan_tpu.train.optim import apply_lr
from ddgan_tpu.train.state import TrainState as JTrainState
from ddgan_tpu.train.zero1 import Zero1OptState, make_zero1_optimizer, zero1_update_sharded

from ddgan_torch.compat import content, flax_tree_from_port
from ddgan_torch.config import Config
from ddgan_torch.train import build_adam_state, build_models
from ddgan_torch.train import checkpoint as ckpt

from _torch_dist import _zero1_updates, run_ranks
from _torch_port import one_torch_thread, tiny_config  # noqa: F401  (an autouse fixture)

LR = 1e-3
WD = 1e-3
STEPS = 3


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def adam_inputs():
    """The tiny flagship G's parameters (in the port's order), and three
    steps of two ranks' gradients, from numpy seeds."""
    cfg = tiny_config()
    gen, _ = build_models(Config.from_dict(cfg.to_dict()), torch.Generator().manual_seed(0))
    rs = np.random.RandomState(5)
    params = [torch.from_numpy(rs.randn(*p.shape).astype(np.float32) * 0.1)
              for p in gen.parameters()]
    grads = [[[torch.from_numpy((rs.randint(-4, 5, p.shape) / 4).astype(np.float32))
               for p in params] for _ in range(2)] for _ in range(STEPS)]
    return {"params": params, "grads": grads, "b1": cfg.beta1_g, "b2": cfg.beta2_g, "wd": WD,
            "clip": cfg.grad_clip_norm, "lr": LR, "cfg": cfg.to_dict()}


def _jax_updates(inp, world: int) -> list:
    """`zero1_update_sharded` on a `world`-device mesh: each step's update
    and moments (flat, padding cut), params updated by `apply_lr`. The
    parameters go in as one vector in the port's order: the JAX optimizer
    flattens its tree into that vector first, and one leaf compiles fast."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    opt = make_zero1_optimizer(inp["b1"], inp["b2"], inp["wd"], inp["clip"], world)

    def flat(tensors):
        return jnp.asarray(np.concatenate([t.numpy().reshape(-1) for t in tensors]))

    params = {"p": flat(inp["params"])}
    spec = Zero1OptState(mu=P("data"), nu=P("data"), count=P())

    def local(g, st, p):
        return zero1_update_sharded(opt, jax.tree.map(lambda x: x[0], g), st, p, "data")

    update = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("data"), spec, P()),
                               out_specs=(P(), spec), check_vma=False))
    st, total = opt.init(params), int(params["p"].size)
    out = []
    for grads in inp["grads"]:
        upd, st = update({"p": jnp.stack([flat(grads[r]) for r in range(world)])}, st, params)
        params = jax.tree.map(lambda p, u: p + u, params, apply_lr(upd, LR))
        out.append({"update": np.asarray(upd["p"]),
                    "mu": np.asarray(st.mu).reshape(-1)[:total],
                    "nu": np.asarray(st.nu).reshape(-1)[:total],
                    "count": int(st.count), "rows": tuple(st.mu.shape)})
    return out


@pytest.fixture(scope="module")
def two_ranks(adam_inputs, tmp_path_factory):
    """Both cases of `_torch_dist.py` on two gloo ranks: the updates, and the
    resume of a one-rank replicated content.pth (written here first)."""
    root = tmp_path_factory.mktemp("zero1")
    cfg = Config.from_dict(adam_inputs["cfg"])
    gen, disc = build_models(cfg, torch.Generator().manual_seed(2))
    state = build_adam_state(cfg, gen, disc)
    rs = np.random.RandomState(7)
    for _ in range(2):
        for p in [*gen.parameters(), *disc.parameters()]:
            p.grad = torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
        state.opt_G.step(LR)
        state.opt_D.step(LR)
    state.step, state.epoch = 2, 1
    ckpt.save_content(root / "replicated", state, cfg)
    inputs = {**adam_inputs, "src": str(root / "replicated"), "dst": str(root / "zero1")}
    return root, run_ranks("zero1", root / "ranks", inputs)


@pytest.mark.parametrize("world", [1, 2])
def test_zero1_adam_matches_jax_sharded_update(adam_inputs, world, request):
    got = (_zero1_updates(adam_inputs, None) if world == 1
           else request.getfixturevalue("two_ranks")[1][0]["updates"])
    want = _jax_updates(adam_inputs, world)
    sizes = [p.numel() for p in adam_inputs["params"]]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["shard"] == (w["rows"][1], sum(sizes)), f"step {i}: shard"
        assert rel_err(g["update"].numpy(), w["update"]) < 1e-6, f"step {i}: update"
        for key, jkey in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            for k, (t, n) in enumerate(zip(g[key], np.split(w[jkey], np.cumsum(sizes)[:-1]))):
                assert rel_err(t.numpy().reshape(-1), n) < 1e-6, (i, key, k)
        assert g["step"] == [float(w["count"])] * len(sizes) == [float(i + 1)] * len(sizes)
    # the clip engaged: the mean gradient's norm is far above 1
    g0 = [(a + b) / 2 for a, b in zip(*adam_inputs["grads"][0][:world])] if world == 2 \
        else adam_inputs["grads"][0][0]
    assert float(torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in g0]))) > 10


def test_two_ranks_update_alike(two_ranks):
    """Both ranks apply the same gathered update and see the same moments."""
    a, b = (r["updates"] for r in two_ranks[1])
    for s_a, s_b in zip(a, b):
        assert torch.equal(s_a["update"], s_b["update"])
        assert all(torch.equal(x, y) for x, y in zip(s_a["exp_avg_sq"], s_b["exp_avg_sq"]))


def _opt_tensors(sd: dict) -> list:
    return [(i, k, v) for i, st in sorted(sd["state"].items()) for k, v in sorted(st.items())]


def _assert_content_equal(a: dict, b: dict) -> None:
    for name in ("optimizerG", "optimizerD"):
        ta, tb = _opt_tensors(a[name]), _opt_tensors(b[name])
        assert [x[:2] for x in ta] == [x[:2] for x in tb] and len(ta) > 0, name
        for (i, k, x), (_, _, y) in zip(ta, tb):
            assert x.dtype == y.dtype and torch.equal(x, y), (name, i, k)
        assert a[name]["param_groups"] == b[name]["param_groups"], name
    for name in ("netG_dict", "netD_dict", ckpt.EMA_KEY):
        assert all(torch.equal(a[name][k], b[name][k]) for k in a[name]), name
    assert (a["epoch"], a["global_step"]) == (b["epoch"], b["global_step"])


def test_resume_across_modes_and_world_sizes(two_ranks):
    """replicated (1 rank) -> ZeRO-1 (2 ranks) -> replicated (1 rank)."""
    root, ranks = two_ranks
    first = torch.load(root / "replicated" / "content.pth", weights_only=False)
    second = torch.load(root / "zero1" / "content.pth", weights_only=False)
    _assert_content_equal(second, first)
    # each rank loaded its half of the flat moments
    flat = torch.cat([first["optimizerG"]["state"][i]["exp_avg"].reshape(-1)
                      for i in sorted(first["optimizerG"]["state"])])
    shard = ranks[0]["resume"]["shards"][0]
    assert shard == -(-flat.numel() // 2)
    for r, out in enumerate(ranks):
        want = torch.nn.functional.pad(flat, (0, 2 * shard - flat.numel()))[r * shard:
                                                                            (r + 1) * shard]
        assert torch.equal(out["resume"]["slices"][0], want) and out["resume"]["step"] == 2

    cfg = Config.from_dict(first["args"])
    state = build_adam_state(cfg, *build_models(cfg, torch.Generator().manual_seed(3)))
    ckpt.load_content(root / "zero1", state)
    third = {"optimizerG": state.opt_G.state_dict(), "optimizerD": state.opt_D.state_dict(),
             "netG_dict": state.gen.state_dict(), "netD_dict": state.disc.state_dict(),
             ckpt.EMA_KEY: state.ema_G, "epoch": state.epoch, "global_step": state.step}
    _assert_content_equal(third, first)


@pytest.mark.parametrize("shards", [2, 4])
def test_jax_zero1_content_ckpt_loads_as_jax_adapts_it(adam_inputs, shards, tmp_path):
    """A JAX content.ckpt whose opt_G and opt_D are ZeRO-1 rows of `shards`
    shards (random moments, zero padding, count 3)."""
    cfg = Config.from_dict(adam_inputs["cfg"])
    gen, disc = build_models(cfg, torch.Generator().manual_seed(4))
    pG = flax_tree_from_port(gen, dict(gen.named_parameters()))
    pD = flax_tree_from_port(disc, dict(disc.named_parameters()))
    rs = np.random.RandomState(shards)

    def rows(tree):
        total = sum(a.size for a in jax.tree.leaves(tree))
        shard = -(-total // shards)
        flat = np.zeros(shards * shard, np.float32)
        flat[:total] = rs.rand(total).astype(np.float32)
        return flat.reshape(shards, shard)

    jstate = JTrainState(
        params_G=pG, params_D=pD, buffers_G={}, ema_G=pG, step=np.int32(3), epoch=np.int32(1),
        opt_G=Zero1OptState(mu=rows(pG), nu=rows(pG), count=np.int32(3)),
        opt_D=Zero1OptState(mu=rows(pD), nu=rows(pD), count=np.int32(3)))
    jckpt.save_content(tmp_path, jstate, cfg.to_dict())
    raw = serialization.msgpack_restore((tmp_path / "content.ckpt").read_bytes())

    state = content.load_content_ckpt(tmp_path, content.empty_state(cfg, "cpu"))
    assert (state.step, state.epoch) == (3, 1)
    for name, params, opt, module in (("opt_G", pG, state.opt_G, state.gen),
                                      ("opt_D", pD, state.opt_D, state.disc)):
        template = jmake_optimizer(0.5, 0.9, cfg.weight_decay_G, cfg.grad_clip_norm).init(params)
        adapted = jckpt._adapt_one_opt(raw[name], template, params, name)
        adam = jckpt._find_adam_state_dict(adapted)
        sd = opt.state_dict()["state"]
        assert len(sd) == len(list(module.parameters()))
        for key, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            want = content.state_dict_from_flax(jax.tree.map(np.asarray, adam[moment]))
            for i, (n, _) in enumerate(module.named_parameters()):
                assert torch.equal(sd[i][key], want[n]), (name, key, n)
        assert all(float(st["step"]) == float(adam["count"]) == 3.0 for st in sd.values())
