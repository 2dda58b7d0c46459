"""A training run between the packages: the JAX package's `content.ckpt`
and the port's `content.pth`, both ways, for Adam and PSO runs.

`content.ckpt` is flax msgpack of the JAX train state's state dict
(`ddgan_tpu/train/checkpoint.py:38-50`), with `content_args.json` beside
it: `TrainState` (params_G, params_D, buffers_G, opt_G, opt_D, ema_G, step,
epoch) or `PSOTrainState` (`ddgan_tpu/train/pso_step.py:34-47`: the two
swarms and the loss ring buffers in place of the optax states).

  * JAX to port (`load_flax_content`, `load_content_ckpt`): the weights, the
    EMA and every swarm array go through `state_dict_from_flax`, a swarm
    array's members each alike. The optax chain (`ddgan_tpu/train/optim.py:
    23-36`: clip, then add_decayed_weights when wd != 0, then scale_by_adam)
    keeps state in its scale_by_adam element only, found by its count/mu/nu
    keys (as `_find_adam_state_dict`, `checkpoint.py:74-83`); mu, nu and
    count become `torch.optim.Adam`'s exp_avg, exp_avg_sq and step, in
    `ClippedAdam`'s parameter order.
  * Port to JAX (`flax_content`, `write_content_ckpt`): the same trees
    rebuilt in the layout and order that `serialization.to_state_dict`
    gives for the JAX template of the run (`compat/weights.flax_tree_from_port`;
    the chain's elements from the optimizer's clip and weight decay),
    written with `write_msgpack`. `ddgan_tpu.train.checkpoint.load_content`
    loads it.

`buffers_G`, the Fourier embedding's projection when the generator has
one, goes into the generator's state_dict with its parameters and comes
back out of it; Adam, the EMA and the swarms cover the parameters only, as
in the JAX package. A ZeRO-1 state raises (ROADMAP.md Queue 1 item 7).

    python -m ddgan_torch.compat.content saved_info/dd_gan/<dataset>/<exp> --to pth
    python -m ddgan_torch.compat.content saved_info/dd_gan/<dataset>/<exp> --to ckpt

converts an experiment directory; the state passes through the device
(`cuda` unless `--device cpu` or $DDGAN_TORCH_DEVICE says otherwise).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..config import Config
from ..train import checkpoint as ckpt
from ..train.ema import ema_init
from ..train.loop import build_adam_state, build_models
from ..train.optim import ClippedAdam
from ..train.pso_optim import PSOState
from ..train.pso_step import BUF, PSOTrainState
from ..train.state import TrainState
from .msgpack import read_msgpack, write_msgpack
from .weights import flax_tree_from_port, flax_trees_from_port, state_dict_from_flax

_SWARM_PER_PARAM = {"particles": 1, "velocities": 1, "pbest_pos": 1, "gbest_pos": 0}


def _refuse_unported(raw: dict) -> None:
    for name in ("opt_G", "opt_D"):
        if isinstance(raw.get(name), dict) and isinstance(raw[name].get("mu"), np.ndarray):
            raise NotImplementedError(
                f"content.ckpt's {name} is a ZeRO-1 state (optimizer_sharding 'zero1'), which is "
                "not ported to ddgan_torch yet (ROADMAP.md Queue 1 item 7); resume it in the JAX "
                "package with optimizer_sharding 'replicated' first.")


def _adam_element(opt: dict) -> dict:
    """The scale_by_adam state of a serialized optax chain ({"0": {}, ...})."""
    for v in opt.values():
        if isinstance(v, dict) and {"count", "mu", "nu"} <= set(v):
            return v
    raise ValueError(f"no Adam state (count, mu, nu) in the optimizer state {sorted(opt)}")


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.array(a), dtype=dtype, device=device)


def _swarm_from_flax(raw: dict, module: torch.nn.Module, device) -> PSOState:
    names = ckpt._names(module)
    lists = {k: state_dict_from_flax(raw[k], lead=lead) for k, lead in _SWARM_PER_PARAM.items()}
    return PSOState(
        **{k: [v[n].to(device) for n in names] for k, v in lists.items()},
        **{k: _tensor(raw[k], device) for k in ("pbest_scores", "gbest_score", "c1", "c2")},
        iteration=_tensor(raw["iteration"], device, torch.int32),
    )


def _adam_from_flax(raw_opt: dict, opt: ClippedAdam, module: torch.nn.Module) -> None:
    adam = _adam_element(raw_opt)
    count = int(adam["count"])
    sd = opt.state_dict()
    sd["state"] = {}
    if count:
        mu, nu = state_dict_from_flax(adam["mu"]), state_dict_from_flax(adam["nu"])
        sd["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[n],
                           "exp_avg_sq": nu[n]} for i, n in enumerate(ckpt._names(module))}
    opt.load_state_dict(sd)


def load_flax_content(raw: dict, state: TrainState | PSOTrainState):
    """Restore a JAX `content.ckpt`'s state dict (`read_msgpack` of the file)
    into the port's `state`, in place; returns it."""
    _refuse_unported(raw)
    pso = isinstance(state, PSOTrainState)
    if pso != ("pso_G" in raw):
        raise ValueError(f"content.ckpt holds {'an Adam' if pso else 'a PSO'} run; this run's "
                         f"kind_of_optim is {'pso' if pso else 'adam'}")
    device = next(state.gen.parameters()).device
    state.gen.load_state_dict(state_dict_from_flax(raw["params_G"], raw.get("buffers_G")))
    state.disc.load_state_dict(state_dict_from_flax(raw["params_D"]))
    if raw.get("ema_G") is not None and state.ema_G is not None:
        with torch.no_grad():
            for k, v in state_dict_from_flax(raw["ema_G"]).items():
                state.ema_G[k].copy_(v)
    if pso:
        for name, net in (("G", state.gen), ("D", state.disc)):
            setattr(state, "pso_" + name, _swarm_from_flax(raw["pso_" + name], net, device))
            setattr(state, "loss_buf_" + name, _tensor(raw["loss_buf_" + name], device))
            setattr(state, "buf_count_" + name, int(raw["buf_count_" + name]))
    else:
        _adam_from_flax(raw["opt_G"], state.opt_G, state.gen)
        _adam_from_flax(raw["opt_D"], state.opt_D, state.disc)
    state.step, state.epoch = int(raw["step"]), int(raw["epoch"])
    return state


def load_content_ckpt(exp_path: str | Path, state: TrainState | PSOTrainState):
    """Restore `exp_path/content.ckpt`, written by the JAX package, into `state`."""
    return load_flax_content(read_msgpack((Path(exp_path) / "content.ckpt").read_bytes()), state)


# ---------------------------------------------------------------- port to JAX
def _int32(v) -> np.ndarray:
    return np.asarray(int(v), np.int32)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32, copy=False)


def _optax_chain(opt: ClippedAdam, module: torch.nn.Module) -> dict:
    """The state dict of the JAX package's `make_optimizer` chain for `opt`."""
    elements = []
    if opt.grad_clip_norm is not None and opt.grad_clip_norm > 0:
        elements.append({})  # clip_by_global_norm: no state
    if opt.adam.param_groups[0]["weight_decay"]:
        elements.append({})  # add_decayed_weights: no state
    st = opt.adam.state
    count = int(st[opt.params[0]]["step"]) if opt.params[0] in st else 0
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        moments[key] = {n: st[p][key] if p in st else torch.zeros_like(p)
                        for n, p in zip(ckpt._names(module), opt.params)}
    elements.append({"count": _int32(count),
                     "mu": flax_tree_from_port(module, moments["exp_avg"]),
                     "nu": flax_tree_from_port(module, moments["exp_avg_sq"])})
    return {str(i): e for i, e in enumerate(elements)}


def _swarm_to_flax(swarm: PSOState, module: torch.nn.Module) -> dict:
    names = ckpt._names(module)
    out = {}
    for f in dataclasses.fields(PSOState):
        v = getattr(swarm, f.name)
        if f.name in _SWARM_PER_PARAM:
            out[f.name] = flax_tree_from_port(module, dict(zip(names, v)),
                                              lead=_SWARM_PER_PARAM[f.name])
        else:
            out[f.name] = _int32(v) if f.name == "iteration" else _f32(v)
    return out


def flax_content(state: TrainState | PSOTrainState) -> dict:
    """The port's `state` as the JAX package's train-state state dict."""
    gen, disc = state.gen, state.disc
    params_G, buffers_G = flax_trees_from_port(gen, gen.state_dict())
    out = {
        "params_G": params_G,
        "params_D": flax_tree_from_port(disc, dict(disc.named_parameters())),
        "buffers_G": buffers_G,
    }
    ema = None if state.ema_G is None else flax_tree_from_port(gen, state.ema_G)
    if isinstance(state, PSOTrainState):
        out.update({"pso_G": _swarm_to_flax(state.pso_G, gen),
                    "pso_D": _swarm_to_flax(state.pso_D, disc), "ema_G": ema,
                    "loss_buf_G": _f32(state.loss_buf_G), "loss_buf_D": _f32(state.loss_buf_D),
                    "buf_count_G": _int32(state.buf_count_G),
                    "buf_count_D": _int32(state.buf_count_D)})
    else:
        out.update({"opt_G": _optax_chain(state.opt_G, gen),
                    "opt_D": _optax_chain(state.opt_D, disc), "ema_G": ema})
    out.update({"step": _int32(state.step), "epoch": _int32(state.epoch)})
    return out


def write_content_ckpt(exp_path: str | Path, state: TrainState | PSOTrainState, args) -> None:
    """Write `content.ckpt` and `content_args.json` as the JAX package's
    `save_content` does (each replaced into place)."""
    exp_path = Path(exp_path)
    exp_path.mkdir(parents=True, exist_ok=True)
    payload = write_msgpack(flax_content(state))
    ckpt._replace_into(exp_path / "content.ckpt", lambda tmp: tmp.write_bytes(payload))
    a = ckpt._args_dict(args)
    ckpt.write_json(exp_path / "content_args.json",
                    {k: v for k, v in a.items() if ckpt._json_ok(v)})


# ---------------------------------------------------------------- the converter
def empty_state(cfg: Config, device) -> TrainState | PSOTrainState:
    """A state of `cfg`'s run on `device` for a checkpoint to fill: the
    models, and Adam optimizers or (for PSO) no swarms yet."""
    gen, disc = (m.to(device) for m in build_models(cfg))
    if str(cfg.kind_of_optim).lower() == "pso":
        return PSOTrainState(gen, disc, None, None, ema_init(gen),
                             torch.zeros(BUF, device=device), torch.zeros(BUF, device=device))
    return build_adam_state(cfg, gen, disc)


def convert(exp_path: str | Path, to: str, device=None) -> dict:
    """content.ckpt → content.pth (to='pth') or back (to='ckpt') in one
    experiment directory. Returns the bytes and seconds of the read and the
    write."""
    exp_path, device = Path(exp_path), resolve_device(device)
    t0 = time.perf_counter()
    if to == "pth":
        src, dst = exp_path / "content.ckpt", exp_path / "content.pth"
        raw = read_msgpack(src.read_bytes())
        args = json.loads((exp_path / "content_args.json").read_text())
        state = load_flax_content(raw, empty_state(Config.from_dict(args), device))
    elif to == "ckpt":
        src, dst = exp_path / "content.pth", exp_path / "content.ckpt"
        args = torch.load(src, map_location="cpu", mmap=True, weights_only=False)["args"]
        state = ckpt.load_content(exp_path, empty_state(Config.from_dict(dict(args)), device))
    else:
        raise ValueError(f"to must be 'pth' or 'ckpt', got {to!r}")
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if to == "pth":
        ckpt.save_content(exp_path, state, args)
    else:
        write_content_ckpt(exp_path, state, args)
    return {"read": str(src), "read_bytes": src.stat().st_size, "read_s": read_s,
            "wrote": str(dst), "write_bytes": dst.stat().st_size,
            "write_s": time.perf_counter() - t0, "epoch": state.epoch, "step": state.step}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="content.ckpt (JAX package) <-> content.pth (port)")
    p.add_argument("exp_path", help="the experiment directory, saved_info/dd_gan/<dataset>/<exp>")
    p.add_argument("--to", choices=["pth", "ckpt"], required=True)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; also $DDGAN_TORCH_DEVICE")
    a = p.parse_args(argv)
    out = convert(a.exp_path, a.to, a.device)
    print(f"{out['read']} ({out['read_bytes']} bytes, {out['read_s']:.3f} s) -> {out['wrote']} "
          f"({out['write_bytes']} bytes, {out['write_s']:.3f} s); epoch {out['epoch']}, "
          f"global step {out['step']}")
    return out


if __name__ == "__main__":
    main()
