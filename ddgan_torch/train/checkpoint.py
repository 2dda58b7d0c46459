"""Checkpoints in the reference's torch format (SURVEY.md §5).

Counterpart of `ddgan_tpu/train/checkpoint.py`, which writes flax msgpack;
this module writes what the reference writes (ddgan.py:545-569), so its
files load into the reference's tools and into the port's sampler CLI:

  1. `content.pth`: the whole train state, a dict with the reference's keys
     `epoch` (epochs done), `global_step`, `args` (a plain dict),
     `netG_dict`, `netD_dict`, `optimizerG`, `optimizerD` (the inner
     `torch.optim.Adam` state dicts), `schedulerG`, `schedulerD` (the state
     of the reference's per-epoch CosineAnnealingLR(T_max=num_epoch,
     eta_min=1e-5)), and the EMA shadow of G's parameters under `emaG` (the
     reference's name for its EMA, ddgan.py:517), keyed like
     `named_parameters()`. Beside it, `content_args.json` holds the args
     that JSON can hold, which the sampler CLI reads first. A PSO run's
     `optimizerG` / `optimizerD` hold its whole swarm instead (`PSOTrainState`:
     particles, velocities, personal and global bests with their scores,
     c1, c2, the iteration, the loss ring buffer and its count; tensors of a
     parameter keyed like `named_parameters()`), and it has no schedulers,
     so a resume continues bit for bit.
  2. `netG_{epoch}.pth`: G's full `state_dict()` in the reference's key
     names, with the EMA swapped in for the parameters (ddgan.py:563-569).

Every file is written to `<name>.tmp` and then `os.replace`d into place, so
a kill during a write leaves the previous file whole.

On several ranks every rank calls `optimizer_states`, since a ZeRO-1
optimizer's `state_dict` gathers the sharded moments from all of them
(`train/zero1.py`), and one process passes what it returns to
`save_content`. `load_content` runs on every rank, and a ZeRO-1 optimizer
keeps its slice of the moments it loads. The
optimizer state in `content.pth` is the reference's in either mode and at
any world size, so a run resumes across modes and world sizes without the
conversion that the JAX package's rows need
(`ddgan_tpu/train/checkpoint.py:114-212`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Callable

import torch

from ..compat import strip_module_prefix
from .optim import cosine_lr
from .pso_optim import PSOState
from .pso_step import PSOTrainState
from .state import TrainState

EMA_KEY = "emaG"


def _to_cpu(obj):
    """Tensors of a nested dict/list moved to the CPU, detached."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _replace_into(path: Path, write: Callable[[Path], None]) -> None:
    """write(tmp) then rename it onto `path`: a reader never sees half a file."""
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


def write_json(path: str | Path, obj) -> None:
    """JSON, indented as the JAX package writes it, replaced into place."""

    def write(tmp: Path) -> None:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=4)

    _replace_into(Path(path), write)


def _json_ok(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


def _args_dict(args: Any) -> dict:
    return dict(args) if isinstance(args, dict) else dict(vars(args))


def _scheduler_state(base_lr: float, epochs_done: int, num_epoch: int) -> dict:
    """The state dict of the reference's CosineAnnealingLR(T_max=num_epoch,
    eta_min=1e-5) after `epochs_done` epoch steps (ddgan.py:312-313, :524-526)."""
    return {"T_max": num_epoch, "eta_min": 1e-5, "base_lrs": [float(base_lr)],
            "last_epoch": epochs_done, "_step_count": epochs_done + 1,
            "_get_lr_called_within_step": False,
            "_last_lr": [cosine_lr(base_lr, epochs_done, num_epoch)]}


def _swarm_dict(swarm: PSOState, names: list[str], loss_buf: torch.Tensor,
                buf_count: int) -> dict:
    """A swarm and its network's loss buffer as a content.pth entry."""
    per_param = {f.name: dict(zip(names, getattr(swarm, f.name)))
                 for f in dataclasses.fields(PSOState) if isinstance(getattr(swarm, f.name), list)}
    scalars = {f.name: getattr(swarm, f.name) for f in dataclasses.fields(PSOState)
               if f.name not in per_param}
    return {**per_param, **scalars, "loss_buf": loss_buf, "buf_count": int(buf_count)}


def _swarm_from_dict(raw: dict, names: list[str]) -> PSOState:
    return PSOState(**{f.name: [raw[f.name][n] for n in names]
                       if isinstance(raw[f.name], dict) else raw[f.name]
                       for f in dataclasses.fields(PSOState)})


def _names(module: torch.nn.Module) -> list[str]:
    return [k for k, _ in module.named_parameters()]


def optimizer_states(state: TrainState | PSOTrainState) -> tuple[dict, dict] | None:
    """The Adam state dicts of G and D (None for a PSO run). Under ZeRO-1 a
    collective: every rank of the group calls it."""
    if isinstance(state, PSOTrainState):
        return None
    return state.opt_G.state_dict(), state.opt_D.state_dict()


def save_content(exp_path: str | Path, state: TrainState | PSOTrainState, args: Any,
                 opts: tuple[dict, dict] | None = None) -> None:
    """Write `content.pth` and `content_args.json` (ddgan.py:545-561). `opts`
    is what `optimizer_states(state)` returned, taken here when not given."""
    pso = isinstance(state, PSOTrainState)
    if opts is None:
        opts = optimizer_states(state)
    exp_path = Path(exp_path)
    exp_path.mkdir(parents=True, exist_ok=True)
    a = _args_dict(args)
    content = {
        "epoch": int(state.epoch),
        "global_step": int(state.step),
        "args": a,
        "netG_dict": state.gen.state_dict(),
        "netD_dict": state.disc.state_dict(),
        EMA_KEY: state.ema_G,
    }
    if pso:
        content["optimizerG"] = _swarm_dict(state.pso_G, _names(state.gen), state.loss_buf_G,
                                            state.buf_count_G)
        content["optimizerD"] = _swarm_dict(state.pso_D, _names(state.disc), state.loss_buf_D,
                                            state.buf_count_D)
    else:
        num_epoch = int(a.get("num_epoch", 0))
        content.update({
            "optimizerG": opts[0],
            "optimizerD": opts[1],
            "schedulerG": _scheduler_state(a.get("lr_g", 0.0), int(state.epoch), num_epoch),
            "schedulerD": _scheduler_state(a.get("lr_d", 0.0), int(state.epoch), num_epoch),
        })
    content = _to_cpu(content)
    _replace_into(exp_path / "content.pth", lambda tmp: torch.save(content, tmp))
    write_json(exp_path / "content_args.json", {k: v for k, v in a.items() if _json_ok(v)})


def load_content(exp_path: str | Path, state: TrainState | PSOTrainState):
    """Restore `content.pth` into `state` in place (ddgan.py:371-410):
    weights, optimizers or swarms, the EMA shadow (when both have one), and
    the step and epoch counters. DDP 'module.' prefixes are stripped."""
    device = next(state.gen.parameters()).device
    raw = torch.load(Path(exp_path) / "content.pth", map_location=device, weights_only=False)
    state.gen.load_state_dict(strip_module_prefix(raw["netG_dict"]))
    state.disc.load_state_dict(strip_module_prefix(raw["netD_dict"]))
    pso = isinstance(state, PSOTrainState)
    if pso != ("particles" in raw["optimizerG"]):
        raise ValueError(f"{exp_path}/content.pth holds {'an Adam' if pso else 'a PSO'} run; "
                         f"this run's kind_of_optim is {'pso' if pso else 'adam'}")
    if pso:
        for name, net in (("G", state.gen), ("D", state.disc)):
            opt = raw["optimizer" + name]
            setattr(state, "pso_" + name, _swarm_from_dict(opt, _names(net)))
            setattr(state, "loss_buf_" + name, opt["loss_buf"])
            setattr(state, "buf_count_" + name, int(opt["buf_count"]))
    else:
        state.opt_G.load_state_dict(raw["optimizerG"])
        state.opt_D.load_state_dict(raw["optimizerD"])
    ema = raw.get(EMA_KEY)
    if ema is not None and state.ema_G is not None:
        with torch.no_grad():
            for k, v in strip_module_prefix(ema).items():
                state.ema_G[k].copy_(v)
    state.step = int(raw["global_step"])
    state.epoch = int(raw["epoch"])
    return state


def load_content_args(exp_path: str | Path) -> dict:
    with open(Path(exp_path) / "content_args.json") as f:
        return json.load(f)


def save_netg(exp_path: str | Path, epoch: int, gen: torch.nn.Module,
              ema: dict[str, torch.Tensor] | None = None) -> Path:
    """Write `netG_{epoch}.pth`: G's weights, the EMA swapped in
    (ddgan.py:563-569). Returns its path."""
    exp_path = Path(exp_path)
    exp_path.mkdir(parents=True, exist_ok=True)
    sd = dict(gen.state_dict())
    if ema is not None:
        sd.update(ema)  # the EMA in place of the parameters it shadows
    sd = _to_cpu(sd)
    path = exp_path / f"netG_{epoch}.pth"
    _replace_into(path, lambda tmp: torch.save(sd, tmp))
    return path
