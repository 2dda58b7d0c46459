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
     that JSON can hold, which the sampler CLI reads first.
  2. `netG_{epoch}.pth`: G's full `state_dict()` in the reference's key
     names, with the EMA swapped in for the parameters (ddgan.py:563-569).

Every file is written to `<name>.tmp` and then `os.replace`d into place, so
a kill during a write leaves the previous file whole.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Callable

import torch

from ..compat import strip_module_prefix
from .optim import cosine_lr
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


def save_content(exp_path: str | Path, state: TrainState, args: Any) -> None:
    """Write `content.pth` and `content_args.json` (ddgan.py:545-561)."""
    exp_path = Path(exp_path)
    exp_path.mkdir(parents=True, exist_ok=True)
    a = _args_dict(args)
    num_epoch = int(a.get("num_epoch", 0))
    content = _to_cpu({
        "epoch": int(state.epoch),
        "global_step": int(state.step),
        "args": a,
        "netG_dict": state.gen.state_dict(),
        "netD_dict": state.disc.state_dict(),
        "optimizerG": state.opt_G.state_dict(),
        "optimizerD": state.opt_D.state_dict(),
        "schedulerG": _scheduler_state(a.get("lr_g", 0.0), int(state.epoch), num_epoch),
        "schedulerD": _scheduler_state(a.get("lr_d", 0.0), int(state.epoch), num_epoch),
        EMA_KEY: state.ema_G,
    })
    _replace_into(exp_path / "content.pth", lambda tmp: torch.save(content, tmp))
    write_json(exp_path / "content_args.json", {k: v for k, v in a.items() if _json_ok(v)})


def load_content(exp_path: str | Path, state: TrainState) -> TrainState:
    """Restore `content.pth` into `state` in place (ddgan.py:371-410):
    weights, optimizers, the EMA shadow (when both have one), and the step
    and epoch counters. DDP 'module.' prefixes are stripped."""
    device = next(state.gen.parameters()).device
    raw = torch.load(Path(exp_path) / "content.pth", map_location=device, weights_only=False)
    state.gen.load_state_dict(strip_module_prefix(raw["netG_dict"]))
    state.disc.load_state_dict(strip_module_prefix(raw["netD_dict"]))
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
