"""Hyperparameter evaluation backends for the PSO outer loop, on the GPU.

Counterpart of `ddgan_tpu/pso/evaluate.py` (reference protocol:
pso.py:314-358): write a temporary config with exp=pso_eval_{id} and a
short num_epoch, train, score, clean up. Two backends:

  * in-process (default): `ddgan_torch.train.train` on the device that
    `make_evaluator` resolved (`cuda` unless the CPU is asked for). The
    kernels are built once per process, not once per particle;
  * subprocess: `python -m ddgan_torch.cli.train_cli --use_config_file True
    --config_file ...` (the reference shells out to train_ddgan.py,
    pso.py:386-402, which is the JAX package's here), with this package on
    PYTHONPATH and the resolved device in $DDGAN_TORCH_DEVICE.

FID (the pso.py surface's combined score) runs the port's sampler CLI with
--compute_fid (pso.py:425-466); the real set is written from the config's
slice list (`data.converters.nii_to_png`) when `real_images` holds fewer
than 100 files. A failed evaluation scores inf, as in the reference; a
subprocess that exits non-zero is a failed evaluation (`utils.run_bash_command`
raises with its standard error, which the log keeps).
"""

from __future__ import annotations

import logging
import os
import random
import shlex
import shutil
import sys
from pathlib import Path
from typing import Callable, Dict

import torch

from .._device import ENV_VAR, resolve_device
from ..config import Config, load_json_to_dict, save_dict_to_json
from ..utils import run_bash_command
from .scoring import combined_score, compute_loss, loss_stability_score

logger = logging.getLogger("ddgan_torch.pso")

_ROOT = Path(__file__).resolve().parents[2]  # the directory that holds ddgan_torch/


def prepare_config(
    base_config_path: str, hyperparams: Dict, unique_id: int, num_epoch: int = 1
):
    """Temp config with exp=pso_eval_{id} and a short num_epoch —
    1 for the pso.py surface (pso.py:362-383), 5 for the pso-optim.py
    surface (pso-optim.py:366)."""
    config = load_json_to_dict(base_config_path)
    config.update(hyperparams)
    config["exp"] = f"pso_eval_{unique_id}"
    config["num_epoch"] = int(num_epoch)
    config["seed"] = config.get("seed", 42)
    new_path = f"./configs/config_{unique_id}.json"
    save_dict_to_json(config, new_path)
    return new_path, config


def cleanup_experiment(config: Dict, unique_id: int) -> None:
    """Remove temp experiment dirs/configs. (pso.py:488-515)"""
    exp_path = os.path.join("./saved_info/dd_gan", str(config["dataset"]), str(config["exp"]))
    if os.path.exists(exp_path):
        shutil.rmtree(exp_path)
    gen_dir = os.path.join(
        config.get("save_dir", "."), f"generated_samples_{config['exp']}"
    )
    if os.path.exists(gen_dir):
        shutil.rmtree(gen_dir)
    for p in (f"./configs/config_{unique_id}.json",
              os.path.join("./saved_info/", f"fid_score_{unique_id}.txt")):
        if os.path.exists(p):
            os.remove(p)


def check_pool(mode: str, device: torch.device, use_multiprocessing: bool) -> None:
    """Refuse a pool of forked workers around the in-process evaluator on a
    CUDA device: a forked process cannot use CUDA."""
    if use_multiprocessing and mode == "inprocess" and device.type == "cuda":
        raise RuntimeError(
            "use_multiprocessing evaluates particles in forked processes, which cannot use "
            "CUDA; with eval_mode 'inprocess' on the GPU, run without --use_multiprocessing, "
            "or use --eval_mode subprocess.")


def _port_command(device: torch.device, module: str, args: str) -> str:
    """`python -m ddgan_torch.<module> args` with this package importable and
    the device fixed, from any working directory."""
    path = os.pathsep.join(filter(None, [str(_ROOT), os.environ.get("PYTHONPATH")]))
    return (f"env PYTHONPATH={shlex.quote(path)} {ENV_VAR}={device.type} "
            f"{shlex.quote(sys.executable)} -m ddgan_torch.{module} {args}")


def make_evaluator(
    base_config_path: str = "./configs/config.json",
    mode: str = "inprocess",
    scoring: str = "stability",
    with_fid: bool = False,
    eval_num_epoch: int = 1,
    device: str | torch.device | None = None,
) -> Callable[[Dict, int], float]:
    """Build evaluate(position, seed) -> score.

    scoring: 'stability' (pso-optim.py variant) or 'combined'
    (pso.py variant: 0.5 loss + 0.5 FID).
    eval_num_epoch: epochs per particle evaluation (pso.py uses 1,
    pso-optim.py uses 5 — pso-optim.py:366).
    device: where the evaluations train (default `_device.resolve_device`).
    """
    device = resolve_device(device)

    def evaluate(hyperparams: Dict, seed: int) -> float:
        unique_id = random.randint(0, int(1e6))
        config_path, config = prepare_config(
            base_config_path, hyperparams, unique_id, num_epoch=eval_num_epoch
        )
        exp_path = os.path.join(
            "./saved_info/dd_gan", str(config["dataset"]), str(config["exp"])
        )
        os.makedirs(exp_path, exist_ok=True)
        try:
            if mode == "subprocess":
                run_bash_command(_port_command(
                    device, "cli.train_cli",
                    f"--use_config_file True --config_file {shlex.quote(config_path)}"))
            else:
                from ..train import train

                train(Config.from_dict({**config, "seed": seed}), device=device)

            if scoring == "stability":
                score = loss_stability_score(exp_path)
            else:
                loss_score = compute_loss(exp_path)
                fid_score = _compute_fid(config, unique_id, device) if with_fid else 0.0
                score = combined_score(
                    loss_score, fid_score,
                    config.get("loss_min", 0), config.get("loss_max", 1),
                    config.get("fid_min", 0), config.get("fid_max", 300),
                )
        except Exception as e:  # noqa: BLE001 - failed eval → inf (pso.py:352-354)
            logger.exception(f"Evaluation failed: {e}")
            score = float("inf")
        finally:
            cleanup_experiment(config, unique_id)
        return score

    return evaluate


def _compute_fid(config: Dict, unique_id: int, device: torch.device) -> float:
    """FID via the sampling CLI. (pso.py:425-466)"""
    save_dir = config.get("save_dir", ".")
    real_img_dir = os.path.join(save_dir, "real_images")
    gen_dir = os.path.join(save_dir, f"generated_samples_{config['exp']}")
    os.makedirs(gen_dir, exist_ok=True)
    if not os.path.isdir(real_img_dir) or len(os.listdir(real_img_dir)) < 100:
        if config.get("path_to_slices_info"):
            from ..data import load_slice_info
            from ..data.converters import nii_to_png

            nii_to_png(
                load_slice_info(config["path_to_slices_info"]),
                save_dir=real_img_dir,
                lim=1000,
                do_resize_to=(int(config["image_size"]), int(config["image_size"])),
            )
        else:
            raise FileNotFoundError("Path to slices info is not specified in the config.")

    fid_file = os.path.join("./saved_info/", f"fid_score_{unique_id}.txt")
    q = shlex.quote
    run_bash_command(_port_command(
        device, "cli.test_cli",
        f"--epoch_id {config['num_epoch']} --generated_samples_dir {q(gen_dir)} "
        f"--dataset {q(str(config['dataset']))} --exp {q(str(config['exp']))} "
        f"--real_img_dir {q(real_img_dir)} --compute_fid --fid_output_path {q(fid_file)}"))
    if os.path.exists(fid_file):
        with open(fid_file) as f:
            return float(f.readline().strip())
    return float("inf")
