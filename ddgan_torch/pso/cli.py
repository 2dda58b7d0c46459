"""PSO hyperparameter-search CLI — the reference pso.py:528-622 surface, on
the GPU. Counterpart of `ddgan_tpu/pso/cli.py` (and of the root `pso.py`
and `pso-optim.py`, which stay the JAX package's), with the same flags,
presets and search space. Run as

    python -m ddgan_torch.pso.cli --num_particles 10 --num_iterations 20
    python -m ddgan_torch.pso.cli --preset pso-optim

from a working directory of its own: it writes ./configs/config.json (the
base config, with the search's settings merged in), one
./configs/config_<id>.json per evaluation, ./saved_info/ and
best_hyperparameters.json there. The evaluations train on `cuda` unless
$DDGAN_TORCH_DEVICE asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .._device import resolve_device
from ..config import Config, load_json_to_dict, modify_json_file, save_dict_to_json
from .evaluate import check_pool, make_evaluator
from .search import PSO


def setup_logger(log_file: str = "pso_gan_optimization.log") -> logging.Logger:
    """File + console logging. (pso.py:39-63)"""
    logger = logging.getLogger("ddgan_torch.pso")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("PSO-GAN for LUNA16 (PyTorch/CUDA)")
    p.add_argument("--search_space", type=str,
                   default="./configs/search_space_params.json")
    p.add_argument("--config_file", type=str, default=None)
    p.add_argument("--save_dir", type=str, default="./converted_images")
    p.add_argument("--num_particles", type=int, default=10)
    p.add_argument("--num_iterations", type=int, default=20)
    p.add_argument("--limited_iteration_mode", type=int, default=202)
    p.add_argument("--with_FID", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--use_multiprocessing", action="store_true")
    p.add_argument("--log_file", type=str, default="pso_gan_optimization.log")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--eval_mode", choices=["inprocess", "subprocess"],
                   default="inprocess",
                   help="train each particle in this process, or in a train CLI subprocess")
    p.add_argument("--scoring", choices=["combined", "stability"],
                   default="combined")
    p.add_argument("--preset", choices=["pso", "pso-optim"], default="pso",
                   help="'pso-optim' reproduces the reference's second HPO "
                        "entry (pso-optim.py): stability scoring, FID off, "
                        "num_epoch=5 per particle evaluation")
    return p


DEFAULT_SEARCH_SPACE = {
    "lr_g": [1e-6, 1e-3],
    "lr_d": [1e-6, 1e-3],
    "grad_clip_norm": [0.0, 5.0],
    "ema_decay": [0.9, 0.9999],
    "weight_decay_G": [0.0, 1e-4],
    "beta1_g": [0.5, 0.999],
    "beta2_g": [0.5, 0.999],
    "beta1_d": [0.5, 0.999],
    "beta2_d": [0.5, 0.999],
    "beta_min": [0.0, 1.0],
    "beta_max": [0.0, 1.0],
    "dropout": [0.0, 0.5],
    "step": {},
}


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device()
    check_pool(args.eval_mode, device, args.use_multiprocessing)
    eval_num_epoch = 1
    if args.preset == "pso-optim":
        # the reference's pso-optim.py surface: stability-band scoring
        # (pso-optim.py:396-445), FID disabled (:564), 5 epochs per
        # evaluation (:366)
        args.scoring = "stability"
        args.with_FID = False
        eval_num_epoch = 5
    logger = setup_logger(args.log_file)

    # base config (pso.py:573-600)
    if args.config_file and os.path.isfile(args.config_file):
        config = load_json_to_dict(args.config_file)
        save_dict_to_json(config, "./configs/config.json")
        logger.info(f"Config file loaded from: {args.config_file}")
    elif not os.path.isfile("./configs/config.json"):
        save_dict_to_json(Config().to_dict(), "./configs/config.json")

    modify_json_file("./configs/config.json", {
        "save_dir": args.save_dir,
        "limited_iter": args.limited_iteration_mode,
        "resume": args.resume,
        "distributed": False,
        "batch_size": args.batch_size,
        "num_workers": 0,
        "with_FID": args.with_FID,
        "seed": args.seed,
    })

    if os.path.isfile(args.search_space):
        with open(args.search_space) as f:
            search_space = json.load(f)
    else:
        search_space = dict(DEFAULT_SEARCH_SPACE)
    # batch_size is removed from the swarm (pso.py:602-605)
    search_space.pop("batch_size", None)
    if "step" in search_space:
        search_space["step"].pop("batch_size", None)

    evaluate = make_evaluator(
        "./configs/config.json",
        mode=args.eval_mode,
        scoring=args.scoring,
        with_fid=args.with_FID,
        eval_num_epoch=eval_num_epoch,
        device=device,
    )
    pso = PSO(
        search_space=search_space,
        evaluate_fn=evaluate,
        num_particles=args.num_particles,
        num_iterations=args.num_iterations,
        c1=1.5, c2=1.5, w=0.7,
        do_clamping=True,
        use_multiprocessing=args.use_multiprocessing,
        seed=args.seed,
    )
    pso.optimize()
    pso.save_best("best_hyperparameters.json")
    logger.info("Optimization completed.")
    logger.info("Best hyperparameters found:")
    logger.info(json.dumps(pso.global_best_position, indent=4))
    return pso.global_best_position


if __name__ == "__main__":
    main()
