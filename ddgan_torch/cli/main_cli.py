"""Config-first training wrapper — the reference main.py:9-69, on the GPU.
Counterpart of `ddgan_tpu/cli/main_cli.py`. Run as

    python -m ddgan_torch.cli.main_cli --dataset synthetic --exp exp1 ...

Minimal argparse (config_file, data_dir, limited_slices, resume, exp,
dataset, batch_size, num_epoch, save_content); CLI values, defaults
included, are written over ./configs/config.json in place, then training
runs from the merged file, in this process or over several as `train_cli`
runs; the device is as for `train_cli`.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from .._device import resolve_device
from ..config import Config, load_json_to_dict, modify_json_file, save_dict_to_json
from .train_cli import run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ddgan for Luna16 (PyTorch/CUDA)")
    p.add_argument("--config_file", default=None)
    p.add_argument("--data_dir", default="./all_ones_final")
    p.add_argument("--limited_slices", default=False)
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--exp", default="exp1")
    p.add_argument("--dataset", default="posluna")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_epoch", type=int, default=5)
    p.add_argument("--save_content", action="store_true", default=False)
    return p


def main(argv=None, config_dir="./configs", config_name="config.json"):
    args = build_parser().parse_args(argv)
    device = resolve_device()
    cfg_path = Path(config_dir) / config_name

    config = None
    if args.config_file is not None and os.path.isfile(args.config_file):
        config = load_json_to_dict(args.config_file)
        save_dict_to_json(config, cfg_path)
    if config is None and args.config_file is None and not cfg_path.is_file():
        save_dict_to_json(Config().to_dict(), cfg_path)

    modify_json_file(cfg_path, vars(args))  # write CLI over json (main.py:63)
    config = load_json_to_dict(cfg_path)
    cfg = Config.from_dict(config)

    return run(cfg, device)



def entry() -> int:
    """Console-script wrapper: main() returns the final train state for
    programmatic callers, which `sys.exit` would print as an error."""
    main()
    return 0


if __name__ == "__main__":
    main()
