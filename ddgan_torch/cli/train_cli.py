"""Training CLI — flag surface of the reference train_ddgan.py:25-224, on
the GPU. Counterpart of `ddgan_tpu/cli/train_cli.py`, with the same flags
and the same merge. Run as

    python -m ddgan_torch.cli.train_cli --use_config_file True ...

Config semantics preserved: with --use_config_file, CLI args that were
explicitly provided override ./configs/config.json (relative to the working
directory) and are WRITTEN BACK into the file (the reference mutates the
JSON in place, train_ddgan.py:198-222), then training runs from the merged
config. The device is `cuda` unless $DDGAN_TORCH_DEVICE asks for the CPU
(`_device.resolve_device`), not a flag, so the written-back config keeps
the JAX package's key set. Without a GPU and without that, it raises before
touching the config.

With num_proc_node · num_process_per_node > 1 the CLI spawns
num_process_per_node training processes on this node, one per GPU, which
meet over torch.distributed (`parallel.launch`: the reference's env://
rendezvous at --master_address, port 6020, backend --what_backend; gloo on
the CPU) and train data-parallel, `batch_size` per process. Otherwise it
trains in this process.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from .._device import resolve_device
from ..config import (
    Config,
    load_json_to_dict,
    modify_json_file,
    save_dict_to_json,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ddgan for Luna16 (PyTorch/CUDA)")
    p.add_argument("--use_config_file", default=None)
    p.add_argument("--config_file", default=None)
    p.add_argument("--limited_slices", default=None)
    p.add_argument("--data_dir", help="path to image files")
    p.add_argument("--mask_dir", type=str)
    p.add_argument("--to_tensor_transform", type=str)
    p.add_argument("--bound_expand_limit", type=int)
    p.add_argument("--dataset", type=str,
                   choices=["custom", "posluna", "luna16", "cifar10",
                            "stackmnist", "lsun", "celeba_256", "synthetic"])
    p.add_argument("--resume", action="store_true", default=None)
    p.add_argument("--seed", type=int)
    p.add_argument("--num_workers", type=int)
    p.add_argument("--mode", type=str, choices=["train", "test", "val"])
    p.add_argument("--disc_small", type=str, choices=["yes", "no"])
    p.add_argument("--distributed", action="store_true", default=None)
    p.add_argument("--grad_clip_norm", type=float)
    p.add_argument("--weight_decay_G", type=float)
    p.add_argument("--weight_decay_D", type=float)
    p.add_argument("--beta1_g", type=float)
    p.add_argument("--beta2_g", type=float)
    p.add_argument("--beta1_d", type=float)
    p.add_argument("--beta2_d", type=float)
    p.add_argument("--d_updates_per_g_update", type=int)
    p.add_argument("--what_backend", choices=["nccl", "gloo", "ici"])
    p.add_argument("--do_resize", choices=["yes", "no"])
    p.add_argument("--use_normalize", choices=["yes", "no"])
    p.add_argument("--CenterCrop", choices=["yes", "no"])
    p.add_argument("--image_size", type=int)
    p.add_argument("--kind_of_optim", type=str, choices=["pso", "adam"])
    p.add_argument("--num_channels", type=int)
    p.add_argument("--centered", action="store_false", default=None)
    p.add_argument("--use_geometric", action="store_true", default=None)
    p.add_argument("--beta_min", type=float)
    p.add_argument("--beta_max", type=float)
    p.add_argument("--num_channels_dae", type=int)
    p.add_argument("--n_mlp", type=int)
    p.add_argument("--ch_mult", nargs="+", type=int)
    p.add_argument("--num_res_blocks", type=int)
    p.add_argument("--attn_resolutions", nargs="+", type=int)
    p.add_argument("--dropout", type=float)
    p.add_argument("--resamp_with_conv", action="store_false", default=None)
    p.add_argument("--conditional", action="store_false", default=None)
    p.add_argument("--fir", action="store_false", default=None)
    p.add_argument("--fir_kernel", nargs="+", type=int)
    p.add_argument("--skip_rescale", action="store_false", default=None)
    p.add_argument("--resblock_type")
    p.add_argument("--progressive", choices=["none", "output_skip", "residual"])
    p.add_argument("--progressive_input", choices=["none", "input_skip", "residual"])
    p.add_argument("--progressive_combine", choices=["sum", "cat"])
    p.add_argument("--embedding_type", choices=["positional", "fourier"])
    p.add_argument("--fourier_scale", type=float)
    p.add_argument("--not_use_tanh", action="store_true", default=None)
    p.add_argument("--exp", default=None)
    p.add_argument("--nz", type=int)
    p.add_argument("--num_timesteps", type=int)
    p.add_argument("--z_emb_dim", type=int)
    p.add_argument("--t_emb_dim", type=int)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--num_epoch", type=int)
    p.add_argument("--ngf", type=int)
    p.add_argument("--lr_g", type=float)
    p.add_argument("--lr_d", type=float)
    p.add_argument("--beta1", type=float)
    p.add_argument("--beta2", type=float)
    p.add_argument("--no_lr_decay", action="store_true", default=None)
    p.add_argument("--use_ema", action="store_true", default=None)
    p.add_argument("--ema_decay", type=float)
    p.add_argument("--r1_gamma", type=float)
    p.add_argument("--lazy_reg", type=int)
    p.add_argument("--save_content", action="store_true", default=None)
    p.add_argument("--save_content_every", type=int)
    p.add_argument("--compute_dtype", type=str,
                   help="conv/attn compute dtype: float32 or bfloat16 "
                        "(params stay f32; the recipes want bfloat16)")
    p.add_argument("--save_ckpt_every", type=int)
    p.add_argument("--num_proc_node", type=int)
    p.add_argument("--num_process_per_node", type=int)
    p.add_argument("--node_rank", type=int)
    p.add_argument("--local_rank", type=int)
    p.add_argument("--master_address", type=str)
    p.add_argument("--fast_memory", default=None)
    p.add_argument("--limited_iter", default=None)
    return p


def resolve_config(args: argparse.Namespace,
                   config_dir: str = "./configs",
                   config_name: str = "config.json") -> Config:
    """Reference merge: config.json ∪ explicitly-set CLI flags, written
    back to disk. (train_ddgan.py:185-222)"""
    use_cfg = args.use_config_file
    use_cfg = not (use_cfg in (None, "False", "false", False, "0"))
    overrides = {k: v for k, v in vars(args).items() if v is not None}

    if not use_cfg:
        return Config.from_dict({**Config().to_dict(), **overrides})

    config = None
    if args.config_file is not None and os.path.isfile(args.config_file):
        config = load_json_to_dict(args.config_file)
    if config is None:
        default_path = Path(config_dir) / config_name
        if not default_path.is_file():
            save_dict_to_json(Config().to_dict(), default_path)
        if overrides:
            modify_json_file(default_path, overrides)
        config = load_json_to_dict(default_path)
    else:
        config.update(overrides)
    return Config.from_dict(config)


def run(cfg: Config, device, **launch_kw):
    """Train from the merged config: in this process, or over
    num_process_per_node spawned processes when the run has more than one
    (`launch_kw`: `parallel.launch`'s keywords, such as `init_method`)."""
    if int(cfg.num_proc_node) * int(cfg.num_process_per_node) > 1:
        from ..parallel import launch
        from ..train.loop import train_rank

        return launch(cfg, train_rank, **launch_kw)
    from ..train import train

    return train(cfg, device=device)


def main(argv=None, **launch_kw):
    args = build_parser().parse_args(argv)
    device = resolve_device()
    cfg = resolve_config(args)
    return run(cfg, device, **launch_kw)



def entry() -> int:
    """Console-script wrapper: main() returns the final train state for
    programmatic callers, which `sys.exit` would print as an error."""
    main()
    return 0


if __name__ == "__main__":
    main()
