"""Sampling CLI — the reference test_ddgan.py, on the GPU.

Counterpart of `ddgan_tpu/cli/test_cli.py`. Run as

    python -m ddgan_torch.cli.test_cli --dataset cifar10 --exp exp1 --epoch_id 1

from the directory that holds `saved_info/`; `--device cpu` (or
`DDGAN_TORCH_DEVICE=cpu`) runs it off the GPU. The protocol
(test_ddgan.py:128-250):

  * recover the training args from the experiment's content_args.json
    (the JAX package's plain JSON) or a reference content.pth, overridden
    by the command line;
  * load netG_{epoch_id}.pth (reference format, `module.` prefixes
    stripped) or, when there is none, the JAX package's netG_{epoch_id}.ckpt
    (flax msgpack, read without JAX) into the generator;
  * run the T-step reverse sampler with a fresh z per step and write PNGs
    (or one NPY) to {generated_samples_dir}/generated_samples/{dataset};
  * with --compute_fid, write num_fid_samples PNGs there with the pipelined
    batch loop `generate_samples`, then the FID against real_img_dir
    (FID-InceptionV3 pool3, 2048 dims, on the CLI's device) to
    fid_output_path.

Over ranks, as the JAX CLI samples on every device of its mesh
(`ddgan_tpu/cli/test_cli.py:103-125`): `--num_process_per_node R` (with
`--num_proc_node`, `--node_rank` and `--master_address`, as the train CLIs
take them) spawns R sampling processes through `parallel.launch`, one per
GPU, on the backend that `parallel.resolve_backend` picks from the
experiment's `what_backend` (gloo on the CPU). The rank count comes
from the command line only, never from the experiment's saved training
args. Rank r draws from one generator seeded with seed + r
(`make_sampler`), so rank 0 of one process draws what the CLI always drew.
With --compute_fid each rank samples `batch_size` a call, so a call yields
batch_size · R samples; {i}.png is the i-th sample in (call, rank, row)
order, written once, by the rank that drew it, and the FID is computed on
rank 0 after every rank's files are on disk. Plain sampling sizes each
rank's batch down to ceil(batch_size / R) and writes the first batch_size,
sample_{i}.png in (rank, row) order.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from ..compat import load_netg_ckpt, load_netg_pth
from ..config import Config
from ..diffusion import PosteriorCoefficients, sample_from_model
from ..diffusion.graphed import GraphedForward
from ..models import NCSNpp
from ..trace import span
from ..utils import save_image, to_range_0_1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DDGAN Testing Parameters")
    p.add_argument("--seed", type=int, default=1024)
    p.add_argument("--normalize", default=False)
    p.add_argument("--compute_fid", action="store_true")
    p.add_argument("--epoch_id", type=int, default=109)
    p.add_argument("--real_img_dir", default="./real_images")
    p.add_argument("--fid_output_path", default="./fid_score.txt")
    p.add_argument("--dataset", default="luna16")
    p.add_argument("--exp", default="exp1")
    p.add_argument("--num_fid_samples", type=int, default=5000)
    p.add_argument("--save_npy", action="store_true")
    p.add_argument("--generated_samples_dir", type=str, default=".")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; also $DDGAN_TORCH_DEVICE")
    # the sampling ranks: command line only (never the saved training args)
    p.add_argument("--num_process_per_node", type=int, default=1)
    p.add_argument("--num_proc_node", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--master_address", type=str, default="127.0.0.1")
    return p


_RANK_FLAGS = ("num_process_per_node", "num_proc_node", "node_rank", "master_address")


def load_config(exp_path: Path, args: argparse.Namespace) -> Config:
    """Training args of the experiment, overridden by the command line."""
    if (exp_path / "content_args.json").exists():
        with open(exp_path / "content_args.json") as f:
            saved = json.load(f)
    elif (exp_path / "content.pth").exists():
        content_args = torch.load(exp_path / "content.pth", map_location="cpu",
                                  weights_only=False)["args"]
        saved = dict(content_args) if isinstance(content_args, dict) else dict(vars(content_args))
    else:
        raise FileNotFoundError(f"No training content found under {exp_path}")
    saved.update({k: v for k, v in vars(args).items()
                  if v is not None and k not in _RANK_FLAGS})
    return Config.from_dict(saved)


def load_generator(exp_path: Path, cfg: Config, epoch_id: int, device: torch.device) -> NCSNpp:
    """NCSNpp with the weights of netG_{epoch_id}, in eval mode on `device`.

    The port's (and the reference's) netG_{epoch_id}.pth is taken first,
    then the JAX package's netG_{epoch_id}.ckpt: the reverse of the JAX
    CLI's order (`ddgan_tpu/cli/test_cli.py:77-92`), each package preferring
    its own format.
    """
    pth = exp_path / f"netG_{epoch_id}.pth"
    ckpt = exp_path / f"netG_{epoch_id}.ckpt"
    if pth.exists():
        state_dict = load_netg_pth(str(pth))
    elif ckpt.exists():
        state_dict = load_netg_ckpt(str(ckpt))
    else:
        raise FileNotFoundError(f"Checkpoint netG_{epoch_id} not found in {exp_path}")
    net = NCSNpp.from_config(cfg)
    net.load_state_dict(state_dict, strict=True)
    return net.to(device).eval()


def make_sampler(cfg: Config, net: NCSNpp, batch: int, device: torch.device,
                 rng: torch.Generator) -> Callable[[], torch.Tensor]:
    """() -> one batch of samples in [-1, 1], (batch, C, H, W) on `device`.

    On a CUDA device G's forward in eval mode is captured as a CUDA graph at
    the first call and replayed at every later one (`GraphedForward`): the
    weights are read in place at each call, so load them into `net`'s own
    tensors (`load_state_dict`, `copy_`), never by rebinding a parameter."""
    pos_coeff = PosteriorCoefficients.create(
        cfg.num_timesteps, cfg.beta_min, cfg.beta_max, cfg.use_geometric, device=device
    )
    shape = (batch, cfg.num_channels, cfg.image_size, cfg.image_size)
    g = GraphedForward(net)

    def sample() -> torch.Tensor:
        with span("ddgan.sample", device):
            x_init = torch.randn(shape, generator=rng, device=device)
            return sample_from_model(pos_coeff, g, cfg.num_timesteps, x_init, cfg.nz, rng)

    return sample


def _to_host_async(x: torch.Tensor):
    """Start the copy of `x` to the host; (host tensor, event or None)."""
    if x.device.type != "cuda":
        return x, None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def generate_samples(
    sample_batch: Callable[[], torch.Tensor],
    total: int,
    per_call: int,
    save_dir: str | Path,
    *,
    save_npy: bool = False,
    normalize: bool = False,
    tag: str = "",
    rank: int = 0,
    world: int = 1,
) -> int:
    """Write this rank's share of `total` samples as {i}.png (and {i}.npy)
    under `save_dir`: call k of `sample_batch` gives the `per_call` samples
    from k·per_call·world + rank·per_call on, those below `total` kept (a
    rank with none left in a call makes no call).

    Pipelined as the JAX package's FID loop (`ddgan_tpu/cli/test_cli.py:131-196`):
    batch k+1 is launched before batch k is handed to the encoders, whose
    copy to the host was queued right behind batch k; PNG/NPY encoding runs
    in two worker threads behind a bounded queue of 4 batches. Returns the
    number of samples this rank wrote.
    """
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    iters_needed = (total + per_call * world - 1) // (per_call * world)

    def encode_batch(host_arr: np.ndarray, index0: int) -> None:
        for j, x in enumerate(host_arr):
            if save_npy:
                np.save(save_dir / f"{index0 + j}.npy", x.transpose(2, 0, 1))
            save_image(x, save_dir / f"{index0 + j}.png", normalize=normalize)

    pool = ThreadPoolExecutor(max_workers=2)
    encode_futs: deque = deque()

    def submit_encode(batch) -> None:
        # each queued batch pins a full host copy: bound the window
        while len(encode_futs) >= 4:
            encode_futs.popleft().result()  # propagate encode errors
        host, ready, n_keep, index0 = batch
        if ready is not None:
            ready.synchronize()
        arr = host[:n_keep].permute(0, 2, 3, 1).float().numpy()
        encode_futs.append(pool.submit(encode_batch, arr, index0))

    try:
        pending = None
        written = 0
        for i in range(iters_needed):
            index = (i * world + rank) * per_call
            n = min(per_call, total - index)
            if n <= 0:
                break
            host, ready = _to_host_async(to_range_0_1(sample_batch()))
            if pending is not None:
                submit_encode(pending)
            pending = (host, ready, n, index)
            written += n
            if (i + 1) % max(1, iters_needed // 2) == 0:
                print(f"Generated {min(total, (i + 1) * per_call * world)}/{total} samples"
                      f"{' for ' + tag if tag else ''}")
        if pending is not None:
            submit_encode(pending)
        for f in encode_futs:
            f.result()
    finally:
        # no worker keeps writing after an exception surfaces
        pool.shutdown(wait=True, cancel_futures=True)
    return written


def rank_batch(batch_size: int, world: int, compute_fid: bool) -> int:
    """Each rank's batch: `batch_size` for an FID set (a call yields
    batch_size · world), else ceil(batch_size / world)
    (`ddgan_tpu/cli/test_cli.py:115-120`)."""
    return batch_size if compute_fid else max(1, -(-batch_size // world))


def sample_rank(rank: int, local_rank: int, args: argparse.Namespace,
                feature_fn: Callable[[np.ndarray], np.ndarray] | None = None,
                dims: int = 2048):
    """The CLI on one rank of `args.world` (1: this process alone): sample,
    write this rank's files and, with --compute_fid, the FID on rank 0 once
    every rank's files are on disk, in the features of `feature_fn`
    ((B, H, W, C) in [0, 1] -> (B, dims); default the FID-InceptionV3's
    pool3 at `dims`). Returns the FID on rank 0 of an FID run, else None."""
    from ..parallel import default_group, rank_device

    world = int(getattr(args, "world", 1))
    group = default_group()
    device = resolve_device(args.device) if group is None else rank_device(local_rank)
    exp_path = Path(f"./saved_info/dd_gan/{args.dataset}/{args.exp}")
    cfg = load_config(exp_path, args)
    net = load_generator(exp_path, cfg, int(args.epoch_id), device)
    batch_size = int(args.batch_size or cfg.batch_size)
    per_rank = rank_batch(batch_size, world, bool(args.compute_fid))
    rng = torch.Generator(device=device).manual_seed(int(args.seed) + rank)
    sample = make_sampler(cfg, net, per_rank, device, rng)

    save_dir = Path(args.generated_samples_dir) / "generated_samples" / str(args.dataset)
    save_dir.mkdir(parents=True, exist_ok=True)
    if args.compute_fid:
        generate_samples(sample, int(args.num_fid_samples), per_rank, save_dir,
                         save_npy=bool(args.save_npy), normalize=bool(args.normalize),
                         tag=str(args.exp), rank=rank, world=world)
        if group is not None:
            torch.distributed.barrier()  # every rank's files are written
        if rank != 0:
            return None
        from ..eval.fid import calculate_fid_given_paths
        from ..eval.inception import default_feature_fn

        fid = calculate_fid_given_paths(
            [str(save_dir), args.real_img_dir], batch_size=50, dims=dims,
            feature_fn=feature_fn or default_feature_fn(dims=dims, device=device))
        print(f"FID = {fid}")
        if args.fid_output_path:
            out_dir = os.path.dirname(args.fid_output_path)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
            with open(args.fid_output_path, "w") as f:
                f.write(f"{fid}\n")
            print(f"FID score saved to {args.fid_output_path}")
        return fid
    fake = to_range_0_1(sample()).permute(0, 2, 3, 1).float().cpu().numpy()
    first = rank * per_rank
    fake = fake[:max(0, batch_size - first)]
    if args.save_npy:
        if group is not None:
            parts = [None] * world
            torch.distributed.all_gather_object(parts, fake)
            fake = np.concatenate(parts)
        if rank == 0:
            np.save("file.npy", fake.transpose(0, 3, 1, 2))
            print("file.npy")
    else:
        for i, x in enumerate(fake):
            save_image(x, save_dir / f"sample_{first + i}.png", normalize=bool(args.normalize))
        if rank == 0:
            print(f"Sample images saved to {save_dir}")
    return None


def sample_and_test(args: argparse.Namespace, feature_fn=None, dims: int = 2048,
                    **launch_kw):
    """The CLI: in this process, or over `num_proc_node · num_process_per_node`
    ranks (`launch_kw`: `parallel.launch`'s keywords, such as `init_method`).
    `feature_fn` and `dims` as `sample_rank` takes them; a `feature_fn` runs
    in this process only. Returns the FID of an FID run (read back from
    fid_output_path after a spawned run), else None."""
    resolve_device(args.device)
    if args.compute_fid and not os.path.exists(args.real_img_dir):
        raise FileNotFoundError(f"Real image directory {args.real_img_dir} not found.")
    args.world = int(args.num_proc_node) * int(args.num_process_per_node)
    if args.world <= 1:
        return sample_rank(0, 0, args, feature_fn, dims)
    if feature_fn is not None or dims != 2048:
        raise ValueError("feature_fn and dims are taken by a run in one process only")
    from ..parallel import launch

    exp_path = Path(f"./saved_info/dd_gan/{args.dataset}/{args.exp}")
    args.what_backend = str(getattr(load_config(exp_path, args), "what_backend", "nccl"))
    if args.device is not None:
        launch_kw.setdefault("device", args.device)
    launch(args, sample_rank, **launch_kw)
    if args.compute_fid and args.fid_output_path and int(args.node_rank) == 0:
        with open(args.fid_output_path) as f:
            return float(f.read())
    return None


def main(argv=None, feature_fn=None, dims: int = 2048, **launch_kw):
    args = build_parser().parse_args(argv)
    return sample_and_test(args, feature_fn, dims, **launch_kw)


def entry() -> int:
    """Console-script wrapper: main() returns the FID (a float) for
    programmatic callers; exit codes must stay 0-on-success."""
    main()
    return 0


if __name__ == "__main__":
    main()
