#!/usr/bin/env python
"""Quality soak of the PyTorch/CUDA port: train a recipe at length through
`ddgan_torch`'s CLIs, with one hard SIGKILL and a --resume, and score the
EMA and the raw generator by FID while the run goes on.

The port's counterpart of `tools/quality_soak.py` (the flagship CIFAR-10
recipe) and `tools/quality_soak256.py` (the CelebA-HQ 256 recipe), one
tool for both (`--recipe flagship|celeba256`). It imports torch, numpy,
the standard library and `ddgan_torch`, and PIL only to write the 256²
training JPEGs, as the JAX tool does: nothing of JAX. Its data are the JAX
tools' (the same toy distribution, seeds and file formats), its training
flags theirs, and its feature space the JAX package's seeded random
FID-Inception (DDGAN_TPU_INCEPTION_RANDOM=0, drawn alike by both
packages), so each point stands beside the JAX record's
(`QUALITY_r03.json`, `QUALITY_256_r05.json`).

The run, under `--root`:
  1. data: flagship, CIFAR-10 pickles of `--n-train` 32² images; celeba256,
     a `custom` folder of q95 JPEGs at 256²; both with `--n-real` real PNGs
     (the port's PNG encoder) and `--fid-samples` held-out ones.
  2. the real set's statistics (`python -m ddgan_torch.eval.fid
     --save-stats`, in process) and the floor: the FID of the held-out
     draw against them.
  3. segments: `python -m ddgan_torch.cli.train_cli <the recipe's flags>
     --num_epoch N [--resume]` in a subprocess each, on the device of
     $DDGAN_TORCH_DEVICE (the GPU by default). N is --schedule-epochs, the
     JAX soak's first segment (so the per-epoch cosine lr is the JAX
     run's), and each process is stopped by SIGKILL right after the
     content.pth save and the epoch line of its segment's last epoch
     (--schedule-epochs 0: N is that epoch, and the process ends there by
     itself). The first is also SIGKILLed `--kill-delay` s after the content.pth save that
     follows its `--kill-after`-th epoch, then resumed; the resume redoes
     at most the epoch the kill cut.
  4. after the kill and after each segment: every new netG_{e}.pth (the
     EMA's weights) is scored, and at a segment's end the raw G and the
     EMA of its content.pth are written as netG_{90000+e}.pth and
     netG_{80000+e}.pth and scored too, each through `python -m
     ddgan_torch.cli.test_cli --compute_fid` in process. A point is kept
     in fid_{id}.txt (a rerun reuses it), and the record is rewritten
     after every point, so a run cut short still leaves its curve.

Run (40-45 min a recipe on an H100 at the defaults; a soak runs whole on
one machine, whose content.pth it resumes from; the record goes to the
recipe's QUALITY_*torch_r01.json at the repository root unless --out):
  python tools/quality_soak_torch.py --recipe celeba256
`--train-seed` gives the train CLI a seed of its own (default `--seed`):
the data and the FID samples keep `--seed`'s draws, so two soaks that
differ in it measure the seed-to-seed spread of training.
On the CPU at a tiny size (a few minutes; --dims 64 keeps sqrtm small):
  DDGAN_TORCH_DEVICE=cpu python tools/quality_soak_torch.py --recipe flagship \\
      --root /tmp/soak_tiny --out /tmp/soak_tiny/record.json --n-train 32 --n-real 16 \\
      --nf 16 --batch-size 8 --segments 2 3 --kill-delay 0 --ckpt-every 1 \\
      --content-every 1 --fid-samples 16 --fid-batch 8 --dims 64
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pickle
import re
import signal
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from ddgan_torch.compat import strip_module_prefix  # noqa: E402
from ddgan_torch.utils import encode_png  # noqa: E402

# ---------------------------------------------------------------------------
# the toy distribution of tools/quality_e2e.py: 1-2 coloured Gaussian blobs
# on a smooth gradient background
PALETTE = np.array(
    [
        [0.95, 0.35, 0.25],  # red-orange
        [0.30, 0.75, 0.95],  # sky blue
        [0.45, 0.90, 0.40],  # green
        [0.95, 0.85, 0.30],  # yellow
    ],
    np.float32,
)


def toy_image(rng: np.random.RandomState, size: int = 32) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    base = rng.uniform(0.05, 0.25, size=3).astype(np.float32)
    tilt = rng.uniform(-0.15, 0.15, size=3).astype(np.float32)
    img = base[None, None, :] + yy[:, :, None] * tilt[None, None, :]
    for _ in range(rng.randint(1, 3)):
        color = PALETTE[rng.randint(len(PALETTE))] * rng.uniform(0.8, 1.0)
        cy, cx = rng.uniform(0.25, 0.75, size=2)
        rad = rng.uniform(0.10, 0.22)
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * rad**2)))
        img = img + blob[:, :, None] * color[None, None, :]
    return np.clip(img, 0.0, 1.0)


def toy_pixels(seed: int, stride: int, index: int, size: int) -> np.ndarray:
    """Image `index` of a soak's draws, (size, size, 3) uint8."""
    rng = np.random.RandomState(seed * stride + index)
    return (toy_image(rng, size) * 255).astype(np.uint8)


def write_pngs(directory: Path, seed: int, stride: int, first: int, n: int, size: int) -> None:
    """img_{i:05d}.png for i < n: draws first + i."""
    directory.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        (directory / f"img_{i:05d}.png").write_bytes(
            encode_png(toy_pixels(seed, stride, first + i, size)))


# ---------------------------------------------------------------------------
# the data of the JAX tools: tools/quality_soak.py:make_cifar_pickles and
# tools/quality_soak256.py:make_jpeg_folder, the same bytes (the real PNGs
# the same pixels)
def make_cifar_pickles(root: Path, n_train: int, n_real: int, seed: int) -> None:
    """CIFAR-10 `data_batch_1..5` under root/data/cifar-10-batches-py and
    the real PNGs under root/real: draws seed * 1_000_003 + index."""
    base = root / "data" / "cifar-10-batches-py"
    base.mkdir(parents=True, exist_ok=True)
    per_batch = -(-n_train // 5)
    idx = 0
    for b in range(1, 6):
        n = min(per_batch, n_train - (b - 1) * per_batch)
        data = np.empty((n, 3 * 32 * 32), np.uint8)
        for j in range(n):
            data[j] = toy_pixels(seed, 1_000_003, idx, 32).transpose(2, 0, 1).reshape(-1)
            idx += 1
        with open(base / f"data_batch_{b}", "wb") as f:
            pickle.dump({b"data": data, b"labels": [0] * n}, f)
    write_pngs(root / "real", seed, 1_000_003, n_train, n_real, 32)
    print(f"dataset: {n_train} train imgs (cifar pickle), {n_real} real pngs")


def make_jpeg_folder(root: Path, n_train: int, n_real: int, size: int, seed: int) -> None:
    """q95 JPEGs under root/data/train/imgs (the `custom` layout) and the
    real PNGs under root/real: draws seed * 7_000_003 + index."""
    from PIL import Image

    train_dir = root / "data" / "train" / "imgs"
    train_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n_train):
        Image.fromarray(toy_pixels(seed, 7_000_003, i, size)).save(
            train_dir / f"img_{i:05d}.jpg", quality=95)
    write_pngs(root / "real", seed, 7_000_003, n_train, n_real, size)
    print(f"dataset: {n_train} train jpgs, {n_real} real pngs at {size}²")


# ---------------------------------------------------------------------------
# the recipes: the JAX tools' train_cmd flags, flag for flag
def _flagship_flags(args) -> list[str]:
    """tools/quality_soak.py:train_cmd (readme.md:29-36 of the reference)."""
    return [
        "--dataset", "cifar10", "--data_dir", "./data", "--mode", "train",
        "--image_size", "32", "--num_channels", "3",
        "--num_channels_dae", str(args.nf), "--ch_mult", "1", "2", "2", "2",
        "--num_res_blocks", "2", "--attn_resolutions", "16",
        "--num_timesteps", "4", "--nz", "100",
        "--z_emb_dim", "256", "--n_mlp", "4", "--t_emb_dim", "256",
        "--batch_size", str(args.batch_size),
        "--lr_g", "1.6e-4", "--lr_d", "1.25e-4",
        "--beta1_g", "0.5", "--beta2_g", "0.9",
        "--r1_gamma", "0.02", "--lazy_reg", "15",
        "--use_ema", "--ema_decay", "0.9999",
        "--compute_dtype", "bfloat16",
        "--to_tensor_transform", "yes", "--use_normalize", "yes",
    ]


def _celeba256_flags(args) -> list[str]:
    """tools/quality_soak256.py:train_cmd (readme.md:48-54 of the reference)."""
    return [
        "--dataset", "custom", "--data_dir", "./data", "--mode", "train",
        "--image_size", "256", "--num_channels", "3",
        "--num_channels_dae", str(args.nf),
        "--ch_mult", "1", "1", "2", "2", "4", "4",
        "--num_res_blocks", "2", "--attn_resolutions", "16",
        "--num_timesteps", "2", "--nz", "100",
        "--z_emb_dim", "256", "--n_mlp", "3", "--t_emb_dim", "256",
        "--batch_size", str(args.batch_size),
        "--lr_g", "2e-4", "--lr_d", "1e-4",
        "--beta1_g", "0.5", "--beta2_g", "0.9",
        "--r1_gamma", "2.0", "--lazy_reg", "10",
        "--dropout", "0.3",
        "--disc_small", "no",
        "--use_ema", "--ema_decay", "0.999",
        "--compute_dtype", "bfloat16",
        "--to_tensor_transform", "yes", "--use_normalize", "yes",
    ]


@dataclasses.dataclass(frozen=True)
class Recipe:
    dataset: str  # the train CLI's --dataset
    image_size: int
    stride: int  # draw i is RandomState(seed * stride + i)
    flags: Callable  # args -> the recipe's train CLI flags
    jax_record: str  # the JAX soak's record at the repo root
    out: str  # this tool's record at the repo root
    describe: str
    defaults: dict


RECIPES = {
    "flagship": Recipe(
        "cifar10", 32, 1_000_003, _flagship_flags, "QUALITY_r03.json", "QUALITY_torch_r01.json",
        "flagship width: nf=128, ch_mult 1 2 2 2, blocks 2, T=4, batch 64, bf16 "
        "(readme.md:29-36) on 1 GPU, ddgan_torch",
        dict(n_train=20000, n_real=2048, nf=128, batch_size=64, segments=[10, 20],
             schedule_epochs=100, ckpt_every=5, content_every=5, fid_batch=256, seed=42,
             exp="soak")),
    "celeba256": Recipe(
        "custom", 256, 7_000_003, _celeba256_flags, "QUALITY_256_r05.json",
        "QUALITY_256_torch_r01.json",
        "CelebA-HQ-256 axes: 256², nf=64, ch_mult 1 1 2 2 4 4, blocks 2, T=2, batch 8, "
        "DiscriminatorLarge, bf16, dropout 0.3 (readme.md:48-54) on 1 GPU, ddgan_torch",
        dict(n_train=2048, n_real=1024, nf=64, batch_size=8, segments=[8, 16],
             schedule_epochs=32, ckpt_every=4, content_every=4, fid_batch=64, seed=23,
             exp="soak256")),
}


def train_argv(args, num_epoch: int, resume: bool) -> list[str]:
    """The train CLI's arguments for one segment."""
    argv = RECIPES[args.recipe].flags(args) + [
        "--exp", args.exp, "--seed", str(args.train_seed),
        "--save_content", "--save_content_every", str(args.content_every),
        "--save_ckpt_every", str(args.ckpt_every),
        "--num_workers", "2",
        "--num_epoch", str(num_epoch),
    ]
    return argv + ["--resume"] if resume else argv


def train_cmd(args, num_epoch: int, resume: bool) -> list[str]:
    return [sys.executable, "-m", "ddgan_torch.cli.train_cli",
            *train_argv(args, num_epoch, resume)]


# ---------------------------------------------------------------------------
EPOCH_LINE = re.compile(r"\[epoch (\d+)\] (\d+) iters in ([0-9.]+)s \(.*\), saves ([0-9.]+)s")
LOADED = re.compile(r"=> Loaded checkpoint \(epoch (\d+)\)")
SEGMENT_MARK = "## quality_soak_torch: "
POLL_S = 0.1  # seconds between looks at a segment's files


def epoch_seconds(log: str) -> dict:
    """The loop's epoch lines of a train log, process by process: the steps'
    seconds, the saves' after them (losses.json, then netG_e.pth and
    content.pth where the epoch writes them); a process's first epoch warms
    up (`steady` false). With the steady epochs' totals."""
    rows = []
    for k, chunk in enumerate(log.split(SEGMENT_MARK)[1:]):
        for j, m in enumerate(EPOCH_LINE.finditer(chunk)):
            rows.append({"process": k, "epoch": int(m[1]), "iters": int(m[2]),
                         "s": float(m[3]), "saves_s": float(m[4]), "steady": j > 0})
    steady = [r for r in rows if r["steady"]]
    iters, secs = sum(r["iters"] for r in steady), sum(r["s"] for r in steady)
    return {"epochs": rows, "steady": {
        "epochs": len(steady), "iters": iters, "s": secs,
        "steps_per_s": iters / secs if secs else None,
        "s_per_epoch_median": float(np.median([r["s"] for r in steady])) if steady else None}}


def n_logged_epochs(exp_path: Path) -> int:
    try:
        return len(json.loads((exp_path / "losses.json").read_text()))
    except (OSError, ValueError):
        return 0


def snapshot_netg(exp_path: Path) -> int:
    """content.pth's raw G -> netG_{90000+e}.pth and, where the run keeps an
    EMA, its shadow swapped into the same state dict -> netG_{80000+e}.pth;
    returns e. content.pth's `epoch` is the epochs done (`load_content`
    resumes there), so the weights are those at the end of loop epoch
    `epoch - 1`."""
    raw = torch.load(exp_path / "content.pth", map_location="cpu", mmap=True, weights_only=False)
    epoch = int(raw["epoch"]) - 1
    g = strip_module_prefix(raw["netG_dict"])
    snapshots = {90000 + epoch: g}
    if raw.get("emaG"):
        snapshots[80000 + epoch] = {**g, **strip_module_prefix(raw["emaG"])}
    for n, sd in snapshots.items():
        tmp = exp_path / f"netG_{n}.pth.tmp"
        torch.save({k: v.clone() for k, v in sd.items()}, tmp)  # clone: off the mmap
        os.replace(tmp, exp_path / f"netG_{n}.pth")
    return epoch


def same_weights(a: Path, b: Path) -> bool:
    sa = torch.load(a, map_location="cpu", weights_only=True)
    sb = torch.load(b, map_location="cpu", weights_only=True)
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def device_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s line."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not measured ({type(e).__name__}: no nvidia-smi answer)"
    return out.stdout.strip() or f"not measured (nvidia-smi: {out.stderr.strip()})"


@contextlib.contextmanager
def working_directory(path: Path):
    """The CLIs read and write ./saved_info relative to the working directory."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


class Soak:
    """One soak: its data, segments, snapshots, points and record. `feature_fn`
    ((B, H, W, C) in [0, 1] -> (B, args.dims)) replaces the FID-Inception
    in every FID of the run; without it the Inception's pool3 is built once
    and used for all of them."""

    def __init__(self, args, feature_fn: Callable | None = None):
        self.args, self.recipe = args, RECIPES[args.recipe]
        self.root = Path(args.root).resolve()
        self.exp_path = self.root / "saved_info" / "dd_gan" / self.recipe.dataset / args.exp
        self.out = Path(args.out).resolve()
        self.log = self.root / "train_log.txt"
        self.features = feature_fn
        self.feature_space = (
            f"a feature function passed to the tool's Python API, {args.dims} dims"
            if feature_fn is not None else
            f"FID-Inception pool3, {args.dims} dims; DDGAN_TPU_INCEPTION_RANDOM="
            f"{os.environ.get('DDGAN_TPU_INCEPTION_RANDOM')} (seeded random weights), "
            f"DDGAN_TPU_INCEPTION_PATH={os.environ.get('DDGAN_TPU_INCEPTION_PATH')}")
        self.events: list = []
        self.fid: dict[int, float] = {}  # netG id -> FID
        self.point_s: dict[int, float] = {}
        self.snapshots: list[int] = []
        self.ema_same: dict[int, bool] = {}  # snapshot epoch -> its EMA is netG_e
        self.trained_to: int | None = None  # num_epoch of the last segment that ended
        self.floor: float | None = None
        self.device = device_line()

    # -- data, the real statistics, the floor
    def _feature_fn(self) -> Callable:
        if self.features is None:
            from ddgan_torch.eval.inception import default_feature_fn

            self.features = default_feature_fn(dims=self.args.dims)
        return self.features

    @property
    def real_stats(self) -> Path:
        return self.root / "real_stats.npz"

    def prepare(self, floor: bool = True) -> None:
        a, r = self.args, self.recipe
        self.root.mkdir(parents=True, exist_ok=True)
        done = self.root / "data.done"
        if not done.exists():
            if a.recipe == "flagship":
                make_cifar_pickles(self.root, a.n_train, a.n_real, a.seed)
            else:
                make_jpeg_folder(self.root, a.n_train, a.n_real, r.image_size, a.seed)
            write_pngs(self.root / "real_holdout", a.seed, r.stride, a.n_train + a.n_real,
                       a.fid_samples, r.image_size)
            done.touch()
        if not self.real_stats.exists():
            from ddgan_torch.eval import fid as fid_mod

            fid_mod.main(["--save-stats", str(self.root / "real"), str(self.real_stats),
                          "--dims", str(a.dims)], feature_fn=self._feature_fn())
        floor_file = self.root / "fid_floor.txt"
        if floor and not floor_file.exists():
            from ddgan_torch.eval.fid import calculate_fid_given_paths

            value = calculate_fid_given_paths(
                [str(self.root / "real_holdout"), str(self.real_stats)], batch_size=50,
                dims=a.dims, feature_fn=self._feature_fn())
            floor_file.write_text(f"{value}\n")
        if floor_file.exists():
            self.floor = float(floor_file.read_text())
            print(f"FID floor (held-out real draw against the real statistics): {self.floor}",
                  flush=True)

    # -- training
    def _content_saved(self, t0_ns: int, kill_after: int) -> bool:
        """This segment has written content.pth since `kill_after` epochs
        were logged (the save that follows that epoch, or a later one)."""
        n = n_logged_epochs(self.exp_path)
        try:
            content = (self.exp_path / "content.pth").stat().st_mtime_ns
            losses = (self.exp_path / "losses.json").stat().st_mtime_ns
        except OSError:
            return False
        return n >= kill_after and content >= t0_ns and (content >= losses or n > kill_after)

    def _epoch_printed(self, log_start: int, epoch: int) -> bool:
        """The loop printed its line for `epoch` (after that epoch's saves)
        since `log_start`, so a stop keeps the epoch's timing."""
        with open(self.log, "rb") as f:
            f.seek(log_start)
            return any(int(m[1]) == epoch
                       for m in EPOCH_LINE.finditer(f.read().decode(errors="replace")))

    def append_log(self, text: str, label: str) -> None:
        with open(self.log, "a") as f:
            f.write(f"{SEGMENT_MARK}{label}\n{text}")

    def run_segment(self, target: int, resume: bool, kill_after: int | None = None) -> str:
        """One train CLI subprocess that trains to epoch `target`: with
        `--num_epoch target`, or, under --schedule-epochs N, with `--num_epoch
        N` (the lr schedule of a run to N) stopped by SIGKILL right after
        its content.pth save of epoch `target`. With `kill_after`, the hard
        kill: SIGKILL `--kill-delay` s after the content.pth save that
        follows that many logged epochs. Returns "killed", "completed" or,
        when the process reached `target` before its kill point,
        "completed-early"."""
        a = self.args
        num_epoch = a.schedule_epochs or target
        stop_at = target + 1 if num_epoch > target else None  # epochs logged at the stop
        env = dict(os.environ, PYTHONUNBUFFERED="1")  # the log keeps what a kill cuts
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
        cmd = train_cmd(a, num_epoch, resume)
        self.append_log("", f"train_cli --num_epoch {num_epoch}{' --resume' if resume else ''}"
                            f", to epoch {target}")
        log_start = self.log.stat().st_size
        t0, t0_ns = time.time(), time.time_ns()
        with open(self.log, "ab") as log:
            proc = subprocess.Popen(cmd, cwd=self.root, env=env, stdin=subprocess.DEVNULL,
                                    stdout=log, stderr=subprocess.STDOUT)
        status, armed = None, None
        try:
            while proc.poll() is None:
                time.sleep(POLL_S)
                if time.time() - t0 > a.train_timeout:
                    raise TimeoutError(f"segment to epoch {target} exceeded --train-timeout")
                if kill_after is not None:
                    if armed is None and self._content_saved(t0_ns, kill_after):
                        armed = time.time()
                    if armed is not None and time.time() - armed >= a.kill_delay:
                        proc.send_signal(signal.SIGKILL)
                        if proc.wait() == -signal.SIGKILL:  # not a process that had just ended
                            status = "killed"
                            self.events.append({
                                "event": "hard_kill",
                                "at_logged_epoch": n_logged_epochs(self.exp_path),
                                "s_after_content_save": time.time() - armed,
                                "wall_s": round(time.time() - t0, 1)})
                        break
                if stop_at is not None and self._content_saved(t0_ns, stop_at) and (
                        self._epoch_printed(log_start, target)
                        or n_logged_epochs(self.exp_path) > stop_at):
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    status = "stopped"
                    break
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if status != "killed":
            if status is None and proc.returncode != 0:
                raise RuntimeError(f"train segment to epoch {target} ended with "
                                   f"{proc.returncode}; see {self.log}")
            if n_logged_epochs(self.exp_path) < target + 1:
                raise RuntimeError(f"train segment ended before epoch {target}; see {self.log}")
            status = "completed" if kill_after is None else "completed-early"
            with open(self.log, "rb") as f:
                f.seek(log_start)
                text = f.read().decode(errors="replace")
            self.segment_done(target, resume, text, time.time() - t0, num_epoch)
        print(f"segment to epoch {target}{' (resumed)' if resume else ''}: {status} after "
              f"{time.time() - t0:.1f} s, {n_logged_epochs(self.exp_path)} epochs logged",
              flush=True)
        return status

    def segment_done(self, target: int, resume: bool, text: str, wall_s: float,
                     num_epoch: int | None = None) -> None:
        """Record a segment that trained to epoch `target` (its process's
        --num_epoch `num_epoch`, by default `target`); `text` its output."""
        self.trained_to = target
        loaded = LOADED.findall(text)
        self.events.append({"event": "segment_done", "target": target,
                            "num_epoch": num_epoch or target, "resume": resume,
                            "resumed_from_epoch": int(loaded[-1]) if loaded else None,
                            "wall_s": round(wall_s, 1)})

    # -- scoring
    def score(self, netg_id: int) -> float:
        """The FID of netG_{netg_id}.pth through `test_cli --compute_fid` in
        process, against the real statistics; kept in fid_{netg_id}.txt."""
        a = self.args
        done = self.root / f"fid_{netg_id}.txt"
        t0 = time.time()
        if not done.exists():
            from ddgan_torch.cli import test_cli

            gen = self.root / f"gen_{netg_id}"
            with working_directory(self.root):
                test_cli.main([
                    "--dataset", self.recipe.dataset, "--exp", a.exp,
                    "--epoch_id", str(netg_id), "--compute_fid",
                    "--real_img_dir", str(self.real_stats),
                    "--num_fid_samples", str(a.fid_samples),
                    "--batch_size", str(a.fid_batch), "--seed", str(a.seed),
                    "--generated_samples_dir", str(gen), "--fid_output_path", str(done),
                ], feature_fn=self._feature_fn(), dims=a.dims)
            shutil.rmtree(gen, ignore_errors=True)
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()  # the next segment's process gets the memory
            self.point_s[netg_id] = time.time() - t0
        self.fid[netg_id] = float(done.read_text())
        print(f"netG_{netg_id}: FID {self.fid[netg_id]} [{time.time() - t0:.1f} s]", flush=True)
        return self.fid[netg_id]

    def _netg_ids(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1]) for p in self.exp_path.glob("netG_*.pth"))

    def boundary(self, snapshot: bool = True) -> None:
        """After the kill (`snapshot` False) or a segment's end: the raw and
        EMA snapshot, then every unscored netG_*.pth, the record after each.
        Order: the EMA points at the JAX record's epochs, then each
        snapshot's netG_e, raw and EMA, then the rest, latest first. An EMA
        snapshot that is netG_e's weights takes netG_e's FID."""
        if snapshot:
            e = snapshot_netg(self.exp_path)
            if e not in self.snapshots:
                self.snapshots.append(e)
        shared = set(self._jax_curve())

        def priority(i: int) -> tuple:
            e = i % 10000 if i >= 80000 else i
            if i < 80000 and e in shared:
                return (0, -e, 0)
            if e in self.snapshots:
                return (1, -e, {e: 0, 90000 + e: 1}.get(i, 2))
            return (2, -e, 0)

        for i in sorted((i for i in self._netg_ids() if i not in self.fid), key=priority):
            if 80000 <= i < 90000 and self._ema_is_netg(i - 80000):
                continue
            self.score(i)
            self.write_record(False)

    def _ema_is_netg(self, e: int) -> bool:
        """netG_{80000+e} holds netG_e's weights (netG_e scored already)."""
        if e not in self.ema_same:
            netg = self.exp_path / f"netG_{e}.pth"
            if e not in self.fid or not netg.exists():
                return False
            self.ema_same[e] = same_weights(self.exp_path / f"netG_{80000 + e}.pth", netg)
        return self.ema_same[e]

    # -- the record
    def _jax_curve(self) -> dict[int, float]:
        path = REPO / self.recipe.jax_record
        if not path.exists():
            return {}
        return {r["epoch"]: r["fid_ema"] for r in json.loads(path.read_text())["ema_fid_curve"]}

    def jax_reference(self) -> dict:
        path = REPO / self.recipe.jax_record
        if not path.exists():
            return {"file": self.recipe.jax_record, "missing": True}
        ref = json.loads(path.read_text())
        jax_curve = self._jax_curve()
        rows = []
        for e in sorted(k for k in self.fid if k < 80000 and k in jax_curve):
            ratio = self.fid[e] / jax_curve[e]
            rows.append({"epoch": e, "fid_ema_jax": jax_curve[e], "fid_ema_port": self.fid[e],
                         "port_over_jax": ratio, "within_2x": 0.5 <= ratio <= 2.0})
        floor = ref["fid_floor_two_real_draws"]
        return {"file": self.recipe.jax_record, "fid_floor_two_real_draws": floor,
                "floor_port_over_jax": self.floor / floor if self.floor is not None else None,
                "ema_fid_curve": rows, "note": "the JAX record's FIDs were taken on a TPU"}

    def record(self, complete: bool) -> dict:
        losses_file = self.exp_path / "losses.json"
        losses = json.loads(losses_file.read_text()) if losses_file.exists() else []
        continuity = self.trained_to is not None and (
            [e["epoch"] for e in losses] == list(range(1, self.trained_to + 2))
            and all(np.isfinite([e["G_loss"], e["D_loss"]]).all() for e in losses))
        ema_vs_raw = []
        for e in self.snapshots:
            ema_same = self.ema_same.get(e, False)
            ema = self.fid.get(e if ema_same else 80000 + e)
            if 90000 + e in self.fid:
                ema_vs_raw.append({"epoch": e, "fid_raw": self.fid[90000 + e], "fid_ema": ema,
                                   "ema_weights_equal_netG_e": ema_same})
        a = self.args
        return {
            "recipe": self.recipe.describe,
            "dataset": (f"{a.n_train} toy 32x32 imgs in CIFAR pickle format"
                        if a.recipe == "flagship" else
                        f"{a.n_train} toy 256² jpgs via DatasetCustom"),
            "seed": a.seed,
            "train_seed": a.train_seed,
            "feature_space": self.feature_space,
            "device": self.device,
            "events": self.events,
            "losses_epochs_logged": len(losses),
            "fid_floor_two_real_draws": self.floor,
            "resume_continuity_ok": bool(continuity),
            "sweep_complete": bool(complete),
            "ema_fid_curve": [{"epoch": e, "fid_ema": f, "s": self.point_s.get(e)}
                              for e, f in sorted(self.fid.items()) if e < 80000],
            "ema_vs_raw": ema_vs_raw,
            "epoch_seconds": epoch_seconds(self.log.read_text(errors="replace")
                                           if self.log.exists() else ""),
            "jax_reference": self.jax_reference(),
            "config": {k: (str(v) if isinstance(v, Path) else v) for k, v in vars(a).items()},
        }

    def write_record(self, complete: bool) -> dict:
        out = self.record(complete)
        self.out.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.out.with_name(self.out.name + ".tmp")
        tmp.write_text(json.dumps(out, indent=2) + "\n")
        os.replace(tmp, self.out)
        if self.args.copy_log and self.log.exists():
            shutil.copy(self.log, self.args.copy_log)
        return out

    # -- the whole soak
    def run(self) -> dict:
        a = self.args
        self.prepare()
        self.write_record(False)
        first = a.segments[0]
        status = self.run_segment(first, resume=False,
                                  kill_after=a.kill_after if a.kill_after > 0 else None)
        if status == "killed":
            self.boundary(snapshot=False)
            self.run_segment(first, resume=True)  # the kill and resume
        self.boundary()
        for target in a.segments[1:]:
            self.run_segment(target, resume=True)
            self.boundary()
        return self.write_record(True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", required=True, choices=sorted(RECIPES))
    ap.add_argument("--root", default=None,
                    help="the run's directory (default: <temp dir>/ddgan_torch_soak_<recipe>)")
    ap.add_argument("--out", default=None,
                    help="the record (default: the recipe's QUALITY_*torch_r01.json at the "
                         "repository root)")
    ap.add_argument("--copy-log", default=None, help="copy train_log.txt here with each record")
    ap.add_argument("--n-train", type=int)
    ap.add_argument("--n-real", type=int)
    ap.add_argument("--nf", type=int)
    ap.add_argument("--batch-size", type=int)
    ap.add_argument("--segments", type=int, nargs="+",
                    help="cumulative epoch targets; each end is a resume and a raw-G/EMA "
                         "snapshot")
    ap.add_argument("--schedule-epochs", type=int,
                    help="--num_epoch of every train process, the horizon of the per-epoch "
                         "cosine lr (default: the JAX soak's first segment, 100 flagship, 32 "
                         "celeba256); 0: each segment's own target, as the JAX tools ran "
                         "theirs")
    ap.add_argument("--kill-after", type=int, default=1,
                    help="SIGKILL the first segment after its content.pth save that follows "
                         "this many logged epochs (0: no kill)")
    ap.add_argument("--kill-delay", type=float, default=30.0,
                    help="seconds between that save and the kill (into the next epoch)")
    ap.add_argument("--ckpt-every", type=int)
    ap.add_argument("--content-every", type=int)
    ap.add_argument("--fid-samples", type=int, default=1024)
    ap.add_argument("--fid-batch", type=int)
    ap.add_argument("--dims", type=int, default=2048,
                    help="feature width: the Inception's 64, 192, 768 or 2048")
    ap.add_argument("--seed", type=int,
                    help="the data's and the FID samples' draws, and by default the training's")
    ap.add_argument("--train-seed", type=int,
                    help="the train CLI's --seed only (default: --seed): a second training run "
                         "on the same data and FID draws")
    ap.add_argument("--exp")
    ap.add_argument("--train-timeout", type=float, default=3300.0,
                    help="seconds a segment may take")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    recipe = RECIPES[args.recipe]
    for k, v in recipe.defaults.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    if args.train_seed is None:
        args.train_seed = args.seed
    if args.root is None:
        args.root = str(Path(tempfile.gettempdir()) / f"ddgan_torch_soak_{args.recipe}")
    if args.out is None:
        args.out = str(REPO / recipe.out)
    if args.schedule_epochs and any(t > args.schedule_epochs or t % args.content_every
                                    for t in args.segments):
        build_parser().error(f"with --schedule-epochs {args.schedule_epochs} each segment "
                             "ends at or before it, at a content.pth save (a multiple of "
                             f"--content-every {args.content_every}): {args.segments}")
    return args


def main(argv=None, feature_fn: Callable | None = None) -> dict:
    """Run a soak; returns its record. `feature_fn` as `Soak` takes it."""
    os.environ.setdefault("DDGAN_TPU_INCEPTION_RANDOM", "0")
    out = Soak(parse_args(argv), feature_fn).run()
    print(json.dumps({k: out[k] for k in ("fid_floor_two_real_draws", "resume_continuity_ok",
                                          "ema_fid_curve", "ema_vs_raw", "jax_reference")},
                     indent=2))
    return out


if __name__ == "__main__":
    main()
