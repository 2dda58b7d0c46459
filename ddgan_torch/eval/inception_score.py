"""Inception Score: exp(E_x KL(p(y|x) || p(y))) over splits.

The port's own copy of `ddgan_tpu/eval/inception_score.py` (reference:
pytorch_fid/inception_score.py:44-90). The classifier is pluggable, any
`logits_fn(batch) -> (B, num_classes)`; the default is the FID-Inception
logits head of `ddgan_torch.eval.inception` on the GPU.

Also a standalone CLI mirroring the reference's __main__
(inception_score.py:93-103): `python -m ddgan_torch.eval.inception_score
--sample_dir <samples.npy | dir of per-image .npy>` loads uint8-range
[0,255] images, clips, scores with splits=1 and prints mean/std, with real
weights via DDGAN_TPU_INCEPTION_PATH or seeded random logits via
DDGAN_TPU_INCEPTION_RANDOM, on the GPU unless $DDGAN_TORCH_DEVICE=cpu.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Sequence

import numpy as np


def inception_score_from_probs(
    probs: np.ndarray, splits: int = 1
) -> tuple[float, float]:
    """IS from softmax probabilities (N, C). Returns (mean, std) over splits.

    Per split s: exp( mean_i KL(p(y|x_i) || mean_j p(y|x_j)) ).
    (inception_score.py:64-82)
    """
    probs = np.asarray(probs, dtype=np.float64)
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


def get_inception_score(
    images: Sequence[np.ndarray],
    logits_fn: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 50,
    splits: int = 10,
) -> tuple[float, float]:
    """IS over images in [0,1] NHWC using a pluggable classifier.
    (inception_score.py:80-90 protocol: batches → softmax → split KL.)"""
    all_probs = []
    for i in range(0, len(images), batch_size):
        batch = np.stack([np.asarray(im, np.float32) for im in images[i : i + batch_size]])
        logits = np.asarray(logits_fn(batch))
        logits = logits - logits.max(axis=1, keepdims=True)
        e = np.exp(logits)
        all_probs.append(e / e.sum(axis=1, keepdims=True))
    return inception_score_from_probs(np.concatenate(all_probs), splits=splits)


# --------------------------------------------------------------------------
# standalone CLI (reference inception_score.py:93-103)
def load_sample_array(path: str, value_range: str = "auto") -> np.ndarray:
    """Load samples as (N, H, W, 3) float in [0, 255].

    Accepts the reference's single .npy stack (N,3,H,W or N,H,W,3) or a
    directory of per-image .npy files as written by `test_cli --save_npy`
    (each (3,H,W), values in [0,1] → rescaled to [0,255]).

    value_range: "255" (input already [0,255]), "1" (input [0,1], always
    rescale ×255), or "auto" — a per-image-dir (the --save_npy protocol,
    always [0,1]) rescales; a single stack rescales only when max ≤ 1 and
    PRINTS the inferred range so a legitimately near-black [0,255] stack
    is not silently misscaled."""
    is_dir = os.path.isdir(path)
    if is_dir:
        files = sorted(
            (f for f in os.listdir(path) if f.endswith(".npy")),
            key=lambda f: (len(f), f),  # numeric-ish order for 0.npy..N.npy
        )
        if not files:
            raise FileNotFoundError(f"No .npy files in {path}")
        data = np.stack([np.load(os.path.join(path, f)) for f in files])
    else:
        data = np.load(path)
    data = np.asarray(data, np.float32)
    if data.ndim != 4:
        raise ValueError(f"Expected 4-D sample array, got shape {data.shape}")
    if data.shape[1] == 3 and data.shape[-1] != 3:
        data = data.transpose(0, 2, 3, 1)  # NCHW → NHWC
    if value_range == "1":
        data = data * 255.0
    elif value_range == "auto":
        if is_dir:  # --save_npy per-image protocol is always [0,1]
            data = data * 255.0
        elif data.max() <= 1.0 + 1e-6:
            print(
                f"inferred [0,1] input range (max={data.max():.4g}); "
                "rescaling ×255 — pass --range 255 if this stack is "
                "genuinely near-black [0,255] data"
            )
            data = data * 255.0
    elif value_range != "255":
        raise ValueError(f"unknown value_range {value_range!r}")
    return data


def main(argv: Sequence[str] | None = None) -> tuple[float, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--sample_dir", default="./saved_samples/",
        help="path to saved images (.npy stack or directory of .npy files)",
    )
    parser.add_argument("--splits", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument(
        "--range", dest="value_range", choices=["auto", "255", "1"],
        default="auto",
        help="input value range: 255 = already [0,255]; 1 = [0,1] (rescale "
             "×255); auto = per-image dirs rescale, stacks infer by max",
    )
    opt = parser.parse_args(argv)

    data = load_sample_array(opt.sample_dir, value_range=opt.value_range)
    data = np.clip(data, 0, 255)
    print(
        "Calculating Inception Score with %i images in %i splits"
        % (data.shape[0], opt.splits)
    )
    start_time = time.time()

    from .inception import default_logits_fn

    logits_fn = default_logits_fn()
    # classifier protocol: NHWC in [0,1] (resized to 299 inside)
    m, s = get_inception_score(
        list(data / 255.0), logits_fn, batch_size=opt.batch_size, splits=opt.splits
    )
    print("Inception Score calculation time: %f s" % (time.time() - start_time))
    print("mean: ", m)
    print("std: ", s)
    return m, s


if __name__ == "__main__":
    main()
