"""FID: activation statistics and the Fréchet distance.

The port's own copy of `ddgan_tpu/eval/fid.py` (reference:
pytorch_fid/fid_score.py). The statistics math (`calculate_frechet_distance`,
its eps-regularised `scipy.linalg.sqrtm` retry and its imaginary-component
check) is the reference's, line for line. Features come from a pluggable
`feature_fn(batch_nhwc_float01) -> (B, dims)`, by default the port's
FID-InceptionV3 (`ddgan_torch.eval.inception`) on the GPU. Images are read
with the port's decoders (`utils.decode_images`: PNG, JPEG, WebP, BMP,
PBM/PGM/PPM and TIFF, the format told by the file's first bytes) and resized with its copy of PIL's bilinear (`data/resize.py`);
precomputed .npz / .npy statistics stand in for an image directory.
"""

from __future__ import annotations

import os
import pathlib
from typing import Callable, Sequence

import numpy as np
from scipy import linalg

from ..data.resize import BILINEAR, resize as resize_image
from ..utils import decode_images

IMAGE_EXTENSIONS = {"bmp", "jpg", "jpeg", "pgm", "png", "ppm", "tif", "tiff", "webp"}


def list_image_files(path: str | pathlib.Path) -> list[pathlib.Path]:
    path = pathlib.Path(path)
    return sorted(
        f for ext in IMAGE_EXTENSIONS for f in path.glob(f"*.{ext}")
    )


def _load_images_01(paths: Sequence, resize: int = 0) -> list[np.ndarray]:
    """(H, W, 3) float32 in [0, 1] of each image file, decoded together
    (`decode_images`: PNG, JPEG, WebP, BMP, PBM/PGM/PPM and TIFF; what they
    do not read raises NotImplementedError naming ROADMAP.md Queue 1 item
    13i), each resized to resize² with PIL's
    bilinear first when resize > 0 (`ddgan_tpu/eval/fid.py:31-37`)."""
    datas = []
    for path in paths:
        with open(path, "rb") as f:
            datas.append(f.read())
    images = decode_images(datas)
    if resize > 0:
        images = [resize_image(img, (resize, resize), BILINEAR) for img in images]
    return [img.astype(np.float32) / 255.0 for img in images]


def get_activations(
    files: Sequence,
    feature_fn: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 50,
    dims: int = 2048,
    resize: int = 0,
) -> np.ndarray:
    """pool3 activations for a list of image files or arrays.

    (fid_score.py:107-166; the trailing partial batch IS processed, like
    the reference's drop_last=False loader.)
    """
    if batch_size > len(files):
        print(
            "Warning: batch size is bigger than the data size. "
            "Setting batch size to data size"
        )
        batch_size = len(files)

    pred_arr = np.empty((len(files), dims), dtype=np.float64)
    start = 0
    for i in range(0, len(files), batch_size):
        chunk = files[i : i + batch_size]
        decoded = iter(_load_images_01(
            [f for f in chunk if isinstance(f, (str, os.PathLike))], resize))
        imgs = []
        for f in chunk:
            if isinstance(f, (str, os.PathLike)):
                imgs.append(next(decoded))
            else:
                arr = np.asarray(f, dtype=np.float32)
                if arr.ndim == 2:
                    arr = np.stack([arr] * 3, axis=-1)
                if arr.max() > 1.5:
                    arr = arr / 255.0
                imgs.append(arr)
        batch = np.stack(imgs)
        feats = np.asarray(feature_fn(batch))
        if feats.ndim > 2:  # spatial features → global average pool
            feats = feats.mean(axis=tuple(range(1, feats.ndim - 1)))
        pred_arr[start : start + len(chunk)] = feats
        start += len(chunk)
    return pred_arr


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians. (fid_score.py:169-223, exact port)"""
    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)

    assert mu1.shape == mu2.shape, (
        "Training and test mean vectors have different lengths"
    )
    assert sigma1.shape == sigma2.shape, (
        "Training and test covariances have different dimensions"
    )

    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        print(
            "fid calculation produces singular product; "
            f"adding {eps} to diagonal of cov estimates"
        )
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))

    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real

    tr_covmean = np.trace(covmean)
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean
    )


def calculate_activation_statistics(
    files, feature_fn, batch_size=50, dims=2048, resize=0
):
    act = get_activations(files, feature_fn, batch_size, dims, resize)
    mu = np.mean(act, axis=0)
    sigma = np.cov(act, rowvar=False)
    return mu, sigma


def compute_statistics_of_path(path, feature_fn, batch_size=50, dims=2048, resize=0):
    """Directory of images, or precomputed .npz/.npy stats. (fid_score.py:251-265)"""
    if isinstance(path, str) and path.endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    if isinstance(path, str) and path.endswith(".npy"):
        stats = np.load(path, allow_pickle=True).item()
        return stats["mu"][:], stats["sigma"][:]
    files = list_image_files(path)
    return calculate_activation_statistics(files, feature_fn, batch_size, dims, resize)


def calculate_fid_given_paths(
    paths: Sequence[str],
    batch_size: int = 50,
    device=None,
    dims: int = 2048,
    feature_fn: Callable | None = None,
    resize: int = 0,
) -> float:
    """FID between two paths (dirs or stat files). (fid_score.py:268-285)

    `device` is where the default feature function runs (GPU unless the CPU
    is asked for); it is not read when `feature_fn` is given."""
    for p in paths:
        if not os.path.exists(p):
            raise RuntimeError(f"Invalid path: {p}")
    if feature_fn is None:
        from .inception import default_feature_fn

        feature_fn = default_feature_fn(dims=dims, device=device)
    m1, s1 = compute_statistics_of_path(paths[0], feature_fn, batch_size, dims, resize)
    m2, s2 = compute_statistics_of_path(paths[1], feature_fn, batch_size, dims, resize)
    return calculate_frechet_distance(m1, s1, m2, s2)


def save_statistics(path: str, mu: np.ndarray, sigma: np.ndarray) -> None:
    np.savez(path, mu=mu, sigma=sigma)


def main(argv=None, feature_fn: Callable | None = None):
    """Standalone FID CLI. (fid_score.py:72-83, :289-301)

    python -m ddgan_torch.eval.fid path/to/real path/to/fake
    python -m ddgan_torch.eval.fid --save-stats path/to/imgs stats.npz

    On the GPU unless $DDGAN_TORCH_DEVICE=cpu. A caller may pass its own
    `feature_fn` ((B, H, W, C) in [0, 1] -> (B, --dims)) for the Inception's.
    """
    import argparse

    p = argparse.ArgumentParser(description="FID between two paths")
    p.add_argument("path", nargs=2, help="image dirs or .npz stats files")
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--dims", type=int, default=2048)
    p.add_argument("--save-stats", action="store_true",
                   help="compute stats of path[0] and write to path[1].npz")
    p.add_argument("--resize", type=int, default=0)
    args = p.parse_args(argv)

    if feature_fn is None:
        from .inception import default_feature_fn

        feature_fn = default_feature_fn(dims=args.dims)
    if args.save_stats:
        files = list_image_files(args.path[0])
        mu, sigma = calculate_activation_statistics(
            files, feature_fn, args.batch_size, args.dims, args.resize
        )
        save_statistics(args.path[1], mu, sigma)
        print(f"stats saved to {args.path[1]}")
        return None
    fid = calculate_fid_given_paths(
        args.path, args.batch_size, dims=args.dims,
        feature_fn=feature_fn, resize=args.resize,
    )
    print("FID: ", fid)
    return fid


if __name__ == "__main__":
    main()
