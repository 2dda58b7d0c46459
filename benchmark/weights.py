"""Inputs the benchmark makes from the seed, the same for the program and
the reference: weights, the pool of real batches, and the generators of
the draws.

Weights follow the law of `ddgan_torch.utils.randomize_parameters_`,
N(0, 1) / sqrt(fan_in) (fan_in = numel / shape[0] for a weight, numel for a
vector), drawn on the device in one call for a network: the parameters in
the order of their sorted names take consecutive pieces of one normal
vector. Under the recipes' own init each block's last conv and G's head
are ~1e-10, so G's output would be ~0 and no comparison could fail. The
discriminator's head is the one exception (`disc_scale`).
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (`tag`) of a run's `seed`."""
    return int(hashlib.sha256(f"{int(seed)}:{tag}".encode()).hexdigest()[:15], 16)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def disc_scale(cfg: dict) -> dict:
    """The discriminator's head weight drawn smaller by the number of
    positions it sums: its logits then start at a few units. Drawn by the
    law alone they start at 30 to 45 (each block adds a per-channel offset
    of the time embedding, and the head sums the 4x4 final map), where the
    softplus losses saturate, G's gradients fall to 1e-15 and bfloat16 and
    float32 runs part by chaotic margins."""
    n_down = 3 if str(cfg.get("disc_small", "yes")).lower() == "yes" else 6
    side = max(1, int(cfg["image_size"]) >> n_down)
    return {"end_linear.weight": 1.0 / (side * side)}


@torch.no_grad()
def fill_weights(module: torch.nn.Module, seed: int, tag: str,
                 scale: dict | None = None) -> None:
    """Overwrite every parameter of `module` (all on one device, float32);
    a parameter named in `scale` is multiplied by its factor."""
    scale = scale or {}
    named = sorted(module.named_parameters(), key=lambda kv: kv[0])
    dev = named[0][1].device
    flat = torch.randn(sum(p.numel() for _, p in named), generator=generator(seed, tag, dev),
                       device=dev)
    off = 0
    for name, p in named:
        n = p.numel()
        fan_in = n // p.shape[0] if p.ndim > 1 else n
        p.copy_(flat[off:off + n].view_as(p) * (scale.get(name, 1.0) / math.sqrt(max(fan_in, 1))))
        off += n


def real_pool(seed: int, batches: int, shape: tuple, device) -> torch.Tensor:
    """`batches` batches of `shape`, uniform in [-1, 1), resident on the device."""
    g = generator(seed, "real", device)
    return torch.rand((batches,) + tuple(shape), generator=g, device=device) * 2.0 - 1.0
