"""Device resolution for every entry point of the port.

The port runs on the GPU by default. The CPU is used only when the caller
asks for it: a `device="cpu"` argument, or the environment variable
`DDGAN_TORCH_DEVICE=cpu` (the counterpart of the JAX package's
`DDGAN_TPU_FORCE_PLATFORM`). Without a GPU and without such a request,
resolution raises instead of falling back to the CPU in silence.
"""

from __future__ import annotations

import os

import torch

ENV_VAR = "DDGAN_TORCH_DEVICE"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `device`, else $DDGAN_TORCH_DEVICE,
    else `cuda`. Raises RuntimeError for a CUDA device when none is present."""
    if device is None:
        device = os.environ.get(ENV_VAR) or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ddgan_torch runs on a CUDA GPU and none is available; pass "
            f"device='cpu' or set {ENV_VAR}=cpu to run on the CPU."
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
