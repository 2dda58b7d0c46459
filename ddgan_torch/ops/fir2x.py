"""The 2x separable FIR resample, as a CUDA kernel and as plain PyTorch.

Counterpart of `ddgan_tpu/ops/experimental/pallas_upfirdn.py` (`down2x`
:133, `up2x` :158, kernel `_sep_mxu_kernel` :56). Two patterns of
upfirdn2d with the 2-D kernel outer(k1d, k1d), 4 taps, H and W even:

  * down2x: up=1, down=2, pad=(1,1)  (N, C, H, W) -> (N, C, H/2, W/2)
  * up2x:   up=2, down=1, pad=(2,1)  (N, C, H, W) -> (N, C, 2H, 2W)

`down2x_ref` / `up2x_ref` are the plain versions. `down2x` / `up2x` launch
the hand-written kernel in `csrc/fir2x.cu` on a CUDA tensor and use the
plain version on a CPU tensor; any other input raises. The kernel is
forward only: it raises if its input needs a gradient.

The kernel is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, into `ddgan_torch/_build/`, and loaded
with ctypes. The library's name carries a hash of the source and the
flags, so an edited source is rebuilt. A build or launch failure raises;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .upfirdn2d import upfirdn2d_ref

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fir2x.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-O3",
    "-std=c++17",
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

# Launches of each kernel since the last reset; a run reads these to show
# that its path went through the kernels.
LAUNCHES = {"down2x": 0, "up2x": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------
# plain versions
def _kernel2d(k1d) -> torch.Tensor:
    k = np.asarray(k1d, np.float64)
    return torch.from_numpy(np.outer(k, k).astype(np.float32))


def down2x_ref(x: torch.Tensor, k1d) -> torch.Tensor:
    """upfirdn2d(up=1, down=2, pad=(1,1)) with kernel outer(k1d, k1d)."""
    return upfirdn2d_ref(x, _kernel2d(k1d), up=1, down=2, pad=(1, 1))


def up2x_ref(x: torch.Tensor, k1d) -> torch.Tensor:
    """upfirdn2d(up=2, down=1, pad=(2,1)) with kernel outer(k1d, k1d)."""
    return upfirdn2d_ref(x, _kernel2d(k1d), up=2, down=1, pad=(2, 1))


# --------------------------------------------------------------------------
# build and bind
def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the fir2x kernel needs the CUDA toolkit to build")


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library. With `verbose`, a
    compile prints what ptxas reports (registers, shared memory, spills)."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libfir2x_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {SOURCE}:\n{res.stderr}"
            )
        if verbose:
            print(res.stderr.strip())
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.ddgan_fir2x
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


# --------------------------------------------------------------------------
# wrappers
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, k1d, name: str) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.ndim != 4:
        raise ValueError(f"{name}: expected (N, C, H, W), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous (NCHW)")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"{name}: H and W must be even, got {tuple(x.shape)}")
    if len(k1d) != 4:
        raise ValueError(f"{name}: needs 4 taps, got {len(k1d)}")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward only; call it under torch.no_grad()"
        )
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: tensor too large for the kernel's int indexing")


def _launch(up: int, x: torch.Tensor, k1d, out_hw, name: str) -> torch.Tensor:
    _check(x, k1d, name)
    n, c, h, w = x.shape
    y = torch.empty((n, c) + out_hw, device=x.device, dtype=x.dtype)
    if y.numel() == 0:
        return y
    lib = build()
    taps = [float(v) for v in k1d]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ddgan_fir2x(
            up, _DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
            n * c, h, w, *taps, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def down2x(x: torch.Tensor, k1d) -> torch.Tensor:
    """FIR downsample by 2: the kernel on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return down2x_ref(x, k1d)
    return _launch(0, x, k1d, (x.shape[2] // 2, x.shape[3] // 2), "down2x")


def up2x(x: torch.Tensor, k1d) -> torch.Tensor:
    """FIR upsample by 2: the kernel on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return up2x_ref(x, k1d)
    return _launch(1, x, k1d, (x.shape[2] * 2, x.shape[3] * 2), "up2x")
