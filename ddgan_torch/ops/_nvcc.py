"""Build a CUDA source of `ddgan_torch/csrc/` into a shared library and load it.

Each kernel source has a plain C interface. It is compiled with nvcc for
sm_90a at first use into `ddgan_torch/_build/` (git-ignored) and loaded
with ctypes; the library's name carries a hash of the source and the
flags, so an edited source is rebuilt. A build failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
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
# what ptxas reported for each source compiled by this process (registers,
# shared memory, spills), by source name
PTXAS = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def compile_and_load(source: str, compiler: str, flags: list, report: dict | None = None,
                     verbose: bool = False) -> ctypes.CDLL:
    """Compile `csrc/<source>` with `compiler` and `flags` into
    `_build/lib<stem>_<hash>.so` unless that library exists, and load it.
    The compiler's standard error is kept in `report[source]` (and printed
    with `verbose`); a failed compile raises."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{Path(compiler).name} failed ({res.returncode}) building "
                               f"{src}:\n{res.stderr}")
        if report is not None:
            report[source] = res.stderr
        if verbose:
            print(res.stderr.strip())
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))


def build(source: str, verbose: bool = False) -> ctypes.CDLL:
    """Compile `csrc/<source>` (if its library is not built yet) and load it.
    With `verbose`, a compile prints what ptxas reports (registers, shared
    memory, spills)."""
    return compile_and_load(source, find_nvcc(), NVCC_FLAGS, PTXAS, verbose)
