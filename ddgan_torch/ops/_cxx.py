"""Build a host C++ source of `ddgan_torch/csrc/` into a shared library and load it.

The host sources (the JPEG, WebP and TIFF decoders) have a plain C
interface, as the CUDA kernels do. Each is compiled with the host C++ compiler (`$CXX`, else
`c++`) at first use into `ddgan_torch/_build/` (git-ignored), named by a
hash of the source and the flags (`_nvcc.compile_and_load`), and loaded
with ctypes. A build failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil

from . import _nvcc

CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def find_cxx() -> str:
    found = shutil.which(os.environ.get("CXX") or "c++")
    if found is None:
        raise RuntimeError("no host C++ compiler ($CXX or c++) to build the image decoders")
    return found


def build(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` with the host compiler (if its library is
    not built yet) and load it."""
    return _nvcc.compile_and_load(source, find_cxx(), CXX_FLAGS)
