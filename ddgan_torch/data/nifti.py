"""Minimal pure-numpy NIfTI-1 reader/writer (.nii / .nii.gz).

The port's own copy of `ddgan_tpu/data/nifti.py`. It replaces the
reference's nibabel dependency (datasets_prep/custom.py:6,
`nib.load(...).get_fdata()`) with a self-contained implementation of the
NIfTI-1 on-disk format — enough for the LUNA16 volumes (single-file .nii.gz,
scalar datatypes, Fortran-ordered voxels). get_fdata semantics match
nibabel: float64 output with scl_slope/scl_inter applied.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_HDR_SIZE = 348

# NIfTI-1 datatype codes → numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str | Path, mode: str = "rb"):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str | Path) -> np.ndarray:
    """Read a NIfTI-1 volume as float64 (nibabel get_fdata semantics)."""
    with _open(path) as f:
        hdr = f.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        if sizeof_hdr == 348:
            end = "<"
        elif struct.unpack_from(">i", hdr, 0)[0] == 348:
            end = ">"
        else:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        magic = hdr[344:348]
        if magic[:2] not in (b"n+", b"ni"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

        ndim = struct.unpack_from(end + "h", hdr, 40)[0]
        dims = struct.unpack_from(end + "7h", hdr, 42)[:ndim]
        datatype = struct.unpack_from(end + "h", hdr, 70)[0]
        vox_offset = int(struct.unpack_from(end + "f", hdr, 108)[0])
        scl_slope = struct.unpack_from(end + "f", hdr, 112)[0]
        scl_inter = struct.unpack_from(end + "f", hdr, 116)[0]

        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(end)

        f.seek(max(vox_offset, _HDR_SIZE))
        count = int(np.prod(dims))
        raw = f.read(count * dtype.itemsize)
        data = np.frombuffer(raw, dtype=dtype, count=count)

    # NIfTI voxels are Fortran-ordered
    data = data.reshape(dims, order="F").astype(np.float64)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter
    return data


def write_nifti(path: str | Path, data: np.ndarray) -> None:
    """Write a minimal single-file NIfTI-1 volume (for tests/converters)."""
    data = np.asarray(data)
    code = _DTYPE_CODES.get(np.dtype(data.dtype))
    if code is None:
        data = data.astype(np.float32)
        code = 16
    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, 348)
    dims = data.shape
    struct.pack_into("<h", hdr, 40, len(dims))
    for i, d in enumerate(dims):
        struct.pack_into("<h", hdr, 42 + 2 * i, d)
    for i in range(len(dims), 7):
        struct.pack_into("<h", hdr, 42 + 2 * i, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    # pixdim[0..n] = 1.0
    for i in range(8):
        struct.pack_into("<f", hdr, 76 + 4 * i, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    hdr[344:348] = b"n+1\x00"
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(data).tobytes(order="F"))
