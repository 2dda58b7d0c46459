"""The decoded-volume cache of the LUNA16 readers: an LRU of 8 volumes.

The port's counterpart of the JAX package's native slice cache
(`ddgan_tpu/native/slicecache.cpp:167`, an LRU of 8 decoded volumes used by
`ddgan_tpu/data/datasets.py:121-131,178-186`). A LUNA16 slice record
names one 2-D slice of a 256³ `.nii.gz`; without a cache every slice
inflates and converts its whole volume again. The cost that removes is the
decode, so this cache is plain Python over the port's `read_nifti`: the
volumes it holds are `read_nifti`'s float64 arrays, so every slice equals
the uncached reader's bit for bit, and gzip's inflate stays zlib's C code.

`CACHE` is process-wide and thread-safe (the loader's prefetch threads
share it): a volume is decoded once however many threads ask for it at
the same time, and the cached arrays are read-only. Eight 256³ float64
volumes take 1 GiB. A `VolumeCache(0)` holds nothing and decodes every
request, which is the reader without a cache.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np

from .nifti import read_nifti

CAPACITY = 8  # volumes, as slicecache.cpp:167


class VolumeCache:
    """LRU of `capacity` decoded NIfTI volumes, keyed by path, size and
    modification time (a rewritten file is decoded again)."""

    def __init__(self, capacity: int = CAPACITY, reader=read_nifti):
        self.capacity = capacity
        self._reader = reader
        self._lock = threading.Lock()
        self._volumes: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._loading: dict[tuple, threading.Lock] = {}
        self.hits = 0
        self.decodes = 0

    def _lookup(self, key: tuple) -> np.ndarray | None:
        vol = self._volumes.get(key)
        if vol is not None:
            self._volumes.move_to_end(key)
            self.hits += 1
        return vol

    def get(self, path) -> np.ndarray:
        """The volume at `path` as `read_nifti` returns it (read-only)."""
        st = os.stat(path)
        key = (str(path), st.st_size, st.st_mtime_ns)
        with self._lock:
            vol = self._lookup(key)
            if vol is not None:
                return vol
            pending = self._loading.setdefault(key, threading.Lock())
        with pending:  # one decode per volume; the other threads wait for it
            with self._lock:
                vol = self._lookup(key)
            if vol is not None:
                return vol
            try:
                vol = self._reader(key[0])
                vol.flags.writeable = False
                with self._lock:
                    self.decodes += 1
                    if self.capacity > 0:
                        self._volumes[key] = vol
                        while len(self._volumes) > self.capacity:
                            self._volumes.popitem(last=False)
            finally:
                with self._lock:
                    self._loading.pop(key, None)
        return vol

    def __len__(self) -> int:
        return len(self._volumes)


CACHE = VolumeCache()


def volume(path) -> np.ndarray:
    """The decoded volume at `path`, through the process-wide `CACHE`."""
    return CACHE.get(path)


def read_slice(path, axis: str, index: int) -> np.ndarray:
    """One 2-D slice along 'x', 'y' or 'z' (custom.py:190-196), a copy."""
    patch = volume(path)
    if index < 0 or index >= patch.shape["xyz".index(axis)]:
        raise IndexError(f"Slice index {index} out of bounds")
    if axis == "x":
        return patch[index, :, :].copy()
    if axis == "y":
        return patch[:, index, :].copy()
    return patch[:, :, index].copy()
