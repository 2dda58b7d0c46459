"""A reader and a writer of flax msgpack files on the standard library.

The counterpart of `flax.serialization.msgpack_restore`, which the JAX
package's checkpoints are written for (`ddgan_tpu/train/checkpoint.py`):
`netG_{epoch}.ckpt` and `content.ckpt`. It decodes every msgpack type
(nil, bool, int and float of every width, str, bin, array, map, ext) and
flax's three ext codes:

  1  an ndarray, whose payload is itself msgpack: (shape, dtype name,
     C-order bytes);
  2  a complex scalar, (real, imag);
  3  a numpy scalar, stored as a 0-d ndarray.

Arrays come back as read-only numpy arrays over the file's bytes, as flax
returns them, except bfloat16, which numpy lacks: those leaves are
`torch.bfloat16` tensors. Leaves that flax split into chunks (arrays over
`2**30` bytes, the `__msgpack_chunked_array__` dicts) are joined again.
Maps are dicts with str keys; flax stores lists and tuples as {"0": ...}
dicts, and they stay so.

`write_msgpack` is the reader's mirror, the counterpart of
`flax.serialization.msgpack_serialize`: maps with str keys, lists, None,
bools, ints, floats, str, bytes, and arrays (numpy arrays, numpy scalars,
torch tensors, bfloat16 included) as flax's ext types 1 and 3, arrays over
`2**30` bytes split into chunks as flax splits them. It picks the encoding
msgpack-python picks for each value and keeps the maps' order, so its bytes
are those `flax.serialization.to_bytes` writes for the same state dict.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width scalars: marker -> struct format
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# length-prefixed containers: marker -> (kind, struct format of the length)
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """Decodes one msgpack object after another from a buffer."""

    def __init__(self, data, raw: bool = False, bin_view: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax reads the ndarray header so)
        self.bin_view = bin_view  # bin as a view of the buffer, not a copy

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            code = self.unpack(">b")
            return _ext(code, self.take(_FIXEXT[b]))
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n) if self.bin_view else bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack object")

    def str(self, n: int):
        s = self.take(n)
        return bytes(s) if self.raw else str(s, "utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _ndarray(payload: memoryview):
    """flax's `_ndarray_from_bytes`: (shape, dtype name, C-order bytes)."""
    shape, name, buf = _Reader(payload, raw=True, bin_view=True).read()
    if name == b"bfloat16":
        bits = np.frombuffer(buf, np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape)


def _ext(code: int, payload: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        re, im = _Reader(payload).read()
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not one that flax writes")


def _dict_to_tuple(d: dict) -> tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict):
    shape = _dict_to_tuple(d["shape"])
    chunks = _dict_to_tuple(d["chunks"])
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree):
    """flax's `_unchunk_array_leaves_in_place`."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            tree[k] = _unchunk_leaves(v)
    return tree


def read_msgpack(data: bytes):
    """The tree that `flax.serialization.msgpack_restore(data)` returns."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return _unchunk_leaves(tree)


# ---------------------------------------------------------------------------
# the writer
_MAX_CHUNK = 2**30  # flax's MAX_CHUNK_SIZE


def _head(out: list, n: int, fix: int | None, fix_max: int, markers: tuple) -> None:
    """A container or bytes header: the fixed form for n < fix_max, else
    the smallest of the 8/16/32-bit length forms in `markers` (None where
    the type has no such form)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for marker, fmt, limit in zip(markers, (">B", ">H", ">I"), (2**8, 2**16, 2**32)):
        if marker is not None and n < limit:
            out.append(bytes([marker]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack cannot hold a length of {n}")


def _int(out: list, v: int) -> None:
    if 0 <= v < 128 or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = ((0xCC, ">B", 0, 2**8), (0xCD, ">H", 0, 2**16), (0xCE, ">I", 0, 2**32),
             (0xCF, ">Q", 0, 2**64)) if v >= 0 else \
        ((0xD0, ">b", -2**7, 0), (0xD1, ">h", -2**15, 0), (0xD2, ">i", -2**31, 0),
         (0xD3, ">q", -2**63, 0))
    for marker, fmt, lo, hi in forms:
        if lo <= v < hi:
            out.append(bytes([marker]) + struct.pack(fmt, v))
            return
    raise ValueError(f"msgpack cannot hold the integer {v}")


def _ndarray_payload(arr) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack of (shape, dtype name, C-order bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, data = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, data = a.shape, a.dtype.name, a.tobytes("C")
    else:
        shape, name, data = arr.shape, arr.dtype.name, arr.tobytes("C")
    out: list = []
    _pack(out, (list(shape), name, data))
    return b"".join(out)


def _write_ext(out: list, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {size: marker for marker, size in _FIXEXT.items()}
    if n in fixed:
        out.append(bytes([fixed[n]]) + struct.pack(">b", code))
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", code))
    out.append(payload)


def _chunked(arr) -> dict:
    """flax's `_chunk`: an oversized array as a dict of flat chunks."""
    flat = arr.reshape(-1)
    itemsize = flat.element_size() if isinstance(flat, torch.Tensor) else flat.dtype.itemsize
    size = max(1, int(_MAX_CHUNK / itemsize))
    chunks = [flat[i:i + size] for i in range(0, len(flat), size)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _nbytes(arr) -> int:
    return arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor) else arr.nbytes


def _pack(out: list, obj, chunk: bool = False) -> None:
    """Append obj's msgpack bytes to `out`. `chunk`: an oversized array here
    is split, as flax splits the arrays that are map values or the whole tree."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        if chunk and _nbytes(obj) > _MAX_CHUNK:
            _pack(out, _chunked(obj))
        else:
            _write_ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _write_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(obj))
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v, chunk=True)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"{type(obj).__name__} is no type a flax msgpack file holds")


def write_msgpack(tree) -> bytes:
    """The bytes that `flax.serialization.msgpack_serialize(tree,
    in_place=True)` writes (what `flax.serialization.to_bytes` calls)."""
    out: list = []
    _pack(out, tree, chunk=True)
    return b"".join(out)
