"""Weights into the port: the JAX package's parameter tree, its
`netG_*.ckpt` files, or a reference `netG_*.pth`.

The port's module names are the reference torch keys (`all_modules.{i}.…`,
`z_transform.{2j+1}.…`, no `conv` / `linear` wrapper level), so
`load_state_dict(strict=True)` takes both the output of
`state_dict_from_flax` and a reference checkpoint. `state_dict_from_flax`
is this package's own copy of the logic of the JAX package's
`export_torch_state_dict` (`ddgan_tpu/compat/torch_import.py:194-250`); it
reads nested mappings of numpy arrays and needs no JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .msgpack import read_msgpack

_WRAPPERS = ("conv", "linear", "dense")


def strip_module_prefix(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Remove DDP 'module.' prefixes. (ddgan.py:377-386)"""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def _flatten(tree, prefix=()) -> dict[tuple, Any]:
    out = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def _invert_path(path: tuple) -> list[str]:
    """flax path segments → torch dotted-key segments."""
    parts: list[str] = []
    for seg in path[:-1]:
        if seg.startswith("all_modules_"):
            parts.extend(["all_modules", seg[len("all_modules_"):]])
        elif seg.startswith("z_transform_layers_"):
            j = int(seg[len("z_transform_layers_"):])
            parts.extend(["z_transform", str(2 * j + 1)])
        elif seg == "dense0":
            parts.extend(["main", "0"])
        elif seg == "dense1":
            parts.extend(["main", "2"])
        elif seg in _WRAPPERS:
            continue  # the JAX package's wrapper level has no torch counterpart
        else:
            parts.append(seg)
    return parts


def _leaf_to_torch(leaf_name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    """(torch leaf name, array in torch layout)."""
    if leaf_name == "kernel":
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)  # HWIO → OIHW
        return "weight", arr.T  # (in, out) → (out, in)
    if leaf_name == "weight" and arr.ndim == 4:  # FirConv2d raw HWIO weight
        return "weight", arr.transpose(3, 2, 0, 1)
    if leaf_name == "scale":
        return "weight", arr
    return leaf_name, arr  # bias, W, b


def state_dict_from_flax(params, buffers=None) -> dict[str, torch.Tensor]:
    """The port's (and the reference's) state_dict from a flax (params,
    buffers) tree of numpy arrays. DownConvBlock's 1-element Sequential
    indices (conv1.0, conv2.0, skip.0) are reinstated for discriminators."""
    flat = _flatten(params)
    if buffers:
        flat.update(_flatten(buffers))
    out: dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        parts = _invert_path(path)
        leaf, value = _leaf_to_torch(path[-1], np.asarray(arr, np.float32))
        if parts and parts[-1] in ("conv1", "conv2", "skip") and "all_modules" not in parts:
            parts = parts + ["0"]
        out[".".join(parts + [leaf])] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return out


def load_netg_pth(path: str) -> dict[str, torch.Tensor]:
    """A reference netG_{epoch}.pth as a state_dict on the CPU, with DDP
    'module.' prefixes stripped. (test_ddgan.py:156-162)"""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return strip_module_prefix(sd)


def load_netg_ckpt(path: str) -> dict[str, torch.Tensor]:
    """A JAX package `netG_{epoch}.ckpt` (flax msgpack of {"params", and
    "buffers" when the generator has any}; `ddgan_tpu/train/checkpoint.py:
    save_netg`) as the port's state_dict on the CPU."""
    with open(path, "rb") as f:
        payload = read_msgpack(f.read())
    return state_dict_from_flax(payload["params"], payload.get("buffers"))
