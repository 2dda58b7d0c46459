"""Weights into the port: the JAX package's parameter tree, its
`netG_*.ckpt` files, or a reference `netG_*.pth`.

The port's module names are the reference torch keys (`all_modules.{i}.…`,
`z_transform.{2j+1}.…`, no `conv` / `linear` wrapper level), so
`load_state_dict(strict=True)` takes both the output of
`state_dict_from_flax` and a reference checkpoint. `state_dict_from_flax`
is this package's own copy of the logic of the JAX package's
`export_torch_state_dict` (`ddgan_tpu/compat/torch_import.py:194-250`); it
reads nested mappings of numpy arrays and needs no JAX. `flax_tree_from_port`
goes the other way without a JAX template: the flax path of each parameter
follows from the port module that holds it, as the JAX package's classes
name their wrapped layers (`Conv3x3`, `Conv1x1`, `ConvLayer` → "conv";
`Dense` → "linear"; `_TembProj` → "dense"; a plain `Linear` has no
wrapper). Both take arrays with leading axes (`lead`), such as a swarm's
(swarm, *param_shape) positions, and map each member alike.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..nn.blocks import FirConv2d, _TembProj
from ..nn.layers import Conv2d, Dense
from .msgpack import read_msgpack

_WRAPPERS = ("conv", "linear", "dense")
# the wrapper level the JAX package's class puts around each port class's
# parameters (subclasses first)
_WRAPPER_OF = ((_TembProj, "dense"), (Dense, "linear"), (Conv2d, "conv"))


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


def _swap(arr: np.ndarray, lead: int, order: tuple) -> np.ndarray:
    """arr with its trailing axes permuted by `order`, the leading `lead` kept."""
    return arr.transpose(tuple(range(lead)) + tuple(lead + i for i in order))


def _leaf_to_torch(leaf_name: str, arr: np.ndarray, lead: int = 0) -> tuple[str, np.ndarray]:
    """(torch leaf name, array in torch layout)."""
    nd = arr.ndim - lead
    if leaf_name in ("kernel", "weight") and nd == 4:  # HWIO → OIHW (FirConv2d: raw weight)
        return "weight", _swap(arr, lead, (3, 2, 0, 1))
    if leaf_name == "kernel":
        return "weight", _swap(arr, lead, (1, 0))  # (in, out) → (out, in)
    if leaf_name == "scale":
        return "weight", arr
    return leaf_name, arr  # bias, W, b


def state_dict_from_flax(params, buffers=None, lead: int = 0) -> dict[str, torch.Tensor]:
    """The port's (and the reference's) state_dict from a flax (params,
    buffers) tree of numpy arrays. DownConvBlock's 1-element Sequential
    indices (conv1.0, conv2.0, skip.0) are reinstated for discriminators.
    Arrays with `lead` leading axes map each member alike."""
    flat = _flatten(params)
    if buffers:
        flat.update(_flatten(buffers))
    out: dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        parts = _invert_path(path)
        leaf, value = _leaf_to_torch(path[-1], np.asarray(arr, np.float32), lead)
        if parts and parts[-1] in ("conv1", "conv2", "skip") and "all_modules" not in parts:
            parts = parts + ["0"]
        out[".".join(parts + [leaf])] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return out


def _translate_path(parts: list[str]) -> list[str]:
    """Torch module segments → flax ones (the JAX package's
    `compat/torch_import.py:_translate_path`)."""
    out: list[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else ""
        if p == "all_modules" and nxt.isdigit():
            out.append(f"all_modules_{nxt}")
            i += 2
        elif p == "z_transform" and nxt.isdigit():
            # Sequential [PixelNorm, dense, act, dense, act, ...]: a dense at each odd index
            out.append(f"z_transform_layers_{(int(nxt) - 1) // 2}")
            i += 2
        elif p == "main" and nxt.isdigit():
            out.append(f"dense{int(nxt) // 2}")  # t_embed.main.{0,2} → dense{0,1}
            i += 2
        elif p.isdigit():
            i += 1  # a 1-element Sequential's index (conv1.0.weight → conv1)
        else:
            out.append(p)
            i += 1
    return out


def flax_path(module: torch.nn.Module, key: str) -> tuple[str, ...]:
    """The JAX package's parameter path of the port parameter `key` of `module`."""
    parts = key.split(".")
    owner = module.get_submodule(".".join(parts[:-1]))
    path = _translate_path(parts[:-1])
    path += [w for cls, w in _WRAPPER_OF if isinstance(owner, cls)][:1]
    leaf = parts[-1]
    if leaf == "weight" and not isinstance(owner, FirConv2d):
        leaf = "scale" if owner.weight.dim() == 1 else "kernel"
    return tuple(path) + (leaf,)


def flax_tree_from_port(module: torch.nn.Module, tensors: dict[str, torch.Tensor],
                        lead: int = 0) -> dict:
    """`tensors` (keyed like `module.named_parameters()`, each with `lead`
    leading axes) as the JAX package's nested parameter tree of numpy
    arrays: the inverse of `state_dict_from_flax`."""
    tree: dict = {}
    for key, t in tensors.items():
        path = flax_path(module, key)
        arr = t.detach().cpu().numpy()
        nd = arr.ndim - lead
        if path[-1] in ("kernel", "weight") and nd == 4:
            arr = _swap(arr, lead, (2, 3, 1, 0))  # OIHW → HWIO
        elif path[-1] == "kernel":
            arr = _swap(arr, lead, (1, 0))
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


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
