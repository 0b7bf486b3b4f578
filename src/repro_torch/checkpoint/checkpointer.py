"""Tree checkpointing, npz-based (a port of
``repro.checkpoint.checkpointer``, in the reference's file format).

A tree of nested dicts, lists and tuples is flattened with path-derived
keys — the dict keys and list indices from the root, joined by ``"::"``
(``repro_torch.utils.tree.tree_paths``), never the leaves' order — into
one ``np.savez_compressed`` file ``{prefix}_{step:010d}.npz`` beside a
``.json`` manifest holding the step, the sorted keys and each leaf's
logical dtype. A file written by either package reads in the other
wherever the leaf layout agrees: it does for every MLP tree; conv weights
differ (OIHW here, HWIO in the reference).

Round-trip contract: ``restore_checkpoint(d, s, target)`` returns a tree
with ``target``'s structure and, leaf by leaf, the target leaf's type,
dtype and device. bf16 leaves (saved as lossless f32: numpy has no bf16)
come back bf16 bitwise; a tensor comes back on its target's device; numpy
leaves stay numpy (a host-plane resume must not move staging state onto
the card); a Python scalar comes back as its type. A ``torch.Generator``
leaf (the port's counterpart of a JAX key, which is an array there) is
saved as its ``get_state()`` bytes, a uint8 leaf, and restored with
``set_state`` into the target generator itself, on that generator's own
device. A shape mismatch raises.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_paths, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_SEP = "::"


def _path_key(path) -> str:
    return _SEP.join(str(k) for k in path)


def _dtype_name(dtype) -> str:
    """The reference's manifest names: ``float32``, ``bfloat16``, ``int64``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()  # numpy has no bf16; f32 is lossless
        return t.cpu().numpy()
    return np.asarray(leaf)


def _logical_dtype(leaf) -> str:
    if isinstance(leaf, torch.Generator):
        return "uint8"
    dt = getattr(leaf, "dtype", None)
    if dt is not None:
        return _dtype_name(dt)
    return np.asarray(leaf).dtype.str  # a Python scalar, as the reference


def save_checkpoint(directory: str, step: int, tree, *,
                    prefix: str = "ckpt") -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{prefix}_{step:010d}.npz")
    flat: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for p, leaf in tree_paths(tree):
        key = _path_key(p)
        flat[key] = _to_numpy(leaf)
        # logical dtypes (before the bf16 widening): the manifest makes the
        # checkpoint self-describing without the target tree in hand
        dtypes[key] = _logical_dtype(leaf)
    np.savez_compressed(path, **flat)
    with open(os.path.join(directory, f"{prefix}_{step:010d}.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(flat), "dtypes": dtypes}, f)
    return path


def latest_step(directory: str, prefix: str = "ckpt") -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        # fullmatch: a "ckpt" prefix must not claim "ckpt_extra_..." files
        m = re.fullmatch(rf"{re.escape(prefix)}_(\d+)\.npz", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _restore_leaf(key: str, arr: np.ndarray, leaf) -> Any:
    if isinstance(leaf, torch.Generator):
        shape = tuple(leaf.get_state().shape)
    else:
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
    assert arr.shape == shape, f"{key}: {arr.shape} vs {shape}"
    if isinstance(leaf, torch.Generator):
        # set_state takes a CPU byte tensor for a generator of any device
        leaf.set_state(torch.from_numpy(np.array(arr, np.uint8)))
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(np.array(arr, copy=True))
        # bf16 targets: the saved f32 casts back bitwise (the widening was
        # lossless)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return arr.astype(leaf.dtype, copy=False)
    return type(leaf)(arr.item())  # a Python scalar target: its type


def restore_checkpoint(directory: str, step: int, target_tree, *,
                       prefix: str = "ckpt"):
    """Restore into the structure of ``target_tree`` (shapes must match).

    Each restored leaf takes the *target* leaf's type, dtype and device:
    bf16 targets get the saved f32 cast back bitwise, tensors land on
    their target's device, numpy targets stay numpy, and a generator
    target gets its state back in place.
    """
    path = os.path.join(directory, f"{prefix}_{step:010d}.npz")
    with np.load(path) as data:
        leaves = [_restore_leaf(_path_key(p), data[_path_key(p)], leaf)
                  for p, leaf in tree_paths(target_tree)]
    return tree_unflatten(target_tree, leaves)
