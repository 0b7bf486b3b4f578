"""Carry parameters from the JAX package into the port.

``params_from_numpy`` takes the reference's parameter tree as nested dicts
of numpy arrays (a test makes it with
``jax.tree_util.tree_map(np.asarray, params)``) and returns the same tree
of tensors. Both packages keep ``x @ w`` with ``w`` shaped (in, out) and
layers stacked on a leading axis, so arrays copy over unchanged, with no
transposes. This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable, owned by the tensor
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dicts (and lists/tuples) of numpy arrays -> the same structure
    of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return _tensor(np.asarray(tree), device)
