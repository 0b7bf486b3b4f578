"""Carry parameters between the JAX package and the port.

``params_from_numpy`` takes the reference's parameter tree as nested dicts
of numpy arrays (a test makes it with
``jax.tree_util.tree_map(np.asarray, params)``) and returns the same tree
of tensors; ``params_to_numpy`` goes back, to the reference's layout, so
that new parameters and gradients can be compared leaf by leaf. Both
packages keep ``x @ w`` with ``w`` shaped (in, out) and layers stacked on
a leading axis, so those arrays copy over unchanged. The one exception is
the CNN trunk's conv weights (``trunk.convs[i].w``): the reference keeps
them HWIO, PyTorch's ``conv2d`` takes OIHW, and they are permuted on the
way. Everything else crosses as it is, dtype included: MLA's (in, out)
linears, Mamba2's depthwise ``conv_x``/``conv_B``/``conv_C`` (K, C), which
are not under ``convs``, and the fp32 leaves (``dt_bias``, ``A_log``,
``D``) of a bf16 model. Like every entry point of the port, the bridge
puts the tensors on the card unless its caller asks for the CPU. This
module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable, owned by the tensor
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _is_conv_weight(path) -> bool:
    return len(path) >= 3 and path[-3] == "convs" and path[-1] == "w"


def params_from_numpy(tree, device="cuda", _path=()):
    """Nested dicts (and lists/tuples) of numpy arrays -> the same structure
    of tensors on ``device``; conv weights HWIO -> OIHW. ``device`` goes
    through ``resolve_device``: without a CUDA device the default raises."""
    if not _path:
        device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, _path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, _path + (i,))
                          for i, v in enumerate(tree))
    a = np.asarray(tree)
    if _is_conv_weight(_path):
        a = a.transpose(_HWIO_TO_OIHW)
    return _tensor(a, device)


def params_to_numpy(tree, _path=()):
    """The inverse: a tree of tensors -> numpy arrays in the reference's
    layout (conv weights OIHW -> HWIO). bfloat16 leaves come back as
    float32."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v, _path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v, _path + (i,))
                          for i, v in enumerate(tree))
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    a = t.numpy()
    if _is_conv_weight(_path):
        a = a.transpose(_OIHW_TO_HWIO)
    return np.ascontiguousarray(a)
