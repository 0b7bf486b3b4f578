"""Sharding rules of the port (a port of ``repro.distributed.sharding``).

**Parameter, cache and input rules** (the dry-run's). Three modes:

* ``"tp"``      — tensor parallel over ``"model"`` only; params
                  replicated over the data axis;
* ``"fsdp_tp"`` — 2D: tensor parallel over ``"model"`` plus parameter
                  sharding over the data axes (FSDP/ZeRO-3 style: each
                  layer's weights are all-gathered where they are used);
                  what the 100B+ models need;
* ``"zero1"``   — parameters as ``"tp"``, optimizer state as
                  ``"fsdp_tp"`` (the dry-run applies the two).

The rules are the reference's, by path, over the port's nested-dict
trees: a path is the keys from the root joined by ``/``, as
``utils/tree.py`` ``tree_paths`` gives them. A rule gives the spec of a
leaf's trailing dims; a stack's leading layer axes get ``None``. A dim
that does not divide its mesh axis is left unsharded (kv = 2 heads
against a 16-way model axis; batch 1 at ``long_500k``). A spec is a
tuple with one entry a dim — a mesh axis name, a tuple of names
(``("pod", "data")``) or ``None`` — the terms of the reference's
``PartitionSpec``, which keeps a 1-tuple of axes as the bare name.
``to_placements`` turns specs into DTensor placements on a
``DeviceMesh`` (the counterpart of the reference's ``to_named``, which
made ``NamedSharding``s). The rules read only a mesh's ``.shape`` and
``.axis_names``.

**Rollout rules** (the pipeline's mesh plane). RL trajectories have two
layouts: time-major ``(T, E, ...)`` (the ``Transition`` leaves) and
batch-leading ``(E, ...)`` (observations, the bootstrap obs). The mesh
plane splits exactly one axis, the env axis E, over the mesh's
``"data"`` axis, and replicates the policy params. The
reference states that as ``NamedSharding``s for XLA; the port's plane
keeps one tensor per lane, so a rule here is an ``EnvSplit``: the axis it
splits (``None`` to replicate), its ``spec`` in the reference's
``PartitionSpec`` terms, and ``split``, which gives each lane its part of
a tree of tensors on its device. Lane ``i`` owns global envs
``[i·E, (i+1)·E)`` of a global width ``D·E``. The plane places the
learner's replicas with ``replicated_sharding``; its rollouts are born on
their lanes' devices, so it never splits or assembles one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.utils.tree import (tree_leaves, tree_map, tree_paths,
                                    tree_unflatten)

__all__ = ["EnvSplit", "SHARDING_MODES", "batch_sharding", "cache_specs",
           "input_sharding", "param_specs", "replicated_sharding",
           "shard_shape", "spec_leaves", "to_placements",
           "traj_sharding"]

SHARDING_MODES = ("tp", "fsdp_tp", "zero1")

# parameter-name classes --------------------------------------------------
_UP_PROJ = {"wq", "wk", "wv", "wuq", "wukv", "wi", "wg", "w_z", "w_x", "w_dt"}
_DOWN_PROJ = {"wo", "out_proj"}
_SMALL_OUT = {"wdq", "wdkv", "w_B", "w_C"}  # fsdp-in, unsharded out
_HEAD_VECS = {"A_log", "D", "dt_bias"}  # per-SSM-head vectors -> "model"
_REPLICATED = {"scale", "bias", "b", "conv_B", "conv_C", "conv_b"}


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def _data_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _data_size(mesh) -> int:
    s = _axis_sizes(mesh)
    return s.get("data", 1) * s.get("pod", 1)


def _fits(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def _base_spec(path: str, name: str, shape, mesh, mode: str):
    """Spec for the trailing dims of one leaf (no stack axes)."""
    sizes = _axis_sizes(mesh)
    msize = sizes.get("model", 1)
    dsize = _data_size(mesh)
    data = _data_axes(mesh)
    fsdp = mode == "fsdp_tp"

    def m(dim):  # model axis if divisible
        return "model" if _fits(dim, msize) else None

    def d(dim):  # (pod,)data axes if divisible
        return data if fsdp and _fits(dim, dsize) else None

    if name in _REPLICATED:
        return (None,) * min(len(shape), 1)
    if name == "embed":
        return (m(shape[-2]) or None, d(shape[-1]))
    if name == "conv_x":
        return (None, m(shape[-1]))
    if name in _HEAD_VECS:
        return (m(shape[-1]),)
    if "moe/" in path or path.endswith("moe"):
        if name in ("wi", "wg"):  # (E, d, ff)
            return (m(shape[-3]), d(shape[-2]), None)
        if name == "wo":  # (E, ff, d)
            return (m(shape[-3]), None, d(shape[-1]))
        if name == "w" and "router" in path:
            return (None, None)
    if "heads" in path:
        if "policy" in path and name == "w":
            return (d(shape[-2]), m(shape[-1]))
        return (None,) * min(len(shape), 2)
    if "frontend_proj" in path:
        return (None, None)
    if name == "w":
        # a linear inside a named module: its parent's name says which
        parent = path.split("/")[-2] if "/" in path else ""
        if parent in _UP_PROJ:
            return (d(shape[-2]), m(shape[-1]))
        if parent in _DOWN_PROJ:
            return (m(shape[-2]), d(shape[-1]))
        if parent in _SMALL_OUT:
            return (d(shape[-2]), None)
        return (None, None)
    return (None,) * len(shape)


def _norm(spec) -> Tuple:
    """A spec as ``PartitionSpec`` keeps it: a 1-tuple of axes is the axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _by_path(fn, tree):
    """``fn(path_str, leaf)`` over ``tree``'s leaves, in ``tree``'s shape."""
    specs = iter([fn(_path_str(p), leaf) for p, leaf in tree_paths(tree)])
    return tree_map(lambda _: next(specs), tree)


def param_specs(params_tree, mesh, mode: str = "fsdp_tp"):
    """A spec tuple for every leaf of ``params_tree`` (tensors, meta or
    fake tensors: only ``.shape`` is read)."""
    assert mode in SHARDING_MODES

    def leaf_spec(path: str, leaf):
        shape = leaf.shape
        base = tuple(_base_spec(path, path.split("/")[-1], shape, mesh,
                                mode))[: len(shape)]
        return _norm((None,) * (len(shape) - len(base)) + base)

    return _by_path(leaf_spec, params_tree)


def cache_specs(cache_tree, mesh):
    """KV/state cache specs: the batch dim over the data axes, head-ish
    dims over ``"model"``.

    Cache leaves are (L, B, S, Hkv, D) / (L, B, S, rank) / (L, B, H, P, N)
    / (L, B, K-1, C), and a hybrid's groups (G, every, B, ...). Dim 1
    (batch) goes over the data axes when it divides, else dim 2; dim -2 of
    ``k``/``v``, dim -3 of ``state`` and dim -1 of ``conv_x`` over
    ``"model"`` when they divide."""
    sizes = _axis_sizes(mesh)
    msize = sizes.get("model", 1)
    dsize = _data_size(mesh)
    data = _data_axes(mesh)

    def leaf_spec(path: str, leaf):
        shape = leaf.shape
        name = path.split("/")[-1]
        spec: List = [None] * len(shape)
        if len(shape) > 1 and _fits(shape[1], dsize):
            spec[1] = data
        elif len(shape) > 2 and _fits(shape[2], dsize):
            spec[2] = data  # hybrid: (G, every, B, ...)
        if name in ("k", "v") and len(shape) >= 4 and _fits(shape[-2], msize):
            spec[-2] = "model"
        if name == "state" and _fits(shape[-3], msize):
            spec[-3] = "model"  # (.., H, P, N)
        if name == "conv_x" and _fits(shape[-1], msize):
            spec[-1] = "model"
        return _norm(spec)

    return _by_path(leaf_spec, cache_tree)


def input_sharding(batch_tree, mesh):
    """Batch inputs: dim 0 over the data axes when it divides, else
    replicated."""
    dsize = _data_size(mesh)
    data = _data_axes(mesh)

    def leaf_spec(leaf):
        spec: List = [None] * len(leaf.shape)
        if leaf.shape and _fits(leaf.shape[0], dsize):
            spec[0] = data
        return _norm(spec)

    return tree_map(leaf_spec, batch_tree)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(tree_of_specs, device_mesh):
    """Each spec as a tuple of DTensor placements, one a mesh dim: ``Shard(i)``
    where dim ``i``'s entry names that mesh dim, else ``Replicate()``. A
    dim over several mesh axes (``("pod", "data")``) is split over them in
    the mesh's order, major first, as a ``NamedSharding`` splits it."""
    from torch.distributed.tensor import Replicate, Shard

    names = device_mesh.mesh_dim_names

    def one(spec):
        where = {a: i for i, e in enumerate(spec) for a in _axes_of(e)}
        return tuple(Shard(where[n]) if n in where else Replicate()
                     for n in names)

    return _map_specs(one, tree_of_specs)


def _map_specs(fn, tree):
    """``fn`` over a tree of specs, whose leaves are the spec tuples."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    return fn(tree)


def spec_leaves(tree) -> List:
    """The spec tuples (or placement tuples) of ``tree`` in
    ``tree_leaves`` order, the order of the tree they were made for."""
    out: List = []
    _map_specs(out.append, tree)
    return out


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """One device's part of a leaf of ``shape`` under ``spec`` on ``mesh``:
    each dim divided by the sizes of the axes it is split over."""
    sizes = _axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(dim // math.prod(sizes[a] for a in _axes_of(e))
                 for dim, e in zip(shape, spec))


@dataclass(frozen=True)
class EnvSplit:
    """How one leaf lies on a ``RolloutMesh``: split along ``axis`` into
    one equal slice a lane, or replicated on every lane (``axis=None``)."""

    mesh: object  # launch.mesh.RolloutMesh
    axis: Optional[int]
    ndim: int = 0

    @property
    def spec(self) -> Tuple[Optional[str], ...]:
        """The reference's ``PartitionSpec`` entries for this leaf."""
        if self.axis is None:
            return ()
        spec: List[Optional[str]] = [None] * self.ndim
        spec[self.axis] = "data"
        return tuple(spec)

    def split(self, tree) -> List:
        """Lane ``i``'s part of every leaf of ``tree`` (a tensor, or dicts
        and lists of them) on lane ``i``'s device, one tree a lane: a
        slice of the env axis, or the whole leaf when replicated (a lane
        on the leaf's own device gets the leaf itself)."""
        devices = self.mesh.devices
        per_leaf = [self._split_leaf(x, devices) for x in tree_leaves(tree)]
        return [tree_unflatten(tree, [p[i] for p in per_leaf])
                for i in range(len(devices))]

    def _split_leaf(self, x: torch.Tensor, devices) -> List[torch.Tensor]:
        if self.axis is None:
            return [x.to(d) for d in devices]
        E = x.shape[self.axis]
        if E % len(devices):
            raise ValueError(f"cannot split {E} envs over {len(devices)} "
                             "lanes")
        parts = x.chunk(len(devices), dim=self.axis)
        return [p.to(d) for p, d in zip(parts, devices)]


def replicated_sharding(mesh) -> EnvSplit:
    """Fully replicated placement (params, optimizer state, scalars)."""
    return EnvSplit(mesh, None)


def traj_sharding(mesh, ndim: int) -> EnvSplit:
    """A time-major ``(T, E, ...)`` leaf: the env axis (dim 1) split."""
    if ndim < 2:
        raise ValueError(
            f"time-major trajectory leaves are >= 2D, got {ndim}")
    return EnvSplit(mesh, 1, ndim)


def batch_sharding(mesh, ndim: int) -> EnvSplit:
    """A batch-leading ``(E, ...)`` leaf: the env axis (dim 0) split."""
    if ndim < 1:
        raise ValueError("batch-leading leaves are >= 1D")
    return EnvSplit(mesh, 0, ndim)
