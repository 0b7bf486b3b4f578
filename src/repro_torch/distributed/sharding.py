"""The rollout mesh's placement rules (a port of the rollout half of
``repro.distributed.sharding``).

RL trajectories have two layouts: time-major ``(T, E, ...)`` (the
``Transition`` leaves) and batch-leading ``(E, ...)`` (observations, the
bootstrap obs). The mesh plane splits exactly one axis, the env axis E,
over the mesh's ``"data"`` axis, and replicates the policy params. The
reference states that as ``NamedSharding``s for XLA; the port's plane
keeps one tensor per lane, so a rule here is an ``EnvSplit``: the axis it
splits (``None`` to replicate), its ``spec`` in the reference's
``PartitionSpec`` terms, and ``split``, which gives each lane its part of
a tree of tensors on its device. Lane ``i`` owns global envs
``[i·E, (i+1)·E)`` of a global width ``D·E``. The plane places the
learner's replicas with ``replicated_sharding``; its rollouts are born on
their lanes' devices, so it never splits or assembles one.

The reference's parameter rules for the production TPU mesh
(``param_specs``, ``cache_specs``, ``input_sharding``, ``to_named``) are
not ported (ROADMAP.md, item 14).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_unflatten

__all__ = ["EnvSplit", "batch_sharding", "replicated_sharding",
           "traj_sharding"]


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
