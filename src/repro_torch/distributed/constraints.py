"""Activation sharding constraints that are no-ops off the mesh (a port of
``repro.distributed.constraints``).

Model code calls ``constrain(x, "data", "model", None, ...)`` with
logical axis names. Under ``axis_context(mesh)``, where ``mesh`` carries
a torch ``DeviceMesh`` (a built ``launch.mesh.ProductionMesh``: the
dry-run's), a DTensor ``x`` is redistributed to those placements, as the
reference's ``jax.lax.with_sharding_constraint`` places it. A plain
tensor, a mesh without a ``DeviceMesh`` (the pipeline's ``RolloutMesh``,
whose lanes hold their own tensors) or no mesh at all gives ``x`` back:
the card's paths pay one thread-local read. ``"data"`` means ``("pod",
"data")`` on a mesh with a pod axis. ``place_cache`` does the same for a
cache the model makes itself (a prefill's), by ``cache_specs``.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["axis_context", "constrain", "mesh_axis_size", "place_cache"]

_state = threading.local()


@contextlib.contextmanager
def axis_context(mesh):
    """Make ``mesh`` (a ``launch.mesh.RolloutMesh`` or ``ProductionMesh``)
    this thread's active mesh for the duration of the context."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def mesh_axis_size(axis: str) -> int:
    """Size of a mesh axis in the active context (1 off the mesh and for an
    axis the mesh lacks); ``"data"`` counts a pod axis too."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        return 1
    sizes = dict(mesh.shape)
    if axis == "data":
        return sizes.get("data", 1) * sizes.get("pod", 1)
    return sizes.get(axis, 1)


def _resolve(mesh, axis):
    """A logical axis as the mesh axes present on ``mesh``."""
    if axis is None:
        return None
    if axis == "data" and "pod" in mesh.axis_names:
        return ("pod", "data")
    return axis if axis in mesh.axis_names else None


def _built_mesh():
    """The active mesh if it carries a ``DeviceMesh``, else None."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None or getattr(mesh, "device_mesh", None) is None:
        return None
    return mesh


def constrain(x, *axes):
    """``x`` redistributed to the spec ``axes`` if it is a DTensor on an
    active built mesh, else ``x`` itself."""
    mesh = _built_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.distributed.sharding import to_placements

    spec = tuple(_resolve(mesh, a) for a in axes)
    dm = mesh.device_mesh
    return x.redistribute(dm, to_placements(spec, dm))


def place_cache(build, device):
    """The cache a model makes itself (zeros), ``build(device)``: off an
    active built mesh that tree; on one, DTensors placed by
    ``cache_specs``, each device's part zeros of its own, the global tree
    built on the meta device for its shapes alone (no data)."""
    mesh = _built_mesh()
    if mesh is None:
        return build(device)
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import (cache_specs, shard_shape,
                                                  spec_leaves, to_placements)
    from repro_torch.utils.tree import tree_map

    shapes = build(torch.device("meta"))
    it = iter(spec_leaves(cache_specs(shapes, mesh)))

    def place(t):
        spec = next(it)
        local = torch.zeros(shard_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device=device)
        return DTensor.from_local(local, mesh.device_mesh,
                                  to_placements(spec, mesh.device_mesh),
                                  shape=t.shape, stride=t.stride())

    return tree_map(place, shapes)
