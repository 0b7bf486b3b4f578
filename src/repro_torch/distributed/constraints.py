"""Activation constraints that change no value (a port of
``repro.distributed.constraints``).

Model code of the reference calls ``constrain(x, "data", "model", ...)``
with logical axis names; under ``axis_context(mesh)`` that becomes a
sharding annotation for XLA's partitioner, and off the mesh it is a
no-op. The port's mesh plane keeps one tensor per lane and has nothing to
annotate, so ``constrain`` returns its input on the mesh too. The context
still records the active mesh, per thread, so that ``mesh_axis_size``
reads it as the reference's does.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["axis_context", "constrain", "mesh_axis_size"]

_state = threading.local()


@contextlib.contextmanager
def axis_context(mesh):
    """Make ``mesh`` (a ``launch.mesh.RolloutMesh``) this thread's active
    mesh for the duration of the context."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def mesh_axis_size(axis: str) -> int:
    """Size of a mesh axis in the active context (1 off the mesh and for an
    axis the mesh lacks)."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        return 1
    return dict(mesh.shape).get(axis, 1)


def constrain(x, *axes):
    """``x`` itself: per-lane tensors carry their placement already."""
    del axes
    return x
