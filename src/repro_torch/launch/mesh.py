"""The pipeline's rollout mesh (a port of ``repro.launch.mesh.
make_rollout_mesh``).

The RL pipeline's mesh plane is pure data parallelism: the env axis of
every rollout is split over the mesh's one axis, ``"data"``, one actor
lane a device, and the learner sums the lanes' gradients. A
``RolloutMesh`` is the list of those devices. ``make_rollout_mesh(n)``
takes the first ``n`` CUDA devices (``n_devices=0``: every visible one),
or, with ``device="cpu"``, ``n`` lanes that share the CPU — the
counterpart of the reference's
``--xla_force_host_platform_device_count``, and what the tests use.

The reference's production and host meshes (``make_production_mesh``,
``make_host_mesh``) and its roofline constants belong to the TPU dry-run
and are not ported (ROADMAP.md, item 14).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["RolloutMesh", "make_rollout_mesh"]


@dataclass(frozen=True)
class RolloutMesh:
    """A 1-axis ``("data",)`` mesh: lane ``i`` runs on ``devices[i]``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` reads."""
        return {"data": len(self.devices)}


def make_rollout_mesh(n_devices: int = 0, device="cuda") -> RolloutMesh:
    """The rollout mesh of ``n_devices`` lanes (0: every visible device).

    On ``device="cuda"`` lane ``i`` is ``cuda:i`` and asking for more
    devices than are visible raises; on ``device="cpu"`` the ``n_devices``
    lanes (at least 1) all run on the CPU.
    """
    dev = resolve_device(device)
    if n_devices < 0:
        raise ValueError(f"n_devices must be >= 0, got {n_devices}")
    if dev.type == "cpu":
        return RolloutMesh(tuple(dev for _ in range(max(n_devices, 1))))
    visible = torch.cuda.device_count()
    n = n_devices or visible
    if n > visible:
        raise ValueError(
            f"mesh_shape={n} but only {visible} device(s) visible — on the "
            f"CPU, pass device='cpu' for {n} lanes that share it")
    return RolloutMesh(tuple(torch.device("cuda", i) for i in range(n)))
