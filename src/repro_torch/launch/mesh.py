"""Meshes of the port (a port of ``repro.launch.mesh``).

**The production and host meshes** are the dry-run's
(``repro_torch.launch.dryrun``): ``make_production_mesh()`` is 16 × 16
``("data", "model")``, and with ``multi_pod=True`` 2 × 16 × 16 ``("pod",
"data", "model")``, the reference's shapes and axis names.
``make_host_mesh()`` is 1 × 1, under which ``constrain`` changes
nothing. A ``ProductionMesh`` exposes ``.shape`` and ``.axis_names``,
which is all the sharding rules read; ``.build()`` gives the same mesh
with a torch ``DeviceMesh`` over the active process group (the dry-run's
``"fake"`` group of ``.size`` ranks), which ``constrain`` then reads.

The roofline constants are the H100 SXM's published peaks: 989e12 dense
bf16 FLOP/s, 3.35e12 B/s of HBM and 450e9 B/s of NVLink each way. An
NVLink domain holds 8 cards, so a 16-wide ``"model"`` axis spans two
domains joined by a slower network: there the collective term is a lower
bound.

**The rollout mesh** is the pipeline's (``make_rollout_mesh``).

The RL pipeline's mesh plane is pure data parallelism: the env axis of
every rollout is split over the mesh's one axis, ``"data"``, one actor
lane a device, and the learner sums the lanes' gradients. A
``RolloutMesh`` is the list of those devices. ``make_rollout_mesh(n)``
takes the first ``n`` CUDA devices (``n_devices=0``: every visible one),
or, with ``device="cpu"``, ``n`` lanes that share the CPU — the
counterpart of the reference's
``--xla_force_host_platform_device_count``, and what the tests use.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["HBM_BW", "NVLINK_BW", "PEAK_FLOPS_BF16", "ProductionMesh",
           "RolloutMesh", "make_host_mesh", "make_production_mesh",
           "make_rollout_mesh"]

# Hardware constants for the roofline (H100 SXM, one card)
PEAK_FLOPS_BF16 = 989e12  # dense, FLOP/s
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way; a lower bound's rate past 8 cards


@dataclass(frozen=True)
class ProductionMesh:
    """A named mesh of ``dims`` placeholder devices, and the torch
    ``DeviceMesh`` over them once ``build()`` has made one."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device_mesh: Optional[object] = dataclasses.field(default=None,
                                                      compare=False)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` reads."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def build(self, device_type: str = "cpu") -> "ProductionMesh":
        """This mesh with a ``DeviceMesh`` of ``device_type`` over ranks
        ``0 .. size - 1`` of the active process group (which may hold
        more)."""
        from torch.distributed.device_mesh import DeviceMesh

        ranks = torch.arange(self.size).reshape(self.dims)
        dm = DeviceMesh(device_type, ranks, mesh_dim_names=self.axis_names)
        return dataclasses.replace(self, device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    if multi_pod:
        return ProductionMesh((2, 16, 16), ("pod", "data", "model"))
    return ProductionMesh((16, 16), ("data", "model"))


def make_host_mesh() -> ProductionMesh:
    """1 × 1 mesh for the CPU's paths (constraints change nothing)."""
    return ProductionMesh((1, 1), ("data", "model"))


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
