"""Mesh helpers of the port (``repro.distributed``): the activation
constraints, which are no-ops in the port, and the rollout mesh's
placement rules: split along the env axis, or replicated."""
from repro_torch.distributed.constraints import (axis_context, constrain,
                                                 mesh_axis_size)
from repro_torch.distributed.sharding import (EnvSplit, batch_sharding,
                                              replicated_sharding,
                                              traj_sharding)

__all__ = ["EnvSplit", "axis_context", "batch_sharding", "constrain",
           "mesh_axis_size", "replicated_sharding", "traj_sharding"]
