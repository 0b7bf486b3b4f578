"""Return estimation — paper Algorithm 1 lines 11–15.

``n_step_returns`` is the exact recursion the paper batches over actors:

    R_{t_max+1} = V(s_{t_max+1})        (0 through terminals)
    R_t = r_t + γ · (1 - done_t) · R_{t+1}

vectorized over all ``n_e`` actors: the time dimension is sequential, the
actor dimension is data-parallel. The port takes the trajectory
time-major, (T, E), as the rollout stores it (the reference takes (E, T)),
and computes it through ``kernels.ops.nstep_returns``: K1, the hand-written
kernel, on the card; the plain version on the CPU.

V-trace and GAE come with the pipelined learner (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def n_step_returns(rewards: torch.Tensor,  # (T, E)
                   dones: torch.Tensor,  # (T, E) bool
                   bootstrap: torch.Tensor,  # (E,) — V(s_{T+1})
                   gamma: float) -> torch.Tensor:
    """Discounted n-step returns per actor, time-major. Returns (T, E)
    float32. Returns are targets: inputs that require a gradient are
    refused (``ValueError``), so detach the bootstrap value first."""
    return ops.nstep_returns(rewards.to(torch.float32).contiguous(),
                             dones.to(torch.bool).contiguous(),
                             bootstrap.to(torch.float32).contiguous(), gamma)
