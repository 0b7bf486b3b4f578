"""Return estimation — paper Algorithm 1 lines 11–15, and V-trace.

``n_step_returns`` is the exact recursion the paper batches over actors:

    R_{t_max+1} = V(s_{t_max+1})        (0 through terminals)
    R_t = r_t + γ · (1 - done_t) · R_{t+1}

vectorized over all ``n_e`` actors: the time dimension is sequential, the
actor dimension is data-parallel. The port takes the trajectory
time-major, (T, E), as the rollout stores it (the reference takes (E, T)),
and computes it through ``kernels.ops.nstep_returns``: K1, the hand-written
kernel, on the card; the plain version on the CPU.

``vtrace_returns`` is the full IMPALA V-trace estimator (Espeholt et al.
2018) the pipelined learner uses for queue-stale data: the n-step targets
with truncated-importance corrections folded into the recursion. It runs
through ``kernels.ops.vtrace_returns``: K2 on the card, the plain version
on the CPU; time-major as well.

``gae_advantages`` is generalized advantage estimation (Schulman et al.
2016), which PPO uses. The reference computes it with a ``lax.scan`` and
no Pallas kernel, so the port computes it in plain PyTorch, a reverse loop
over T of batched operations over all actors.
"""
from __future__ import annotations

from typing import Tuple

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


def vtrace_returns(rewards: torch.Tensor,  # (T, E)
                   dones: torch.Tensor,  # (T, E) bool
                   values: torch.Tensor,  # (T, E) — V(s_t), learner params
                   bootstrap: torch.Tensor,  # (E,) — V(s_{T+1}), learner params
                   rho: torch.Tensor,  # (T, E) — pi_learner / pi_behaviour
                   gamma: float,
                   rho_bar: float = 1.0,
                   c_bar: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full V-trace targets (Espeholt et al. 2018, eqs. 1–4), time-major.

    With ρ_t = min(ρ̄, rho_t), c_t = min(c̄, rho_t) and γ_t = γ·(1-done_t):

        δ_t  = ρ_t · (r_t + γ_t·V(s_{t+1}) - V(s_t))
        v_t  = V(s_t) + δ_t + γ_t·c_t·(v_{t+1} - V(s_{t+1}))
        adv_t = ρ_t · (r_t + γ_t·v_{t+1} - V(s_t))

    Returns ``(vs, pg_adv)``, each (T, E) float32. The inputs are constants
    of the loss: any that requires a gradient is refused (``ValueError``).
    """
    return ops.vtrace_returns(rewards.to(torch.float32).contiguous(),
                              dones.to(torch.bool).contiguous(),
                              values.to(torch.float32).contiguous(),
                              bootstrap.to(torch.float32).contiguous(),
                              rho.to(torch.float32).contiguous(), gamma,
                              rho_bar, c_bar)


def gae_advantages(rewards: torch.Tensor,  # (T, E)
                   dones: torch.Tensor,  # (T, E) bool
                   values: torch.Tensor,  # (T, E)
                   bootstrap: torch.Tensor,  # (E,) — V(s_{T+1})
                   gamma: float,
                   lam: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation, time-major. Returns ``(advantages,
    returns)``, each (T, E) float32, with returns = advantages + values:

        δ_t = r_t + γ·(1-done_t)·V(s_{t+1}) - V(s_t)
        A_t = δ_t + γ·λ·(1-done_t)·A_{t+1},   A_{T+1} = 0
    """
    rewards = rewards.to(torch.float32)
    values = values.to(torch.float32)
    not_done = 1.0 - dones.to(torch.float32)
    next_values = torch.cat([values[1:], bootstrap.to(torch.float32)[None]])
    deltas = rewards + gamma * not_done * next_values - values
    adv = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * not_done[t] * carry
        adv[t] = carry
    return adv, adv + values
