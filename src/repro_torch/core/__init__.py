"""The paper's primary contribution: the synchronous parallel-actor
framework (master batched action selection + parallel workers + one
synchronous update), algorithm-agnostic per §3. ``evaluate`` and the
asynchronous pipeline wait for later slices (ROADMAP Queue 1 items 7
and 10)."""
from repro_torch.core.framework import ParallelRL, RunResult
from repro_torch.core.returns import n_step_returns
from repro_torch.core.rollout import Transition, rollout

__all__ = [
    "ParallelRL",
    "RunResult",
    "n_step_returns",
    "rollout",
    "Transition",
]
