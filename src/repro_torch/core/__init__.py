"""The paper's primary contribution: the synchronous parallel-actor
framework (master batched action selection + parallel workers + one
synchronous update), algorithm-agnostic per §3. The asynchronous
pipeline is ``repro_torch.pipeline``; ``evaluate`` waits for a later
slice (ROADMAP Queue 1 item 7)."""
from repro_torch.core.framework import ParallelRL, RunResult
from repro_torch.core.returns import n_step_returns, vtrace_returns
from repro_torch.core.rollout import Transition, rollout

__all__ = [
    "ParallelRL",
    "RunResult",
    "n_step_returns",
    "vtrace_returns",
    "rollout",
    "Transition",
]
