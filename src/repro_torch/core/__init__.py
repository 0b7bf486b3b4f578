"""The paper's primary contribution: the synchronous parallel-actor
framework (master batched action selection + parallel workers + one
synchronous update), algorithm-agnostic per §3. The asynchronous
pipeline is ``repro_torch.pipeline``."""
from repro_torch.core.evaluation import evaluate
from repro_torch.core.framework import ParallelRL, RunResult
from repro_torch.core.returns import (gae_advantages, n_step_returns,
                                      vtrace_returns)
from repro_torch.core.rollout import Transition, rollout

__all__ = [
    "ParallelRL",
    "RunResult",
    "evaluate",
    "n_step_returns",
    "gae_advantages",
    "vtrace_returns",
    "rollout",
    "Transition",
]
