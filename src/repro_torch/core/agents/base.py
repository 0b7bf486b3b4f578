"""Agent API — the framework is algorithm agnostic (paper §3, §6).

An agent supplies ``act_fn()`` — ``(params, obs) -> (logits, value)``, the
master's batched evaluation — and ``make_train_step(env, optimizer,
lr_schedule)``, one synchronous Algorithm-1 iteration. The PAAC
orchestrator (``repro_torch.core.framework``) composes either with the
master/worker rollout.
"""
from __future__ import annotations

import abc


class Agent(abc.ABC):
    on_policy: bool = True

    @abc.abstractmethod
    def act_fn(self):
        """Returns (params, obs) -> (logits, value) used by the master."""

    @abc.abstractmethod
    def make_train_step(self, env, optimizer, lr_schedule):
        """Returns a train_step closure."""
