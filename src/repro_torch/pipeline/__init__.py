"""Asynchronous actor/learner pipeline of the port (``repro.pipeline``):
the device rollout plane with thread actors.

``PipelinedRL`` splits Algorithm 1 into ``num_actors`` actor threads and
one learner joined by a bounded ``DeviceTrajectoryRing``; params flow back
through a ``PingPongParamSlot``; staleness is corrected by full V-trace
(K2) in ``make_learner_step``, and ρ̄ = c̄ = ∞ reduces it to the
synchronous update (K1). ``TrajectoryQueue`` is also the serving plane's
admission queue. The host, mesh, replay and process planes, the
supervisor, faults and checkpoints wait for ROADMAP.md Queue 1 items 8,
9, 10 and 14.
"""
from repro_torch.configs.base import PipelineConfig
from repro_torch.pipeline.actor import (
    ActorBase,
    ActorThread,
    ParamSlot,
    PingPongParamSlot,
    Rollout,
)
from repro_torch.pipeline.learner import make_learner_step
from repro_torch.pipeline.orchestrator import PipelinedRL
from repro_torch.pipeline.queue import CLOSED, QueueClosed, TrajectoryQueue
from repro_torch.pipeline.ring import DeviceTrajectoryRing

__all__ = [
    "ActorBase",
    "ActorThread",
    "CLOSED",
    "DeviceTrajectoryRing",
    "ParamSlot",
    "PingPongParamSlot",
    "PipelineConfig",
    "PipelinedRL",
    "QueueClosed",
    "Rollout",
    "TrajectoryQueue",
    "make_learner_step",
]
