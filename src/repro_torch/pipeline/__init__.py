"""Asynchronous actor/learner pipeline of the port (``repro.pipeline``):
the device and host rollout planes with thread actors.

``PipelinedRL`` splits Algorithm 1 into ``num_actors`` actor threads and
one learner joined by a bounded stream: the ``DeviceTrajectoryRing`` for
batched tensor envs, or the host ``TrajectoryQueue`` for ``HostEnvPool``s,
whose rollouts ride page-locked ``HostStagingRing`` sets (and, forced, for
tensor envs: the GA3C-style baseline). Params flow back through a
``PingPongParamSlot``; staleness is corrected by full V-trace (K2) in
``make_learner_step``, and ρ̄ = c̄ = ∞ reduces it to the synchronous update
(K1). ``TrajectoryQueue`` is also the serving plane's admission queue. The
mesh, replay and process planes, the supervisor, faults and checkpoints
wait for ROADMAP.md Queue 1 items 10 and 14.
"""
from repro_torch.configs.base import PipelineConfig
from repro_torch.pipeline.actor import (
    ActorBase,
    ActorThread,
    HostStagingRing,
    ParamSlot,
    PingPongParamSlot,
    Rollout,
    StagingSet,
    collect_host,
    make_host_act_step,
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
    "HostStagingRing",
    "ParamSlot",
    "PingPongParamSlot",
    "PipelineConfig",
    "PipelinedRL",
    "QueueClosed",
    "Rollout",
    "StagingSet",
    "TrajectoryQueue",
    "collect_host",
    "make_host_act_step",
    "make_learner_step",
]
