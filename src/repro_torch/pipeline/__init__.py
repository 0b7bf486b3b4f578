"""Asynchronous actor/learner pipeline of the port (``repro.pipeline``):
the device, host and replay rollout planes with thread or process actors.

``PipelinedRL`` splits Algorithm 1 into ``num_actors`` actor replicas and
one learner joined by a bounded stream: the ``DeviceTrajectoryRing`` for
batched tensor envs, or the host ``TrajectoryQueue`` for ``HostEnvPool``s,
whose rollouts ride page-locked ``HostStagingRing`` sets (and, forced, for
tensor envs: the GA3C-style baseline). Params flow back through a
``PingPongParamSlot``; staleness is corrected by full V-trace (K2) in
``make_learner_step``, and ρ̄ = c̄ = ∞ reduces it to the synchronous update
(K1). ``TrajectoryQueue`` is also the serving plane's admission queue.

``actor_backend="process"`` runs each replica in a spawned worker
subprocess (``ProcessActorPlane``, ``ProcessActorDrainer``) that rebuilds
its pool from a ``HostEnvSpec`` and collects into shared-memory staging
sets (``ShmStagingSet``), leasing params from a shared-memory ping-pong
slot (``ShmParamSlot``/``ShmParamView``). ``replay_plane=True`` swaps the
FIFO ring for the sampled ``ReplayRing``, which feeds the V-trace learner
or DQN's replay-fed step (``make_dqn_collect_fn``,
``make_dqn_learner_step``; ``SyncReplayDQN`` is its synchronous
reference). The mesh plane, the supervisor, faults and checkpoints wait
for ROADMAP.md Queue 1 items 10 and 14.
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
from repro_torch.pipeline.offpolicy import (
    SyncReplayDQN,
    make_dqn_collect_fn,
    make_dqn_learner_step,
)
from repro_torch.pipeline.orchestrator import PipelinedRL
from repro_torch.pipeline.queue import CLOSED, QueueClosed, TrajectoryQueue
from repro_torch.pipeline.replay_ring import ReplayRing
from repro_torch.pipeline.ring import DeviceTrajectoryRing
from repro_torch.pipeline.shm import ShmParamSlot, ShmParamView, ShmStagingSet
from repro_torch.pipeline.worker import ProcessActorDrainer, ProcessActorPlane

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
    "ProcessActorDrainer",
    "ProcessActorPlane",
    "QueueClosed",
    "ReplayRing",
    "Rollout",
    "ShmParamSlot",
    "ShmParamView",
    "ShmStagingSet",
    "StagingSet",
    "SyncReplayDQN",
    "TrajectoryQueue",
    "collect_host",
    "make_dqn_collect_fn",
    "make_dqn_learner_step",
    "make_host_act_step",
    "make_learner_step",
]
