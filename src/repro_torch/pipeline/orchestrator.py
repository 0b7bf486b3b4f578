"""``PipelinedRL`` — the asynchronous multi-actor/learner backend (a port of
``repro.pipeline.orchestrator``: the device and host planes with thread
actors).

Drop-in alternative to ``repro_torch.core.ParallelRL`` (same constructor
shape, same ``run(iterations) -> RunResult``) that splits Algorithm 1
across ``num_actors`` actor threads and one learner (the thread that calls
``run``) joined by a bounded trajectory stream:

    actor thread i: lease latest params → collect rollout → put
    learner thread: get → update (V-trace through K2, or n-step through K1
                    at ρ̄ = c̄ = ∞) → copy into the stale ping-pong buffer
                    → commit

The stream runs on one of two *queue planes* (``PipelineConfig.
rollout_plane``): the ``DeviceTrajectoryRing`` for batched tensor envs —
trajectories never leave the card — or the host ``TrajectoryQueue`` for
``HostEnvPool``, whose rollouts are born in host memory and ride reusable
page-locked ``HostStagingRing`` sets. ``auto`` picks the host plane for a
host pool and the device plane otherwise; ``host`` on a ``VectorEnv`` is
the GA3C-style baseline, which stages the device trajectory into host
sets. A ``HostEnvSpec`` is sugar for a pool built here, which ``close()``
closes.

Params flow the other way through a ``PingPongParamSlot``: the learner's
working params and optimizer state are private to it, and each update
writes a bitwise snapshot into one of two alternating actor-facing
buffers. Actors lease a snapshot for exactly one rollout; the learner
reuses a stale buffer only after its last reader released.

On the card each actor collects on its own CUDA stream and the learner
updates on another; the ordering between them is the events and
``record_stream`` described in ``pipeline.actor`` and ``pipeline.ring``.
At the start of a run both wait on the caller's stream (which made the
params and env states), and at its end the caller's stream waits on them,
so the state a run leaves is safe to read on the caller's stream. On the
host plane the learner copies each payload to the card on its own stream,
and reads the update's metrics back at once (an eager
``MetricsAccumulator``): that read waits for the update and the copy
before it, and only then does ``payload.release()`` hand the staging set
back to its actor. The device plane never reads back in the loop.

Each actor replica owns a private slice of the environments: a single env
is split along the env axis (``HostEnvPool.shard`` for host pools,
``narrow_vector_env`` for tensor envs), or a list of envs gives each
replica its own. With one actor, that actor owns ``ParallelRL``'s act and
env generators (the same seeded layout), so in ``lockstep`` mode with
infinite clips the pipeline reproduces the synchronous run bit for bit, on
either plane. With more, each replica gets its own pair from
``seeded_generators``.

Two observers ride a run when asked (``repro_torch.telemetry.hub``): the
JSONL heartbeat (``metrics_jsonl``) and the stall watchdog
(``stall_timeout_s``), which names the stage every party is blocked in.

Orthogonal to the queue plane is the *actor backend* (``PipelineConfig.
actor_backend``): ``"thread"`` replicas are ``ActorThread``s in this
process, while ``"process"`` moves each replica into a spawned worker
subprocess (``repro_torch.pipeline.worker``) — the backend that scales
GIL-holding Python emulators. Process workers rebuild their env pools
from picklable ``HostEnvSpec`` recipes (a spec is sharded across the
workers, or a list gives each its own), collect into shared-memory
staging sets and are drained by parent-side ``ProcessActorDrainer``
threads into the same host ``TrajectoryQueue``; params go to them through
a shared-memory ping-pong slot (``repro_torch.pipeline.shm``) speaking
the same reserve/commit protocol, one copy to host memory an update.
Worker ``i`` starts from the acting generator the thread host plane's
actor ``i`` gets, so a lock-stepped single worker reproduces the thread
host plane bit for bit; a single worker's generator state comes back
after each run. ``close()`` stops the workers and unlinks their segments.

The *replay plane* (``PipelineConfig.replay_plane``) swaps the FIFO ring
for a sampled ``ReplayRing`` on the device plane: actors never block (a
full ring evicts its oldest rollout), each update *samples*
``replay_batch`` retained rollouts, and the learner step is either DQN's
replay-fed TD update (``repro_torch.pipeline.offpolicy``, no kernel) or
the same V-trace PAAC step (K2) correcting the sampled rollouts'
staleness. With ``prioritized`` the update's |TD| goes back as the
sampled slots' priority, once an update.

Fault tolerance rides every plane but the mesh's (``repro_torch.pipeline.
supervisor``, ``faults``, ``repro_torch.checkpoint``). A ``fault_plan``
injects planned faults (actor kills, lease delays, a dropped release, a
stalled learner), each once a run. Without ``elastic`` a killed replica
fails the run as a real crash would; with it an ``ActorSupervisor``
respawns the replica (a thread from its last rollout boundary, a process
worker reused or spawned afresh) under ``restart_budget`` and past it
degrades to the survivors, who absorb the dead replica's quota through the
``QuotaLedger``. ``checkpoint_dir``/``checkpoint_every`` save the full
state every so many updates (prefix ``"pipe"``), and ``restore`` loads the
newest: on the thread backend's device and host planes (not the replay
plane) each slot's generators, env state and obs come back at the boundary
of its newest consumed rollout, so a lock-stepped resumed run continues the
interrupted one bit for bit; elsewhere it is a warm restart (params,
optimizer state and counters exact, actors carry on from their own state).

The runtime sanitizers ride every run when armed (``repro_torch.
analysis``, ``REPRO_SANITIZE`` or the trainer's ``--sanitize``): the lock
sites report to the lock-order monitor, whose verdict the run attaches to
its hub as the report ``"lockcheck"``; and from iteration 1 the learner's
get → reserve → update → commit block runs inside ``sanitize.guard`` on
every plane, as do the device-plane collects from their second call (a
host sync there raises on the guarded thread), while probes check after
each update that the publish went into the reserved buffer in place. The
reference exempts the host plane's learner, whose staged payload is a
transfer; in torch a copy from page-locked memory is asynchronous, no
sync, so the port guards it too.

The *mesh plane* (``rollout_plane="mesh"``, or ``"auto"`` with
``mesh_shape`` > 1) runs one actor lane a device of a ``RolloutMesh``
(``repro_torch.launch.mesh``; on the CPU, ``mesh_shape`` lanes that share
it): ``num_actors`` is 1 or ``mesh_shape`` and becomes ``mesh_shape``, the
env axis is split into equal lane slices (or a list gives each lane its
own env), each lane steps its own copy of its env on its device
(``narrow_vector_env(..., device=)``), and each lane's carried env state,
generators and actor stream live there. The lanes feed a
``MeshTrajectoryRing``; every update takes one rollout of each lane (a
lane's quota is ``iterations``, and an update learns ``mesh_shape`` lane
rollouts) and runs ``make_sharded_learner_step``: each lane's V-trace (K2)
and backward on its device, the gradients summed on lane 0, one clipped
RMSProp update there, the params copied to every lane's replica. The
learner keeps ``params`` (lane 0's, the replica the caller reads) and the
optimizer state on lane 0; the ping-pong slot holds one tree a lane, and
lane ``i`` collects with its own. It is one process and one learner
thread, as the reference's single controller is. At ``mesh_shape`` 1 the
plane is the device plane bit for bit (the lockstep tests pin it).
Checkpoints on it are warm restarts, and ``elastic`` is refused (a dead
lane leaves no set complete), as in the reference.

It drives plain ``PAACAgent`` on every plane and ``DQNAgent`` on the
replay plane, as the reference does; the reference's other agents are
refused as it refuses them.
"""
from __future__ import annotations

import contextlib
import queue as _stdlib_queue
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.analysis.lockcheck import locks_enabled, monitor
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.base import PipelineConfig
from repro_torch.core.agents.dqn import DQNAgent
from repro_torch.core.agents.paac import PAACAgent
from repro_torch.core.framework import (MetricsAccumulator, RunResult,
                                        init_rl_common)
from repro_torch.core.rollout import make_collect_fn
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import replicated_sharding
from repro_torch.envs.base import VectorEnv, narrow_vector_env
from repro_torch.envs.host_env import HostEnvPool, HostEnvSpec
from repro_torch.launch.mesh import make_rollout_mesh
from repro_torch.pipeline.actor import (ActorThread, HostStagingRing,
                                        PingPongParamSlot, Rollout,
                                        _copy_tree, collect_host,
                                        make_host_act_step, record_event,
                                        to_device)
from repro_torch.pipeline.faults import FaultInjector, FaultPlan
from repro_torch.pipeline.learner import (make_learner_step,
                                          make_sharded_learner_step)
from repro_torch.pipeline.offpolicy import (make_dqn_collect_fn,
                                            make_dqn_learner_step)
from repro_torch.pipeline.queue import CLOSED, TrajectoryQueue
from repro_torch.pipeline.replay_ring import ReplayRing
from repro_torch.pipeline.ring import (DeviceTrajectoryRing,
                                       MeshTrajectoryRing, adopt)
from repro_torch.pipeline.supervisor import ActorSupervisor, QuotaLedger
from repro_torch.pipeline.worker import ProcessActorPlane
from repro_torch.telemetry import (LEARNER_UPDATE, LEASE, PUBLISH,
                                   QUEUE_GET_WAIT, Telemetry)
from repro_torch.utils import get_logger
from repro_torch.utils.sampling import (generator_state, seeded_generators,
                                       set_generator_state)

log = get_logger("pipeline")


def _is_host(env) -> bool:
    """A host env pool (or shard) or the recipe of one."""
    return isinstance(env, HostEnvSpec) or hasattr(env, "step_host")


def _on_streams(streams):
    """Each stream made its device's current stream for this thread (one
    a lane device; lane 0's entered last, so its device is current), or
    nothing on the CPU."""
    stack = contextlib.ExitStack()
    for s in reversed(streams):
        if s is not None:
            stack.enter_context(torch.cuda.stream(s))
    return stack


def _lane_generators(seed: int, devices) -> List[tuple]:
    """Replica ``i``'s (act, env) generator pair, on ``devices[i]`` (a
    mesh lane's device): the seeds follow ``ParallelRL``'s three."""
    n = len(devices)
    return [tuple(seeded_generators(seed, 3 + 2 * n, d)[3 + 2 * i:5 + 2 * i])
            for i, d in enumerate(devices)]


class PipelinedRL:
    """Asynchronous multi-actor/learner pipeline over the PAAC framework."""

    def __init__(self, env, agent, *, optimizer: str = "rmsprop",
                 lr_schedule: Optional[Callable] = None, seed: int = 0,
                 pipeline: PipelineConfig = PipelineConfig(),
                 device="cuda"):
        dev = resolve_device(device)
        # exact types, as in the reference: subclasses (LaggedPAACAgent) and
        # look-alikes (PPOAgent) carry their own loss/state that the learner
        # step would silently drop; DQNAgent rides only the replay plane
        self._replay = pipeline.replay_plane
        self._dqn = type(agent) is DQNAgent
        if self._dqn and not self._replay:
            raise ValueError(
                "DQNAgent needs the replay plane: pass PipelineConfig("
                "replay_plane=True) — the FIFO planes feed the on-policy "
                "V-trace learner")
        if not self._dqn and type(agent) is not PAACAgent:
            raise NotImplementedError(
                f"PipelinedRL drives plain PAACAgent (got "
                f"{type(agent).__name__}) on the FIFO planes, plus DQNAgent "
                "on the replay plane; other agents carry losses the learner "
                "steps would silently drop")
        if pipeline.actor_backend not in ("thread", "process"):
            raise ValueError("actor_backend must be 'thread' or 'process', "
                             f"got {pipeline.actor_backend!r}")
        self._backend = pipeline.actor_backend
        n_actors = pipeline.num_actors
        if n_actors < 1:
            raise ValueError(f"num_actors must be >= 1, got {n_actors}")
        # the mesh plane runs one actor lane a mesh device: num_actors is
        # normalized to mesh_shape (PipelineConfig rejects anything else)
        want_mesh = pipeline.rollout_plane == "mesh" or (
            pipeline.rollout_plane == "auto" and pipeline.mesh_shape > 1)
        if want_mesh:
            if n_actors not in (1, pipeline.mesh_shape):
                raise ValueError(
                    "the mesh plane runs exactly one actor lane per mesh "
                    f"device: num_actors must be 1 (auto) or mesh_shape="
                    f"{pipeline.mesh_shape}, got {n_actors}")
            n_actors = pipeline.mesh_shape
        if pipeline.lockstep and n_actors > 1 and not want_mesh:
            raise ValueError(
                "lockstep (synchronous semantics) requires num_actors == 1 "
                "(or the mesh plane, whose lanes are consumed in lockstep "
                "sets — one rollout a lane an update)")
        per_actor_envs = list(env) if isinstance(env, (list, tuple)) else None
        if per_actor_envs is not None and len(per_actor_envs) != n_actors:
            raise ValueError(f"got {len(per_actor_envs)} per-actor envs "
                             f"for num_actors={n_actors}")
        first = per_actor_envs[0] if per_actor_envs is not None else env
        if self._backend == "process" and not all(
                isinstance(e, HostEnvSpec) for e in per_actor_envs or [env]):
            # the process plane rebuilds env pools inside worker
            # subprocesses from picklable specs — live pools can't cross
            raise ValueError(
                "actor_backend='process' requires a HostEnvSpec (or a "
                "per-actor list of them): worker subprocesses rebuild "
                "their env pools from the picklable spec — a live "
                f"{type(first).__name__} cannot be shipped to a child")
        self._host = _is_host(first)
        self._plane = self._resolve_plane(pipeline)
        if self._replay and self._plane != "device":
            raise ValueError(
                "replay_plane requires a batched tensor env on the device "
                "plane: the ReplayRing retains sampled rollouts on the "
                "device, which host-born payloads (HostEnvPool / process "
                "backend) cannot do")
        if pipeline.fault_plan is not None and not isinstance(
                pipeline.fault_plan, FaultPlan):
            raise TypeError(
                "PipelineConfig.fault_plan must be a repro_torch.pipeline."
                f"faults.FaultPlan, got {type(pipeline.fault_plan).__name__}")
        for e in per_actor_envs or [env]:
            if _is_host(e) != self._host:
                raise ValueError("per-actor envs must be all host or all "
                                 "tensor envs")
            if not (self._host or isinstance(e, VectorEnv)):
                raise NotImplementedError(
                    f"PipelinedRL drives batched tensor envs (VectorEnv) and "
                    f"host env pools (HostEnvPool, HostEnvSpec); "
                    f"{type(e).__name__} is neither")
            e_dev = (torch.device(e.device) if isinstance(e, HostEnvSpec)
                     else e.device)
            if e_dev.type != dev.type:
                raise ValueError(f"env lives on {e_dev}, PipelinedRL runs "
                                 f"on {dev}")
        # a HostEnvSpec on the thread backend is sugar for the pool(s) built
        # here, which close() closes; pools the caller hands in stay the
        # caller's to close. The process backend ships the specs instead.
        self._owned_pools: List[HostEnvPool] = []
        self._process_plane: Optional[ProcessActorPlane] = None
        if self._backend == "thread" and per_actor_envs is not None:
            per_actor_envs = [self._own(e) for e in per_actor_envs]
        elif self._backend == "thread":
            env = self._own(env)
        if per_actor_envs is not None:
            env = per_actor_envs[0]
        self.env = env
        self.agent = agent
        self.pipeline = pipeline
        self.device = dev
        self._n_actors = n_actors
        self._seed = seed  # the ReplayRing's sample stream
        # the mesh plane's lanes: lane i runs on self._mesh.devices[i]
        self._mesh = (make_rollout_mesh(pipeline.mesh_shape, device=dev.type)
                      if self._plane == "mesh" else None)
        lane_devs = (list(self._mesh.devices) if self._mesh is not None
                     else [dev] * n_actors)
        try:
            self._init_state(env, per_actor_envs, agent, optimizer,
                             lr_schedule, seed)
        except BaseException:
            self.close()  # the pools built from specs, the workers
            raise
        # the thread host plane's act step (process workers build their own)
        self._act = (make_host_act_step(agent.act_fn())
                     if self._host and self._process_plane is None else None)
        # per-replica lifetime rollout counters: the DQN collector's ε index
        # (persists across run() calls, like the synchronous schedule)
        self._actor_seq = [0] * n_actors
        # the learner step: dequeue-consume + update + publish into the
        # stale ping-pong buffer, on the learner's stream
        if self._dqn:
            # the target tree and the update counter are learner-private
            # state riding the update's signature next to params/opt state;
            # the target is a copy, as the synchronous reference keeps one
            self._target = _copy_tree(self.params)
            self._updates = 0
            self._update_step = make_dqn_learner_step(
                agent, self.optimizer, self.lr_schedule, fused_publish=True)
        elif self._mesh is not None:
            # the sharded twin: the same math, each lane's shard on its
            # device, the partial gradients summed on lane 0
            self._update_step = make_sharded_learner_step(
                agent, self.optimizer, self.lr_schedule, self._mesh,
                rho_bar=pipeline.rho_bar, c_bar=pipeline.c_bar,
                fused_publish=True)
        else:
            self._update_step = make_learner_step(
                agent, self.optimizer, self.lr_schedule,
                rho_bar=pipeline.rho_bar, c_bar=pipeline.c_bar,
                fused_publish=True)
        if dev.type == "cuda":
            # one learner stream a lane device (lane 0's is the update's)
            self._lane_streams = [torch.cuda.Stream(d) for d in
                                  (lane_devs if self._mesh is not None
                                   else [dev])]
            # process actors act in their own processes, on their own streams
            self._actor_streams = (
                [torch.cuda.Stream(d) for d in lane_devs]
                if self._backend == "thread" else [])
        else:
            self._lane_streams = [None]
            self._actor_streams = [None] * n_actors
        self._learner_stream = self._lane_streams[0]
        self.total_steps = 0
        # one learned rollout = one actor shard's n_envs·t_max timesteps —
        # except on the mesh plane, where every update learns one rollout
        # of each of the n_actors lanes
        shard_envs = (self._proc_specs[0].n_envs if self._proc_specs
                      else self._actor_envs[0].n_envs)
        lanes_per_update = n_actors if self._mesh is not None else 1
        self._steps_per_iter = lanes_per_update * shard_envs * agent.hp.t_max
        # (actor_id, seq) and staleness of every payload consumed by the
        # last run() — the never-drop contract the tests pin down
        self.learned_ids: List[Tuple[int, int]] = []
        self.staleness: List[float] = []
        self.telemetry: Optional[Telemetry] = None
        # -- fault tolerance and checkpoints ---------------------------------
        # a bitwise resume needs the actors' carried state, which only the
        # thread backend's FIFO planes hold in this process; everywhere
        # else a checkpoint is a warm restart
        self._ckpt_slots = (self._backend == "thread"
                            and self._plane in ("device", "host")
                            and not self._replay)
        self._iters_done = 0  # cumulative completed updates (checkpoint id)
        self._resume_step: Optional[int] = None  # set by restore()
        self._resumed = False  # restore() put back each slot's state
        self._consumed_seq = [0] * n_actors  # a slot's consumed rollouts
        # slot -> (generator states, env_state, obs) after its newest
        # *consumed* rollout
        self._live_slot_state: Dict[int, tuple] = {}
        self.supervisor: Optional[ActorSupervisor] = None  # the last run's

    def _init_state(self, env, per_actor_envs, agent, optimizer, lr_schedule,
                    seed) -> None:
        n_actors, dev = self._n_actors, self.device
        # shared with ParallelRL — the same seeded layout, so a lock-stepped
        # single-actor pipeline reproduces the synchronous run bit for bit
        (self.optimizer, self.lr_schedule, act_gen, env_gen, self.params,
         self.opt_state) = init_rl_common(env, agent, optimizer, lr_schedule,
                                          seed, dev)
        if n_actors == 1:
            gens = [(act_gen, env_gen)]
        else:  # fresh streams, independent of the three above
            gens = _lane_generators(seed, self._mesh.devices
                                    if self._mesh is not None
                                    else [dev] * n_actors)
        self._actor_keys = gens
        if self._backend == "process":
            # no parent-side acting or env state: each worker owns its pool,
            # its act step and the acting generator the thread plane's
            # replica of the same index would get
            self._proc_specs = (per_actor_envs if per_actor_envs is not None
                                else env.shard(n_actors) if n_actors > 1
                                else [env])
            if any(e.n_envs != self._proc_specs[0].n_envs
                   for e in self._proc_specs):
                raise ValueError("per-actor specs must have equal n_envs")
            self._actor_envs = self._actor_obs = self._actor_env_state = None
            self._process_plane = ProcessActorPlane(
                self._proc_specs, agent, self.pipeline.queue_depth,
                self.params, [generator_state(g) for g, _ in gens],
                seed=seed)
            return
        self._proc_specs = None
        self._actor_envs, self._actor_obs, self._actor_env_state = \
            self._split_envs(env, per_actor_envs, n_actors)

    def _apply_update(self, traj, last_obs, step, publish_dst):
        """One update through the agent family's learner step, threading
        the learner-private state it carries; returns ``(published,
        metrics)``."""
        if self._mesh is not None:
            self._replicas, self.opt_state, published, metrics = \
                self._update_step(self._replicas, self.opt_state, traj,
                                  last_obs, step, publish_dst)
            self.params = self._replicas[0]
            # the publish's ready event is recorded on lane 0's stream: it
            # covers the other lanes' copies once that stream waits on them
            for s in self._lane_streams[1:]:
                self._learner_stream.wait_stream(s)
        elif self._dqn:
            (self.params, self.opt_state, self._target, self._updates,
             published, metrics) = self._update_step(
                self.params, self.opt_state, self._target, self._updates,
                traj, last_obs, step, publish_dst)
        else:
            self.params, self.opt_state, published, metrics = \
                self._update_step(self.params, self.opt_state, traj,
                                  last_obs, step, publish_dst)
        return published, metrics

    def _own(self, env):
        if isinstance(env, HostEnvSpec):
            env = env.build()
            self._owned_pools.append(env)
        return env

    # -- queue plane ---------------------------------------------------------
    def _resolve_plane(self, cfg: PipelineConfig) -> str:
        plane = cfg.rollout_plane
        if plane not in ("auto", "device", "host", "mesh"):
            raise ValueError("rollout_plane must be 'auto', 'device', 'host' "
                             f"or 'mesh', got {plane!r}")
        if plane == "mesh" or (plane == "auto" and cfg.mesh_shape > 1):
            if self._host:
                raise ValueError(
                    "rollout_plane='mesh' requires a batched tensor env: "
                    "HostEnvPool rollouts are born in host memory and "
                    "cannot ride per-device sub-rings")
            return "mesh"
        if plane == "auto":
            return "host" if self._host else "device"
        if plane == "device" and self._host:
            raise ValueError(
                "rollout_plane='device' requires a batched tensor env: "
                "HostEnvPool rollouts are born in host memory and must ride "
                "the host TrajectoryQueue plane")
        return plane

    # -- env splitting -------------------------------------------------------
    def _split_envs(self, env, per_actor_envs, n_actors: int):
        """Per-actor env replicas + their initial obs/state, each tensor env
        reset with its replica's env generator (state ``None`` for host
        pools, which keep their env state inside)."""
        if per_actor_envs is not None:
            envs = per_actor_envs
            if any(e.n_envs != env.n_envs for e in envs):
                raise ValueError("per-actor envs must have equal n_envs")
        elif n_actors == 1:
            envs = [env]
        elif self._host:
            envs = env.shard(n_actors)
        else:
            if env.n_envs % n_actors:
                raise ValueError(
                    f"cannot split {env.n_envs} envs across {n_actors} actors")
            envs = [narrow_vector_env(env, env.n_envs // n_actors)
                    for _ in range(n_actors)]
        if self._mesh is not None:
            # pin each lane to its device: the lane steps its own copy of
            # its env there, so its carried state, its observations and
            # the rollouts it puts in its sub-ring are born on that device
            envs = [narrow_vector_env(e, e.n_envs, device=d)
                    for e, d in zip(envs, self._mesh.devices)]
        if self._host:
            return envs, [e.reset() for e in envs], [None for _ in envs]
        states = [e.reset(env_gen) for e, (_, env_gen) in
                  zip(envs, self._actor_keys)]
        return envs, [e.observe(s) for e, s in zip(envs, states)], states

    # -- rollout collection closure (runs on actor thread i) -----------------
    def _make_collect(self, i: int) -> Callable:
        """``collect(params, key) -> (key, traj, last_obs, release)``, on
        actor ``i``'s env slice; ``key`` is its ``(act_generator,
        env_generator)`` pair. The bootstrap value is the learner's to
        compute, under its own params.

        Host pool: the rollout is written into a set of a per-actor
        ``HostStagingRing`` (``queue_depth + 2`` sets, page-locked on the
        card) and ``release`` hands the set back. Forced host plane on a
        tensor env: the device collect, then one copy of each field into
        such a set, waited for before the collect returns. Device plane:
        the collect's tensors, ``release`` ``None``."""
        env, t_max = self._actor_envs[i], self.agent.hp.t_max
        if self._host:
            staging = HostStagingRing(
                self.pipeline.queue_depth + 2, t_max, env.n_envs,
                env.obs_shape, env.obs_dtype,
                pin_memory=self.device.type == "cuda")

            def collect(params, key):
                s = staging.acquire()
                # the carried obs is the pool's own buffer, which only this
                # thread steps: no staging set holds it
                self._actor_obs[i], traj, last_obs = collect_host(
                    self._act, env, params, self._actor_obs[i], key[0],
                    t_max, staging=s)
                return key, traj, last_obs, (lambda: staging.release(s))

            return collect

        # the device-plane collects run guarded from their second call (the
        # first builds kernels and lets cuDNN choose its algorithms)
        warm = [False]
        if self._dqn:  # the replay plane's ε-greedy collect
            dqn_collect = make_dqn_collect_fn(self.agent, env, t_max)

            def collect(params, key):
                # the ε index: this replica's lifetime rollout count (in
                # lockstep the learner step, as in the synchronous schedule)
                n = self._actor_seq[i]
                act_gen, env_gen = key
                with sanitize.guard(active=warm[0]):
                    env_state, last_obs, traj = dqn_collect(
                        params, self._actor_env_state[i], self._actor_obs[i],
                        act_gen, env_gen, n)
                warm[0] = True
                self._actor_seq[i] = n + 1
                self._actor_env_state[i] = env_state
                self._actor_obs[i] = last_obs
                return key, traj, last_obs, None

            return collect
        collect_fn = make_collect_fn(self.agent.act_fn(), env, t_max)
        # mesh lane i collects with its own replica of the published set,
        # on its device, under the same lease
        mesh = self._mesh is not None
        staging = None
        if self._plane == "host":
            obs_dtype = torch.empty(0, dtype=self._actor_obs[i].dtype).numpy()
            staging = HostStagingRing(
                self.pipeline.queue_depth + 2, t_max, env.n_envs,
                env.obs_shape, obs_dtype.dtype,
                pin_memory=self.device.type == "cuda")

        def collect(params, key):
            act_gen, env_gen = key
            # the forced host plane stages to the host below, unguarded
            with sanitize.guard(active=warm[0] and staging is None):
                env_state, last_obs, traj = collect_fn(
                    params[i] if mesh else params, self._actor_env_state[i],
                    self._actor_obs[i], act_gen, env_gen)
            warm[0] = True
            self._actor_env_state[i] = env_state
            self._actor_obs[i] = last_obs
            if staging is None:
                return key, traj, last_obs, None
            # the GA3C-style baseline: stage the device trajectory into a
            # host set, one copy a field, and wait for the copies
            s = staging.acquire()
            for dst, src in zip(s.traj + (s.last_obs,), traj + (last_obs,)):
                dst.copy_(src, non_blocking=True)
            copied = record_event(traj)
            if copied is not None:
                copied.synchronize()
            return key, s.traj, s.last_obs, (lambda: staging.release(s))

        return collect

    # -- checkpoint / resume -------------------------------------------------
    def _make_snapshot(self, i: int) -> Callable:
        """Slot ``i``'s post-rollout state capture (thread backend):
        ``snap(key) -> (generator states, env_state, obs)``.

        The actor calls it right after a collect whose device work has
        finished, and the learner keeps the snapshot of the newest
        *consumed* rollout as the slot's resume point. The generators
        advance in place, so their states are copied out as bytes. Tensor
        envs: every env step builds new tensors and the collect assigns
        them to ``_actor_env_state``/``_actor_obs`` without ever writing
        into the old ones, so references are kept. Host pool: the env state
        lives inside the pool (a warm restart) and the carried obs is the
        pool's own buffer, which the next step overwrites, so it is copied.
        """
        if self._host:
            def snap(key, i=i):
                return (tuple(generator_state(g) for g in key), None,
                        np.array(self._actor_obs[i]))
        else:
            def snap(key, i=i):
                return (tuple(generator_state(g) for g in key),
                        self._actor_env_state[i], self._actor_obs[i])
        return snap

    def _checkpoint_template(self):
        """The checkpoint tree's *structure*: its leaves carry the dtypes,
        shapes and devices ``restore_checkpoint`` restores into. Save and
        restore both derive it from the live model, so a resume must run
        under the same config (the leaves' shapes are checked)."""
        n = self._n_actors
        tree = {
            "params": self.params,
            "opt_state": self.opt_state,
            # in place of the reference's key: each slot's generator pair
            # as this side holds it (the process workers' own states come
            # back only at the end of a run)
            "generators": {str(i): {"act": a, "env": e}
                           for i, (a, e) in enumerate(self._actor_keys)},
            "counters": {
                "total_steps": np.asarray(0, np.int64),
                "step_value": np.asarray(0, np.int64),
                "iters_done": np.asarray(0, np.int64),
                "actor_seq": np.zeros(n, np.int64),
                "consumed_seq": np.zeros(n, np.int64),
                # lifetime ring tickets (issued, consumed) at save time:
                # how many in-flight rollouts a kill dropped (re-collected
                # on resume, never silently skipped)
                "tickets": np.zeros(2, np.int64),
            },
        }
        if self._dqn:
            tree["dqn_target"] = self._target
            tree["dqn_updates"] = self._updates
        if self._ckpt_slots:
            tree["slots"] = {str(i): self._slot_tree(
                self._make_snapshot(i)(self._actor_keys[i]))
                for i in range(n)}
        return tree

    def _slot_tree(self, st) -> dict:
        gens, env_state, obs = st
        out = {"act": np.frombuffer(gens[0], np.uint8),
               "env": np.frombuffer(gens[1], np.uint8), "obs": obs}
        if env_state is not None:  # a host pool keeps its own
            out["env_state"] = env_state
        return out

    @staticmethod
    def _ticket_counts(ring) -> Tuple[int, int]:
        # the mesh ring counts a lane at a time
        return tuple(int(np.sum(getattr(ring, name, 0))) for name in
                     ("tickets_issued", "tickets_consumed"))

    def _save_checkpoint(self, ring, step_value: int) -> str:
        """Save the full pipeline state after the update that just
        committed. Runs on the learner thread, on its stream, between
        updates, so ``self.params``/``opt_state`` are quiescent; the copies
        to the host wait for the update that made them. On the card this
        is the checkpoint's whole cost to the learner."""
        tree = self._checkpoint_template()
        issued, consumed = self._ticket_counts(ring)
        tree["counters"] = {
            "total_steps": np.asarray(self.total_steps, np.int64),
            "step_value": np.asarray(step_value, np.int64),
            "iters_done": np.asarray(self._iters_done, np.int64),
            "actor_seq": np.asarray(self._actor_seq, np.int64),
            "consumed_seq": np.asarray(self._consumed_seq, np.int64),
            "tickets": np.asarray([issued, consumed], np.int64),
        }
        if self._ckpt_slots:
            tree["slots"] = {str(i): self._slot_tree(self._live_slot_state[i])
                             for i in range(self._n_actors)}
        path = save_checkpoint(self.pipeline.checkpoint_dir,
                               self._iters_done, tree, prefix="pipe")
        log.info("checkpoint: saved %s (update %d, %d steps)",
                 path, self._iters_done, self.total_steps)
        return path

    def restore(self, directory: Optional[str] = None, *,
                prefix: str = "pipe") -> int:
        """Restore the newest checkpoint; returns the number of learner
        updates already done (0 = nothing to restore). The caller runs the
        *remaining* iterations: on the thread backend's FIFO planes the
        resumed run continues the interrupted one bitwise under lockstep;
        elsewhere it is a warm restart. Restored tensors are new tensors,
        made on the caller's stream; the next run's publish hands them to
        the actors (ping-pong slot or shared-memory slot)."""
        directory = directory or self.pipeline.checkpoint_dir
        if not directory:
            raise ValueError("no checkpoint directory: pass one or set "
                             "PipelineConfig.checkpoint_dir")
        step = latest_step(directory, prefix=prefix)
        if step is None:
            return 0
        # the generators come back in place (restore_checkpoint sets the
        # target generators' states)
        tree = restore_checkpoint(directory, step,
                                  self._checkpoint_template(), prefix=prefix)
        self.params = tree["params"]
        self.opt_state = tree["opt_state"]
        if self._dqn:
            self._target = tree["dqn_target"]
            self._updates = tree["dqn_updates"]
        c = tree["counters"]
        self.total_steps = int(c["total_steps"])
        self._iters_done = int(c["iters_done"])
        self._resume_step = int(c["step_value"])
        self._actor_seq = [int(x) for x in c["actor_seq"]]
        self._consumed_seq = [int(x) for x in c["consumed_seq"]]
        if self._ckpt_slots:
            # each slot re-enters its generator/env/obs stream at the
            # boundary of its newest consumed rollout
            for i in range(self._n_actors):
                slot = tree["slots"][str(i)]
                act_gen, env_gen = self._actor_keys[i]
                set_generator_state(act_gen, slot["act"].tobytes())
                set_generator_state(env_gen, slot["env"].tobytes())
                if not self._host:
                    self._actor_env_state[i] = slot["env_state"]
                self._actor_obs[i] = slot["obs"]
            self._resumed = True
        issued, consumed = (int(x) for x in c["tickets"])
        log.info("checkpoint: restored update %d (%d steps) from %s; %d "
                 "in-flight rollout(s) at save time will be re-collected",
                 self._iters_done, self.total_steps, directory,
                 max(issued - consumed, 0))
        return self._iters_done

    def run(self, iterations: int, log_every: int = 0) -> RunResult:
        """Run ``iterations`` learner updates (each = one shard's n_e·t_max
        timesteps), fed by ``num_actors`` concurrent actor replicas."""
        n_actors, cfg = self._n_actors, self.pipeline
        hub = self.telemetry = Telemetry()
        learner_em = hub.emitter("learner")
        if self._replay:
            ring = ReplayRing(capacity=cfg.replay_capacity,
                              batch_size=cfg.replay_batch,
                              producers=n_actors,
                              prioritized=cfg.prioritized,
                              sample_seed=self._seed, telemetry=hub,
                              device=self.device)
        elif self._plane == "host":
            ring = TrajectoryQueue(cfg.queue_depth, producers=n_actors,
                                   telemetry=hub)
        elif self._mesh is not None:
            ring = MeshTrajectoryRing(cfg.queue_depth, self._mesh,
                                      telemetry=hub)
        else:
            ring = DeviceTrajectoryRing(cfg.queue_depth, producers=n_actors,
                                        telemetry=hub, device=self.device)
        if self._mesh is not None:
            # every lane contributes one rollout to every update: the quota
            # is `iterations` a lane, not split across lanes
            quota = [iterations] * n_actors
            # one replica of the learner's params a lane (restore() or a
            # caller may have replaced them); lane 0's holds their tensors
            self._replicas = replicated_sharding(self._mesh).split(
                self.params)
        else:
            quota = [iterations // n_actors + (1 if i < iterations % n_actors
                                               else 0)
                     for i in range(n_actors)]
        # the fault harness: the injector with or without elastic (fail-
        # fast chaos runs), the ledger and the supervisor only with it
        injector = (FaultInjector(cfg.fault_plan)
                    if cfg.fault_plan is not None else None)
        ledger = QuotaLedger(sum(quota)) if cfg.elastic else None
        ckpt_every = cfg.checkpoint_every
        snapshots = ckpt_every > 0 and self._ckpt_slots
        # a restore() put each slot back at its checkpointed boundary: the
        # seq numbering continues where the consumed stream left off (the
        # rollouts in flight at the save are collected again)
        resumed, self._resumed = self._resumed, False
        if resumed:
            start_seqs = list(self._consumed_seq)
        else:
            start_seqs = [0] * n_actors
            self._consumed_seq = [0] * n_actors
        # a slot with nothing consumed yet resumes from this run's start
        self._live_slot_state = (
            {i: self._make_snapshot(i)(self._actor_keys[i])
             for i in range(n_actors)} if snapshots else {})
        learner_stream = self._learner_stream
        if learner_stream is not None:
            # the params, optimizer state and env states were made on the
            # caller's streams: both sides start after them
            for s in self._lane_streams + self._actor_streams:
                s.wait_stream(torch.cuda.current_stream(s.device))
        # the actor-plane split: thread replicas collecting in this process,
        # or worker subprocesses behind parent-side drainers; below it the
        # learner loop sees the same payloads and the same reserve/commit
        # slot protocol from both
        with _on_streams(self._lane_streams):
            if self._process_plane is not None:
                slot, actors = self._process_plane.begin_run(
                    ring, quota, cfg.lockstep, self.params, telemetry=hub,
                    ledger=ledger, injector=injector)
            else:
                slot = PingPongParamSlot(
                    tuple(self._replicas) if self._mesh is not None
                    else self.params, version=0)
                actors = [
                    ActorThread(self._make_collect(i),
                                ring.lane(i) if self._mesh is not None
                                else ring, slot,
                                self._actor_keys[i], quota[i],
                                lockstep=cfg.lockstep, actor_id=i,
                                telemetry=hub, start_seq=start_seqs[i],
                                ledger=ledger, injector=injector,
                                snapshot=(self._make_snapshot(i)
                                          if snapshots else None),
                                stream=self._actor_streams[i])
                    for i in range(n_actors)]
        actors_by_id = {a.actor_id: a for a in actors}
        sup = None
        if cfg.elastic:
            if self._process_plane is not None:
                def respawner(dead, new_id, remaining):
                    d = self._process_plane.respawn_worker(
                        dead.slot_index, new_id, remaining, cfg.lockstep,
                        ring, telemetry=hub, ledger=ledger)
                    actors_by_id[new_id] = d
                    d.start()
                    return d
            else:
                def respawner(dead, new_id, remaining):
                    # the replacement resumes the dead replica's streams at
                    # its last rollout boundary — fresh generators from the
                    # boundary states (the dead ones may have advanced in a
                    # failed collect) and the carried env state, which a
                    # collect assigns only on success — with a fresh
                    # staging ring from _make_collect
                    i = dead.slot_index
                    key = tuple(torch.Generator(device=g.device)
                                for g in dead._key)
                    for g, st in zip(key, dead.boundary):
                        set_generator_state(g, st)
                    a = ActorThread(
                        self._make_collect(i), ring, slot, key, remaining,
                        lockstep=cfg.lockstep, actor_id=new_id,
                        telemetry=hub, slot_index=i, ledger=ledger,
                        injector=injector,
                        snapshot=self._make_snapshot(i) if snapshots else None,
                        stream=self._actor_streams[i],
                        # lockstep resumes at the version the dead replica
                        # would have waited for next
                        lockstep_base=dead._lockstep_base + dead.produced)
                    actors_by_id[new_id] = a
                    a.start()
                    return a
            sup = ActorSupervisor(ring, ledger, respawner,
                                  restart_budget=cfg.restart_budget,
                                  backoff_s=cfg.restart_backoff_s,
                                  telemetry=hub)
            for a in actors:
                sup.register(a)
        # kept on self (like .telemetry): the run's fault episodes
        self.supervisor = sup
        # device plane: never sync the learner loop — metric scalars are
        # stashed and read once at result(), so update i+1 is dispatched
        # while update i runs. Host plane: eager — reading the metrics back
        # waits for the update and the payload's copy before it on the
        # learner's stream, which certifies the staging set's release()
        acc = MetricsAccumulator(lazy=self._plane in ("device", "mesh"))
        self.learned_ids, self.staleness = [], []
        for a in actors:
            a.start()
        # observability side-cars: both optional, both read-only observers
        # of the emitters the hot paths write anyway
        hub.set_gauge("queue_depth", ring.qsize)
        if cfg.metrics_jsonl:
            hub.heartbeat_start(cfg.metrics_jsonl, interval=cfg.heartbeat_s,
                                actor_emitters=[a.span_emitter
                                                for a in actors])
        if cfg.stall_timeout_s > 0:
            hub.watchdog_start(cfg.stall_timeout_s, [
                ("learner", learner_em, None),
                *[(f"actor{a.actor_id}", a.span_emitter, a.is_alive)
                  for a in actors],
            ])
        # the schedule's step restarts at total_steps on every run, as in
        # ParallelRL.run; a restore() sets it, so a resumed run's schedule
        # continues where the interrupted one stopped
        step = (self._resume_step if self._resume_step is not None
                else self.total_steps)
        self._resume_step = None
        step0 = step
        completed = 0
        # the transfer sanitizer: from iteration 1 (iteration 0 builds the
        # kernels and lets cuDNN choose) the get → reserve → update → commit
        # block takes no host sync but at named edges; the bookkeeping
        # after it (metrics, priorities, checkpoints) reads on the host by
        # design and stays outside
        san = sanitize.transfers_enabled()
        try:
            with _on_streams(self._lane_streams):
                for i in range(iterations):
                    if injector is not None:
                        injector.stall_learner(i)
                    with sanitize.guard(active=san and i > 0):
                        learner_em.begin(QUEUE_GET_WAIT)
                        try:
                            payload = ring.get()
                        finally:
                            learner_em.end()
                        if payload is CLOSED:  # an actor died early
                            break
                        assert isinstance(payload, Rollout)
                        # a mesh payload: each lane's part on its stream
                        adopt(payload, self._lane_streams
                              if self._mesh is not None
                              else self._learner_stream)
                        # claim the stale ping-pong buffer; bounded by one
                        # in-flight collect (actors release before blocking
                        # on the ring), so a long wait means an actor died
                        # holding its lease: raise, naming the holder,
                        # instead of hanging
                        learner_em.begin(LEASE)
                        try:
                            deadline = time.monotonic() + cfg.lease_timeout_s
                            while True:
                                publish_dst = slot.reserve(i + 1, timeout=1.0)
                                if publish_dst is not None:
                                    break
                                live = (sup.all_actors() if sup is not None
                                        else actors)
                                if not any(a.is_alive() for a in live):
                                    raise RuntimeError(
                                        "param lease never released (all "
                                        "actors exited)")
                                if time.monotonic() >= deadline:
                                    held = ", ".join(slot.holders((i + 1) % 2))
                                    raise RuntimeError(
                                        f"param buffer {(i + 1) % 2} still "
                                        f"leased after lease_timeout_s="
                                        f"{cfg.lease_timeout_s:g}s — held by "
                                        f"{held or 'an unknown party'}")
                        finally:
                            learner_em.end()
                        prev_params = self.params
                        learner_em.begin(LEARNER_UPDATE)
                        try:
                            traj, last_obs = payload.traj, payload.last_obs
                            if self._plane == "host":  # the learner's stream
                                traj, last_obs = to_device(traj, last_obs,
                                                           self.device)
                            published, metrics = self._apply_update(
                                traj, last_obs, step, publish_dst)
                        finally:
                            learner_em.end()
                        learner_em.begin(PUBLISH)
                        try:
                            slot.commit(published, i + 1)
                        finally:
                            learner_em.end()
                    if san:
                        # the in-place probes: the publish is the reserved
                        # buffer itself, leaf by leaf; the learner's own
                        # params are replaced wholesale (never half)
                        sanitize.assert_deleted(
                            publish_dst, "reserved publish buffer",
                            into=published)
                        sanitize.assert_uniformly_deleted(
                            prev_params, "learner params", into=self.params)
                    step += 1
                    self.total_steps += self._steps_per_iter
                    completed += 1
                    hub.counter_add("steps", self._steps_per_iter)
                    self.learned_ids.append((payload.actor_id, payload.seq))
                    staleness = float(i - payload.behavior_version)
                    self.staleness.append(staleness)
                    metrics["staleness"] = staleness
                    hub.set_gauge("staleness", staleness)
                    if self._replay and cfg.prioritized:
                        # the update's |TD| as the sampled slots' new
                        # priority: float() waits for the update, the price
                        # of the feedback loop
                        td = metrics.get("td_abs")
                        pr = float(metrics["loss"].abs() if td is None
                                   else td)
                        ring.update_priorities(
                            ring.last_sampled, [pr] * len(ring.last_sampled))
                    # eager (host plane): waits for the update and the copy
                    # of the staged payload; lazy (device plane): stashes
                    acc.update(metrics)
                    if payload.release is not None:
                        if injector is not None and injector.drop_release(i):
                            # the injected lease drop: the set is leaked on
                            # purpose — the ring's queue_depth + 2 sizing
                            # must absorb it and the run complete
                            pass
                        else:
                            payload.release()  # consumed: the set is reusable
                    self._iters_done += 1
                    if ckpt_every:
                        # the newest consumed rollout of each slot: its
                        # post-collect snapshot is the slot's resume point
                        owner = actors_by_id.get(payload.actor_id)
                        if owner is not None:
                            self._consumed_seq[owner.slot_index] = \
                                payload.seq + 1
                            st = (owner.consume_state(payload.seq)
                                  if hasattr(owner, "consume_state")
                                  else None)
                            if st is not None:
                                self._live_slot_state[owner.slot_index] = st
                        if completed % ckpt_every == 0:
                            self._save_checkpoint(ring, step0 + completed)
                    # drop the payload now, not at the next get: its memory
                    # returns to the allocator while the learner waits
                    del (payload, publish_dst, published, traj, last_obs,
                         prev_params)
                    if log_every and (i + 1) % log_every == 0:
                        # fold only the already-executed updates: never sync
                        # the learner for a log line
                        log.info("iter %d steps %d staleness %.0f reward_sum "
                                 "%.3f loss %.4f", i + 1, self.total_steps,
                                 staleness,
                                 acc.cumulative_nowait("reward_sum"),
                                 acc.last("loss"))
        finally:
            # disarm recovery first: a replica dying during teardown must
            # not respawn a fresh one under the sweeps below
            if sup is not None:
                sup.shutdown()
                actors = sup.all_actors()  # the respawned epochs too
            # reap all actors on every exit path: signal stop, then keep
            # draining so puts blocked on a full ring can finish,
            # releasing discarded staged payloads, so no actor can wedge on
            # an empty staging ring while unwinding
            for a in actors:
                a.stop()
            while any(a.is_alive() for a in actors):
                try:
                    p = ring.get(timeout=0.05)
                    if p is not CLOSED and p.release is not None:
                        p.release()
                except _stdlib_queue.Empty:
                    pass
                for a in actors:
                    a.join(timeout=0.02)
            # the actors are gone, but the ring may still hold unconsumed
            # payloads (the learner bailed with rollouts buffered): release
            # them — the process plane's free lists persist across runs,
            # and a leaked index would starve the next run
            while True:
                try:
                    p = ring.get(timeout=0)
                except _stdlib_queue.Empty:
                    break
                if p is CLOSED:
                    break
                if p.release is not None:
                    p.release()
            if learner_stream is not None:
                for s in self._lane_streams + self._actor_streams:
                    torch.cuda.current_stream(s.device).wait_stream(s)
            # the run's lock-order verdict, attached to the hub (and so to
            # the trace) on every exit path, for the trainer to fail on
            if locks_enabled():
                hub.report("lockcheck", monitor().report())
            hub.stop()
            # the gauge's last reading, not the ring: a hub kept on self
            # must not keep a replay ring's rollouts alive after the run
            hub.set_gauge("queue_depth", ring.qsize())
            if cfg.trace_path:
                hub.write_trace(cfg.trace_path)
        if sup is not None and sup.fatal is not None:
            raise RuntimeError(
                f"pipeline stopped early after faults: {completed}/"
                f"{iterations} iterations — last live actor died"
            ) from sup.fatal.error
        # supervised deaths (fault_handled) were absorbed — respawned or
        # degraded — and must not fail a run that completed its quota
        errors = [a for a in actors
                  if a.error is not None and not a.fault_handled]
        if errors:
            raise RuntimeError(
                f"pipeline actor {errors[0].actor_id} failed") from errors[0].error
        if completed != iterations:
            raise RuntimeError(
                f"pipeline stopped early: {completed}/{iterations} iterations")
        if sup is not None and sup.episodes:
            log.warning("pipeline recovered from %d fault episode(s): %s",
                        len(sup.episodes), sup.episodes)
        for i, (act_gen, env_gen) in enumerate(self._actor_keys):
            # with a supervisor the slot's newest epoch carries its streams
            last = sup.slot_actor(i) if sup is not None else actors[i]
            if self._process_plane is not None:
                # each worker owns its acting generator: bring its state
                # back, so the parent's copy continues the worker's stream
                if last.final_state is not None:
                    set_generator_state(act_gen, last.final_state)
            elif last._key is not self._actor_keys[i]:
                # a respawned thread replica's own generators, at the
                # boundary of its last collect
                set_generator_state(act_gen, last.boundary[0])
                set_generator_state(env_gen, last.boundary[1])
        per_actor_idle = [a.put_wait_s + a.wait_s for a in actors]
        # the end-of-run drain reads every stashed device scalar: the one
        # intended device-to-host sync of the run
        with sanitize.allowed("metrics drain"):
            return acc.result(self.total_steps, self._steps_per_iter,
                              actor_idle_s=sum(per_actor_idle),
                              learner_idle_s=ring.get_wait_s,
                              per_actor_idle_s=per_actor_idle)

    # -- teardown ------------------------------------------------------------
    def close(self) -> None:
        """Release what this backend owns: the process plane's workers and
        their shared memory, and the ``HostEnvPool``s it built from
        ``HostEnvSpec``s. Live pools the caller handed in stay the caller's
        to close. Idempotent."""
        if self._process_plane is not None:
            self._process_plane.close()
            self._process_plane = None
        for pool in self._owned_pools:
            pool.close()
        self._owned_pools = []

    def __enter__(self) -> "PipelinedRL":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
