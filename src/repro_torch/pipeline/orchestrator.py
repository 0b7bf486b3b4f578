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

It drives plain ``PAACAgent``, as the reference does on its FIFO planes;
the reference's other agents are refused as it refuses them, and
``DQNAgent``, which the reference runs on its replay plane, is refused
naming that plane's item. The reference's mesh plane (ROADMAP Queue 1
item 14), process backend, replay plane, supervisor, faults and
checkpoints (item 10) are refused with ``NotImplementedError``.
"""
from __future__ import annotations

import queue as _stdlib_queue
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.configs.base import PipelineConfig
from repro_torch.core.agents.dqn import DQNAgent
from repro_torch.core.agents.paac import PAACAgent
from repro_torch.core.framework import (MetricsAccumulator, RunResult,
                                        init_rl_common)
from repro_torch.core.rollout import make_collect_fn
from repro_torch.device import resolve_device
from repro_torch.envs.base import VectorEnv, narrow_vector_env
from repro_torch.envs.host_env import HostEnvPool, HostEnvSpec
from repro_torch.pipeline.actor import (ActorThread, HostStagingRing,
                                        PingPongParamSlot, Rollout,
                                        collect_host, make_host_act_step,
                                        on_stream, record_event, to_device)
from repro_torch.pipeline.learner import make_learner_step
from repro_torch.pipeline.queue import CLOSED, TrajectoryQueue
from repro_torch.pipeline.ring import DeviceTrajectoryRing, adopt
from repro_torch.telemetry import (LEARNER_UPDATE, LEASE, PUBLISH,
                                   QUEUE_GET_WAIT, Telemetry)
from repro_torch.utils import get_logger
from repro_torch.utils.sampling import seeded_generators

log = get_logger("pipeline")


def _is_host(env) -> bool:
    """A host env pool (or shard) or the recipe of one."""
    return isinstance(env, HostEnvSpec) or hasattr(env, "step_host")


def _refuse_unported(cfg: PipelineConfig) -> None:
    """``NotImplementedError`` for each setting outside the device and host
    planes with thread actors, naming the ROADMAP item that ports it."""
    unported = [
        (cfg.rollout_plane == "mesh" or cfg.mesh_shape > 1, "the mesh plane "
         "(rollout_plane='mesh', mesh_shape > 1) is ROADMAP Queue 1 item 14"),
        (cfg.actor_backend == "process", "actor_backend='process' is ROADMAP "
         "Queue 1 item 10"),
        (cfg.replay_plane, "replay_plane is ROADMAP Queue 1 item 10"),
        (cfg.elastic, "elastic recovery is ROADMAP Queue 1 item 10"),
        (cfg.fault_plan is not None, "fault_plan is ROADMAP Queue 1 item 10"),
        (bool(cfg.checkpoint_dir), "checkpoint_dir is ROADMAP Queue 1 item "
         "10"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"PipelinedRL of the port: {what}")


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
        if type(agent) is DQNAgent:
            if not pipeline.replay_plane:
                raise ValueError(
                    "DQNAgent needs the replay plane: pass PipelineConfig("
                    "replay_plane=True) — the FIFO planes feed the on-policy "
                    "V-trace learner")
            raise NotImplementedError(
                "PipelinedRL of the port: DQNAgent rides the replay plane, "
                "which is ROADMAP Queue 1 item 10")
        if type(agent) is not PAACAgent:
            raise NotImplementedError(
                f"PipelinedRL drives plain PAACAgent (got "
                f"{type(agent).__name__}) on the FIFO planes, plus DQNAgent "
                "on the replay plane; other agents carry losses the learner "
                "steps would silently drop")
        if pipeline.actor_backend not in ("thread", "process"):
            raise ValueError("actor_backend must be 'thread' or 'process', "
                             f"got {pipeline.actor_backend!r}")
        n_actors = pipeline.num_actors
        if n_actors < 1:
            raise ValueError(f"num_actors must be >= 1, got {n_actors}")
        if pipeline.lockstep and n_actors > 1:
            raise ValueError("lockstep (synchronous semantics) requires "
                             "num_actors == 1")
        per_actor_envs = list(env) if isinstance(env, (list, tuple)) else None
        if per_actor_envs is not None and len(per_actor_envs) != n_actors:
            raise ValueError(f"got {len(per_actor_envs)} per-actor envs "
                             f"for num_actors={n_actors}")
        first = per_actor_envs[0] if per_actor_envs is not None else env
        self._host = _is_host(first)
        self._plane = self._resolve_plane(pipeline)
        _refuse_unported(pipeline)
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
        # a HostEnvSpec is sugar for the pool(s) built here, which close()
        # closes; pools the caller hands in stay the caller's to close
        self._owned_pools: List[HostEnvPool] = []
        if per_actor_envs is not None:
            per_actor_envs = [self._own(e) for e in per_actor_envs]
            env = per_actor_envs[0]
        else:
            env = self._own(env)
        self.env = env
        self.agent = agent
        self.pipeline = pipeline
        self.device = dev
        self._n_actors = n_actors
        try:
            self._init_state(env, per_actor_envs, agent, optimizer,
                             lr_schedule, seed)
        except BaseException:
            self.close()  # the pools built from specs
            raise
        self._act = (make_host_act_step(agent.act_fn()) if self._host
                     else None)
        # the learner step: dequeue-consume + update + publish into the
        # stale ping-pong buffer, on the learner's stream
        self._update_step = make_learner_step(
            agent, self.optimizer, self.lr_schedule, rho_bar=pipeline.rho_bar,
            c_bar=pipeline.c_bar, fused_publish=True)
        if dev.type == "cuda":
            self._learner_stream = torch.cuda.Stream(dev)
            self._actor_streams = [torch.cuda.Stream(dev)
                                   for _ in range(n_actors)]
        else:
            self._learner_stream = None
            self._actor_streams = [None] * n_actors
        self.total_steps = 0
        # one learned rollout = one actor shard's n_envs·t_max timesteps
        self._steps_per_iter = self._actor_envs[0].n_envs * agent.hp.t_max
        # (actor_id, seq) and staleness of every payload consumed by the
        # last run() — the never-drop contract the tests pin down
        self.learned_ids: List[Tuple[int, int]] = []
        self.staleness: List[float] = []
        self.telemetry: Optional[Telemetry] = None

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
            more = seeded_generators(seed, 3 + 2 * n_actors, dev)[3:]
            gens = list(zip(more[0::2], more[1::2]))
        self._actor_keys = gens
        self._actor_envs, self._actor_obs, self._actor_env_state = \
            self._split_envs(env, per_actor_envs, n_actors)

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
        if self._host and (plane == "mesh" or cfg.mesh_shape > 1):
            raise ValueError(
                "rollout_plane='mesh' requires a batched tensor env: "
                "HostEnvPool rollouts are born in host memory and cannot "
                "ride per-device sub-rings")
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

        collect_fn = make_collect_fn(self.agent.act_fn(), env, t_max)
        staging = None
        if self._plane == "host":
            obs_dtype = torch.empty(0, dtype=self._actor_obs[i].dtype).numpy()
            staging = HostStagingRing(
                self.pipeline.queue_depth + 2, t_max, env.n_envs,
                env.obs_shape, obs_dtype.dtype,
                pin_memory=self.device.type == "cuda")

        def collect(params, key):
            act_gen, env_gen = key
            env_state, last_obs, traj = collect_fn(
                params, self._actor_env_state[i], self._actor_obs[i], act_gen,
                env_gen)
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

    def run(self, iterations: int, log_every: int = 0) -> RunResult:
        """Run ``iterations`` learner updates (each = one shard's n_e·t_max
        timesteps), fed by ``num_actors`` concurrent actor replicas."""
        n_actors, cfg = self._n_actors, self.pipeline
        hub = self.telemetry = Telemetry()
        learner_em = hub.emitter("learner")
        if self._plane == "host":
            ring = TrajectoryQueue(cfg.queue_depth, producers=n_actors,
                                   telemetry=hub)
        else:
            ring = DeviceTrajectoryRing(cfg.queue_depth, producers=n_actors,
                                        telemetry=hub, device=self.device)
        quota = [iterations // n_actors + (1 if i < iterations % n_actors
                                           else 0)
                 for i in range(n_actors)]
        learner_stream = self._learner_stream
        if learner_stream is not None:
            # the params, optimizer state and env states were made on the
            # caller's stream: both sides start after it
            caller = torch.cuda.current_stream(self.device)
            learner_stream.wait_stream(caller)
            for s in self._actor_streams:
                s.wait_stream(caller)
        with on_stream(learner_stream):
            slot = PingPongParamSlot(self.params, version=0)
        actors = [
            ActorThread(self._make_collect(i), ring, slot,
                        self._actor_keys[i], quota[i], lockstep=cfg.lockstep,
                        actor_id=i, telemetry=hub,
                        stream=self._actor_streams[i])
            for i in range(n_actors)
        ]
        # device plane: never sync the learner loop — metric scalars are
        # stashed and read once at result(), so update i+1 is dispatched
        # while update i runs. Host plane: eager — reading the metrics back
        # waits for the update and the payload's copy before it on the
        # learner's stream, which certifies the staging set's release()
        acc = MetricsAccumulator(lazy=self._plane == "device")
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
        # ParallelRL.run
        step = self.total_steps
        completed = 0
        try:
            with on_stream(learner_stream):
                for i in range(iterations):
                    learner_em.begin(QUEUE_GET_WAIT)
                    try:
                        payload = ring.get()
                    finally:
                        learner_em.end()
                    if payload is CLOSED:  # an actor died early
                        break
                    assert isinstance(payload, Rollout)
                    adopt(payload, learner_stream)
                    # claim the stale ping-pong buffer; bounded by one
                    # in-flight collect (actors release before blocking on
                    # the ring), so a long wait means an actor died holding
                    # its lease: raise, naming the holder, instead of hanging
                    learner_em.begin(LEASE)
                    try:
                        deadline = time.monotonic() + cfg.lease_timeout_s
                        while True:
                            publish_dst = slot.reserve(i + 1, timeout=1.0)
                            if publish_dst is not None:
                                break
                            if not any(a.is_alive() for a in actors):
                                raise RuntimeError("param lease never "
                                                   "released (all actors "
                                                   "exited)")
                            if time.monotonic() >= deadline:
                                held = ", ".join(slot.holders((i + 1) % 2))
                                raise RuntimeError(
                                    f"param buffer {(i + 1) % 2} still "
                                    f"leased after lease_timeout_s="
                                    f"{cfg.lease_timeout_s:g}s — held by "
                                    f"{held or 'an unknown party'}")
                    finally:
                        learner_em.end()
                    learner_em.begin(LEARNER_UPDATE)
                    try:
                        traj, last_obs = payload.traj, payload.last_obs
                        if self._plane == "host":  # on the learner's stream
                            traj, last_obs = to_device(traj, last_obs,
                                                       self.device)
                        self.params, self.opt_state, published, metrics = \
                            self._update_step(self.params, self.opt_state,
                                              traj, last_obs, step,
                                              publish_dst)
                    finally:
                        learner_em.end()
                    learner_em.begin(PUBLISH)
                    try:
                        slot.commit(published, i + 1)
                    finally:
                        learner_em.end()
                    step += 1
                    self.total_steps += self._steps_per_iter
                    completed += 1
                    hub.counter_add("steps", self._steps_per_iter)
                    self.learned_ids.append((payload.actor_id, payload.seq))
                    staleness = float(i - payload.behavior_version)
                    self.staleness.append(staleness)
                    metrics["staleness"] = staleness
                    hub.set_gauge("staleness", staleness)
                    # eager (host plane): waits for the update and the copy
                    # of the staged payload; lazy (device plane): stashes
                    acc.update(metrics)
                    if payload.release is not None:
                        payload.release()  # consumed: the set is reusable
                    # drop the payload now, not at the next get: its memory
                    # returns to the allocator while the learner waits
                    del payload, publish_dst, published, traj, last_obs
                    if log_every and (i + 1) % log_every == 0:
                        # fold only the already-executed updates: never sync
                        # the learner for a log line
                        log.info("iter %d steps %d staleness %.0f reward_sum "
                                 "%.3f loss %.4f", i + 1, self.total_steps,
                                 staleness,
                                 acc.cumulative_nowait("reward_sum"),
                                 acc.last("loss"))
        finally:
            # reap all actors on every exit path: signal stop, then keep
            # draining so puts blocked on a full ring can finish
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
            if learner_stream is not None:
                caller = torch.cuda.current_stream(self.device)
                caller.wait_stream(learner_stream)
                for s in self._actor_streams:
                    caller.wait_stream(s)
            hub.stop()
            if cfg.trace_path:
                hub.write_trace(cfg.trace_path)
        errors = [a for a in actors if a.error is not None]
        if errors:
            raise RuntimeError(
                f"pipeline actor {errors[0].actor_id} failed") from errors[0].error
        if completed != iterations:
            raise RuntimeError(
                f"pipeline stopped early: {completed}/{iterations} iterations")
        per_actor_idle = [a.put_wait_s + a.wait_s for a in actors]
        # the end-of-run drain reads every stashed device scalar: the one
        # intended device-to-host sync of the run
        return acc.result(self.total_steps, self._steps_per_iter,
                          actor_idle_s=sum(per_actor_idle),
                          learner_idle_s=ring.get_wait_s,
                          per_actor_idle_s=per_actor_idle)

    # -- teardown ------------------------------------------------------------
    def close(self) -> None:
        """Release what this backend owns: the ``HostEnvPool``s it built
        from ``HostEnvSpec``s. Live pools the caller handed in stay the
        caller's to close. Idempotent."""
        for pool in self._owned_pools:
            pool.close()
        self._owned_pools = []

    def __enter__(self) -> "PipelinedRL":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
