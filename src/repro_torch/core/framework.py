"""PAAC framework orchestrator — paper Algorithm 1 end to end.

``ParallelRL`` wires a batched tensor env + agent + optimizer into one
train step per iteration and runs the outer ``until N >= N_max`` loop
(line 3/20) on the host, tracking throughput (timesteps/s — the paper's
Fig. 2/4 metric) and episode returns. It runs on the card unless its
caller passes ``device="cpu"``; the env must live on the same device.

Two environment regimes, as in the reference:

* batched tensor ``VectorEnv`` — acting, stepping and learning all run on
  the device, one train step per iteration. ``ParallelRL`` is algorithm
  agnostic here (paper §3): any ``Agent`` supplies the train step.
  ``DQNAgent`` and ``LaggedPAACAgent`` also carry state between steps (the
  replay buffer and target network; the stale parameter copy), which the
  framework creates and threads through; ``PAACAgent`` and ``PPOAgent``
  carry none.
* ``HostEnvPool`` — external gym-style envs stepped by host worker threads
  (paper §3 literally). One iteration is a host-side rollout
  (``pipeline.actor.collect_host``: acting on the device, threaded env
  stepping) into one page-locked staging set, then its copy to the device
  and the pipeline learner's update at infinite clips (n-step returns
  through K1). This is the paper's Fig. 2 "env time on the critical path"
  regime, and it drives plain ``PAACAgent`` only, as the reference does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.agents.base import Agent
from repro_torch.core.agents.baselines import LaggedPAACAgent
from repro_torch.core.agents.dqn import DQNAgent
from repro_torch.core.agents.replay import replay_nbytes
from repro_torch.device import resolve_device
from repro_torch.envs.base import VectorEnv
from repro_torch.envs.host_env import HostEnvPool
from repro_torch.models import init_policy
from repro_torch.optim import constant, make_optimizer
from repro_torch.utils import get_logger
from repro_torch.utils.sampling import seeded_generators

log = get_logger("framework")


@dataclass
class RunResult:
    steps: int
    episodes: float
    mean_metrics: Dict[str, float]
    timesteps_per_sec: float = 0.0
    # pipeline accounting (0 for the synchronous backend): time the actors
    # spent blocked on a full ring / waiting for params (merged across
    # replicas), and time the learner spent blocked on an empty ring.
    # ``per_actor_idle_s[i]`` attributes the merged actor idle time to
    # replica i; it sums to ``actor_idle_s``.
    actor_idle_s: float = 0.0
    learner_idle_s: float = 0.0
    per_actor_idle_s: List[float] = field(default_factory=list)


def _done_event(metrics: Dict):
    """A CUDA event recorded after the work that produces ``metrics``, or
    ``None`` when no metric lives on a card."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            with torch.cuda.device(v.device):
                event = torch.cuda.Event()
                event.record()
            return event
    return None


class MetricsAccumulator:
    """Shared run-loop accounting: per-iteration metric dicts → RunResult
    (mean-per-iteration metrics, episode counts, timesteps/s over the run's
    wall-clock).

    ``lazy=True`` defers the host conversion of device metric scalars: each
    ``update`` only stashes the dict (and a CUDA event after it), and the
    blocking ``float()`` reads happen once, in ``result``. Eager mode waits
    for the device every iteration. Both fold in the same host-side float
    arithmetic, so they report identical metrics; the wall clock is read
    after the drain, so timesteps/s covers the full execution.
    """

    def __init__(self, lazy: bool = False):
        self.acc: Dict[str, float] = {}
        self.episodes = 0.0
        self.iters = 0
        self.lazy = lazy
        self._pending: List = []  # (metrics, CUDA event or None)
        self._last: Dict = {}  # most recently *folded* metrics dict
        self._t0 = time.perf_counter()

    def update(self, metrics: Dict) -> None:
        self.iters += 1
        if self.lazy:
            self._pending.append((metrics, _done_event(metrics)))
            return
        self._fold(metrics)

    def _fold(self, metrics: Dict) -> None:
        for k, v in metrics.items():
            self.acc[k] = self.acc.get(k, 0.0) + float(v)
        self.episodes += float(metrics.get("episodes", 0.0))
        self._last = metrics

    def _drain(self) -> None:
        for metrics, _ in self._pending:
            self._fold(metrics)
        self._pending.clear()

    def drain_ready(self) -> None:
        """Fold only the pending dicts whose device work has finished
        (their event has completed), front of the queue first, stopping at
        the first one still running. Never blocks."""
        while self._pending and (self._pending[0][1] is None
                                 or self._pending[0][1].query()):
            self._fold(self._pending.pop(0)[0])

    def cumulative(self, key: str, default: float = 0.0) -> float:
        """Running sum of one metric (drains pending device scalars first —
        a sync point, so only for explicit logging paths)."""
        self._drain()
        return self.acc.get(key, default)

    def cumulative_nowait(self, key: str, default: float = 0.0) -> float:
        """Running sum over *already-executed* updates only."""
        self.drain_ready()
        return self.acc.get(key, default)

    def last(self, key: str, default: float = 0.0) -> float:
        """Latest folded value of one metric."""
        return float(self._last.get(key, default))

    def result(self, steps: int, steps_per_iter: int, **extra) -> RunResult:
        self._drain()  # waits until every dispatched update has executed
        dt = time.perf_counter() - self._t0
        mean = {k: v / max(self.iters, 1) for k, v in self.acc.items()}
        return RunResult(
            steps=steps,
            episodes=self.episodes,
            mean_metrics=mean,
            timesteps_per_sec=steps_per_iter * self.iters / max(dt, 1e-9),
            **extra,
        )


def init_rl_common(env, agent, optimizer: str, lr_schedule, seed: int,
                   device="cuda"):
    """The constructor half of ``ParallelRL``.

    Returns ``(optimizer, lr_schedule, act_generator, env_generator, params,
    opt_state)``. The parameter, env and acting generators come from
    ``seed`` in that fixed order (``seeded_generators(seed, 3, device)``),
    so two runs with one seed draw the same numbers.
    """
    dev = resolve_device(device)
    opt = make_optimizer(optimizer)
    if lr_schedule is None:
        lr_schedule = constant(0.0007 * env.n_envs)  # paper §5.2 rule
    param_gen, env_gen, act_gen = seeded_generators(seed, 3, dev)
    params = init_policy(agent.cfg, generator=param_gen, device=dev)
    return opt, lr_schedule, act_gen, env_gen, params, opt.init(params)


class ParallelRL:
    """The paper's master/worker framework: one train step per iteration."""

    def __init__(
        self,
        env,
        agent: Agent,
        *,
        optimizer: str = "rmsprop",
        lr_schedule: Optional[Callable] = None,
        seed: int = 0,
        replay_capacity: int = 50_000,
        device="cuda",
    ):
        dev = resolve_device(device)
        self._host = isinstance(env, HostEnvPool)
        if not (self._host or isinstance(env, VectorEnv)):
            raise NotImplementedError(
                f"ParallelRL drives batched tensor envs (VectorEnv) and "
                f"external host env pools (HostEnvPool); "
                f"{type(env).__name__} is neither")
        if env.device.type != dev.type:
            raise ValueError(f"env lives on {env.device}, ParallelRL runs on "
                             f"{dev}")
        self.env = env
        self.agent = agent
        self.device = dev
        (self.optimizer, self.lr_schedule, self.act_generator,
         self.env_generator, self.params, self.opt_state) = init_rl_common(
             env, agent, optimizer, lr_schedule, seed, dev)
        self.total_steps = 0
        self._steps_per_iter = env.n_envs * agent.hp.t_max
        if self._host:
            self._init_host(env, agent)
            return
        self.env_state = env.reset(self.env_generator)
        self.obs = env.observe(self.env_state)
        self._has_agent_state = isinstance(agent, (DQNAgent, LaggedPAACAgent))
        if isinstance(agent, DQNAgent):
            self.agent_state = agent.init_state(
                replay_capacity, env.obs_shape, self.params, self.obs.dtype,
                device=dev)
            log.info("DQN replay buffer: %d transitions of %s %s, %d bytes "
                     "on %s", replay_capacity, tuple(env.obs_shape),
                     self.obs.dtype, replay_nbytes(self.agent_state["replay"]),
                     dev)
        elif isinstance(agent, LaggedPAACAgent):
            self.agent_state = agent.init_state(self.params)
        else:
            self.agent_state = None
        self._train_step = agent.make_train_step(env, self.optimizer,
                                                 self.lr_schedule)

    # -- the HostEnvPool regime ----------------------------------------------
    def _init_host(self, pool: HostEnvPool, agent) -> None:
        from repro_torch.core.agents.paac import PAACAgent
        from repro_torch.pipeline.actor import (StagingSet, collect_host,
                                                make_host_act_step)
        from repro_torch.pipeline.learner import make_learner_step

        # exact type: subclasses/look-alikes (LaggedPAACAgent, PPOAgent,
        # DQNAgent) need their own update step, which the shared host
        # learner step would silently replace with the plain PAAC loss
        if type(agent) is not PAACAgent:
            raise NotImplementedError(
                "HostEnvPool currently drives plain PAACAgent "
                f"(got {type(agent).__name__})")
        self._has_agent_state = False
        self.agent_state = self.env_state = None
        self.obs = pool.reset()
        self._collect_host = collect_host
        self._act = make_host_act_step(agent.act_fn())
        # one reusable staging set: the loop reads every update's metrics
        # back (an eager MetricsAccumulator) before the next rollout
        # overwrites the set, and that read waits for the update and the
        # copy of the set to the card that precedes it on the stream
        self._staging = StagingSet(agent.hp.t_max, pool.n_envs,
                                   pool.obs_shape, pool.obs_dtype,
                                   pin_memory=self.device.type == "cuda")
        # the pipelined learner's step at infinite clips: the correction
        # left out exactly, so a lock-stepped pipeline matches this loop
        # bit for bit (n-step returns through K1)
        self._update_step = make_learner_step(
            agent, self.optimizer, self.lr_schedule, rho_bar=float("inf"),
            c_bar=float("inf"))

    def _host_iteration(self, step: int):
        from repro_torch.pipeline.actor import to_device

        self.obs, traj, last_obs = self._collect_host(
            self._act, self.env, self.params, self.obs, self.act_generator,
            self.agent.hp.t_max, staging=self._staging)
        traj, last_obs = to_device(traj, last_obs, self.device)
        self.params, self.opt_state, metrics = self._update_step(
            self.params, self.opt_state, traj, last_obs, step)
        return metrics

    def run(self, iterations: int, log_every: int = 0) -> RunResult:
        """Run `iterations` framework iterations (each = n_e·t_max timesteps)."""
        acc = MetricsAccumulator()
        # the schedule's step restarts at total_steps on every run, as in
        # repro.core.framework.ParallelRL.run
        step = self.total_steps
        for i in range(iterations):
            if self._host:
                metrics = self._host_iteration(step)
            elif self._has_agent_state:
                (self.params, self.opt_state, self.agent_state,
                 self.env_state, self.obs, metrics) = self._train_step(
                     self.params, self.opt_state, self.agent_state,
                     self.env_state, self.obs, self.act_generator,
                     self.env_generator, step)
            else:
                (self.params, self.opt_state, self.env_state, self.obs,
                 metrics) = self._train_step(
                     self.params, self.opt_state, self.env_state, self.obs,
                     self.act_generator, self.env_generator, step)
            self.total_steps += self._steps_per_iter
            step += 1
            acc.update(metrics)
            if log_every and (i + 1) % log_every == 0:
                log.info("iter %d steps %d reward_sum %.3f loss %.4f",
                         i + 1, self.total_steps,
                         acc.acc.get("reward_sum", 0.0),
                         float(metrics.get("loss", 0.0)))
        return acc.result(self.total_steps, self._steps_per_iter)
