"""DQN through the pipeline: ε-greedy collection and a replay-fed learner
step (a port of ``repro.pipeline.offpolicy``).

The paper's framework claims algorithm agnosticism (§3); the pipeline
cashes the off-policy half of that claim here. Three pieces:

* ``make_dqn_collect_fn`` — the acting half of the DQN train step
  (``repro_torch.core.agents.dqn``) detached into a standalone rollout
  collector, as ``make_collect_fn`` detaches PAAC's acting: ``t_max``
  ε-greedy steps whose output feeds the device ``ReplayRing`` without
  touching host memory. ε comes from the *rollout index* the caller
  threads through (each actor replica counts its own rollouts); in
  lockstep that index equals the learner step, as in the synchronous
  schedule. The acting generator draws, each step, E uniforms (explore
  where u < ε) then E random actions — the DQN train step's order — and
  the env steps draw from the env generator.
* ``make_dqn_learner_step`` — the learning half on a *sampled rollout*:
  the ``(T, E)`` trajectory flattened to ``T·E`` transitions (successor
  observations from the time axis plus the bootstrap ``last_obs``), one
  TD update against the target network, the periodic hard target sync.
  With ``fused_publish`` it writes the actor-facing snapshot like
  ``make_learner_step``; the target tree and the update counter ride the
  signature as learner-private state.
* ``SyncReplayDQN`` — the *synchronous replay reference*: the same
  collect, the same ``ReplayRing`` (same sample seed), the same learner
  step, driven serially by one thread (collect → put → get → update). A
  depth-1 lockstep pipelined run must reproduce it bit for bit, proving
  the thread and ring machinery adds no numerics. (``ParallelRL``'s DQN is
  a different program — replay by transition — and is the throughput
  baseline, not the bitwise reference.)

DQN needs no V-trace: Q-learning's TD target is defined off-policy, so
this path runs no kernel. The acting-time ``Transition.logp`` is the
ε-greedy behaviour policy's, ``log((1−ε)·1[a = argmax Q] + ε/A)``, so the
payload keeps the canonical layout.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.agents.dqn import dqn_loss, dqn_sync_target
from repro_torch.core.framework import (MetricsAccumulator, RunResult,
                                        init_rl_common)
from repro_torch.core.rollout import Transition
from repro_torch.device import resolve_device
from repro_torch.models import policy_apply
from repro_torch.pipeline.actor import Rollout, _copy_tree
from repro_torch.pipeline.replay_ring import ReplayRing
from repro_torch.utils.tree import tree_leaves, tree_unflatten

__all__ = ["DQNActDraws", "make_dqn_collect_fn", "make_dqn_learner_step",
           "SyncReplayDQN"]


class DQNActDraws(NamedTuple):
    """A collect's acting-generator draws, for a test to inject."""
    u: torch.Tensor  # (t_max, E) uniforms: explore where u < ε
    rand: torch.Tensor  # (t_max, E) random actions


def make_dqn_collect_fn(agent, env, t_max: int) -> Callable:
    """Standalone ε-greedy rollout collector for ``DQNAgent``.

    Returns ``collect(params, env_state, obs, act_generator, env_generator,
    rollout_idx, draws=None) -> (env_state, last_obs, traj)``; ``draws``
    (a ``DQNActDraws``), if given, replaces the acting generator's draws.
    ``Transition.value`` carries the greedy Q-value and ``logp`` the
    ε-greedy behaviour log-prob.
    """
    cfg = agent.cfg

    @torch.no_grad()
    def collect(params, env_state, obs, act_generator, env_generator,
                rollout_idx: int, draws: Optional[DQNActDraws] = None):
        eps = agent.epsilon(rollout_idx)
        steps = []
        for t in range(t_max):
            q, _, _ = policy_apply(params, cfg, obs)
            greedy = q.argmax(dim=-1)
            n_actions = q.shape[-1]
            if draws is None:
                u = torch.rand(greedy.shape, generator=act_generator,
                               device=greedy.device)
                rand = torch.randint(0, n_actions, greedy.shape,
                                     generator=act_generator,
                                     device=greedy.device)
            else:
                u = draws.u[t].to(greedy.device)
                rand = draws.rand[t].to(greedy.device, torch.int64)
            action = torch.where(u < eps, rand, greedy)
            value = q.amax(dim=-1)
            # Python scalars, not tensors built from them: a tensor made
            # from a host value on the card is a blocking copy a step
            logp = torch.where(action == greedy, 1.0 - eps + eps / n_actions,
                               eps / n_actions).log()
            env_state, next_obs, reward, done = env.step(env_state, action,
                                                         env_generator)
            steps.append((obs, action, reward, done, value, logp))
            obs = next_obs
        traj = Transition(*(torch.stack(x) for x in zip(*steps)))
        return env_state, obs, traj

    return collect


def make_dqn_learner_step(agent, optimizer, lr_schedule,
                          fused_publish: bool = False) -> Callable:
    """Build the replay-fed DQN learner's update step.

    ``fused_publish=False``:
    ``(params, opt_state, target, updates, traj, last_obs, step) ->
    (params, opt_state, target, updates, metrics)``.
    ``fused_publish=True`` adds the publish exactly like
    ``make_learner_step`` (an extra ``publish_dst`` argument, written in
    place with the new params, and an extra ``published`` output before
    ``metrics``). ``updates`` is a host int, as in ``DQNAgent``'s state.
    """
    cfg, hp = agent.cfg, agent.hp

    def _update(params, opt_state, target, updates, traj, last_obs, step):
        T, E = traj.action.shape
        next_obs = torch.cat([traj.obs[1:], last_obs[None]], dim=0)

        def flat(x):
            return x.reshape((T * E,) + tuple(x.shape[2:]))

        batch = {"obs": flat(traj.obs), "action": flat(traj.action),
                 "reward": flat(traj.reward), "next_obs": flat(next_obs),
                 "done": flat(traj.done)}
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = dqn_loss(tree_unflatten(params, leaves), target,
                                     batch, cfg, hp.gamma)
            # the value head takes no part: its gradient is zero
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        params, opt_state = optimizer.update(tree_unflatten(params, grads),
                                             opt_state, params,
                                             lr_schedule(step))
        target, updates = dqn_sync_target(target, params, updates,
                                          hp.target_sync)
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        # the |TD| batch signal for prioritized replay
        metrics["td_abs"] = metrics["loss"].sqrt()
        metrics["reward_sum"] = traj.reward.sum()
        metrics["episodes"] = traj.done.sum()
        return params, opt_state, target, updates, metrics

    if not fused_publish:
        return _update

    def learner_step(params, opt_state, target, updates, traj, last_obs,
                     step, publish_dst):
        params, opt_state, target, updates, metrics = _update(
            params, opt_state, target, updates, traj, last_obs, step)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(publish_dst), tree_leaves(params)):
                dst.copy_(src)
        return params, opt_state, target, updates, publish_dst, metrics

    return learner_step


class SyncReplayDQN:
    """Synchronous replay-DQN reference driver (the bitwise pin's baseline).

    ``ParallelRL``'s API (``run(iterations) -> RunResult``) over exactly
    the components the replay-plane ``PipelinedRL`` schedules
    asynchronously: ``make_dqn_collect_fn``, a ``ReplayRing`` seeded
    identically and ``make_dqn_learner_step`` — executed serially on the
    calling thread, one collect → ``put`` → ``get`` (sample) → update an
    iteration. A depth-1 lockstep pipelined run with the same seed and
    replay shape reproduces it *bit for bit*: the generator layout
    (``init_rl_common``), the ε index a rollout, the ring's sample stream
    and the update are shared, so the pipeline adds only scheduling.
    """

    def __init__(self, env, agent, *, optimizer: str = "rmsprop",
                 lr_schedule=None, seed: int = 0, replay_capacity: int = 64,
                 replay_batch: int = 1, prioritized: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.env = env
        self.agent = agent
        (self.optimizer, self.lr_schedule, self.act_generator,
         self.env_generator, self.params, self.opt_state) = init_rl_common(
             env, agent, optimizer, lr_schedule, seed, self.device)
        self.env_state = env.reset(self.env_generator)
        self.obs = env.observe(self.env_state)
        # a learner-private copy, as the pipeline keeps its own
        self._target = _copy_tree(self.params)
        self._updates = 0
        self._seed = seed
        self._capacity = replay_capacity
        self._batch = replay_batch
        self._prioritized = prioritized
        self._collect = make_dqn_collect_fn(agent, env, agent.hp.t_max)
        self._update_step = make_dqn_learner_step(agent, self.optimizer,
                                                  self.lr_schedule)
        self.total_steps = 0
        self._rollouts = 0  # lifetime rollout counter: the ε-schedule index
        self._steps_per_iter = env.n_envs * agent.hp.t_max
        self.ring: Optional[ReplayRing] = None  # per run; kept for inspection

    def run(self, iterations: int, log_every: int = 0) -> RunResult:
        del log_every
        # a fresh ring a run, like the pipeline's queue a run: the sample
        # stream is a pure function of (seed, consume index within the run)
        self.ring = ReplayRing(
            capacity=self._capacity, batch_size=self._batch, producers=1,
            prioritized=self._prioritized, sample_seed=self._seed,
            device=self.device)
        acc = MetricsAccumulator(lazy=not self._prioritized)
        # the schedule's step restarts at total_steps on every run, as in
        # ParallelRL.run
        step = self.total_steps
        for _ in range(iterations):
            i = self._rollouts
            self.env_state, self.obs, traj = self._collect(
                self.params, self.env_state, self.obs, self.act_generator,
                self.env_generator, i)
            self._rollouts = i + 1
            self.ring.put(Rollout(traj, self.obs, behavior_version=i,
                                  actor_id=0, seq=i))
            payload = self.ring.get()
            (self.params, self.opt_state, self._target, self._updates,
             metrics) = self._update_step(
                self.params, self.opt_state, self._target, self._updates,
                payload.traj, payload.last_obs, step)
            if self._prioritized:
                self.ring.update_priorities(
                    self.ring.last_sampled,
                    [float(metrics["td_abs"])] * len(self.ring.last_sampled))
            step += 1
            self.total_steps += self._steps_per_iter
            acc.update(metrics)
        return acc.result(self.total_steps, self._steps_per_iter)
