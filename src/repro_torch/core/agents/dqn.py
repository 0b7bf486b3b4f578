"""DQN inside the PAAC framework — the paper's off-policy/value-based claim
(the port of ``repro/core/agents/dqn.py``).

The same master/worker machinery drives ε-greedy actors; experiences go to
replay memory and the synchronous update is a double-batched Q-learning step
with a periodically-synced target network (Mnih et al. 2015). The policy
head's logits are reused as Q-values (the framework's heads are just output
layers; §3: "the policy function can be represented implicitly, as in value
based methods").

One train step draws from the acting generator in a fixed order: for each
of the ``t_max`` env steps, first E uniforms (explore where u < ε), then E
random actions; after the last step, the ``batch_size`` replay indices. The
env steps draw from the env generator. The target network's copy and the
update counter live in the agent state; the counter is a host int, so the
step never reads a number back from the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.agents.base import Agent
from repro_torch.core.agents.replay import (replay_add, replay_init,
                                            replay_sample)
from repro_torch.models import policy_apply
from repro_torch.utils.tree import tree_leaves, tree_unflatten


class DQNConfig(NamedTuple):
    gamma: float = 0.99
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_steps: int = 10_000
    batch_size: int = 128
    target_sync: int = 100
    t_max: int = 5  # env steps per framework iteration (buffer fill rate)


class DQNDraws(NamedTuple):
    """A train step's acting-generator draws, for a test to inject."""
    u: torch.Tensor  # (t_max, E) uniforms: explore where u < ε
    rand: torch.Tensor  # (t_max, E) random actions
    idx: torch.Tensor  # (batch_size,) replay rows


def dqn_td_target(q_next, reward, done, gamma: float):
    """Double-batched Q-learning target: r + γ·(1−done)·max_a' Q_target.

    ``q_next`` is the *target network's* Q-values at the successor states
    (B, A); reward/done are (B,)."""
    return reward + gamma * (1.0 - done.to(torch.float32)) * q_next.amax(dim=-1)


def dqn_loss(params, target_params, batch, cfg, gamma: float):
    """TD MSE over a transition batch dict (obs/action/reward/next_obs/done),
    with no gradient through the target. Returns ``(loss, metrics)``."""
    q, _, _ = policy_apply(params, cfg, batch["obs"])
    q_a = q.gather(1, batch["action"].to(torch.int64)[:, None])[:, 0]
    with torch.no_grad():
        q_next, _, _ = policy_apply(target_params, cfg, batch["next_obs"])
        target = dqn_td_target(q_next, batch["reward"], batch["done"], gamma)
    td = target - q_a
    return td.square().mean(), {"q_mean": q_a.detach().mean()}


def dqn_sync_target(target, params, updates: int, target_sync: int):
    """Post-update target maintenance: ``updates + 1`` and a hard sync of
    the target tree every ``target_sync`` updates (Mnih et al. 2015). The
    synced target is ``params`` itself, which is safe because the
    optimizers return new tensors and never write into the old ones."""
    updates = updates + 1
    if updates % target_sync == 0:
        target = params
    return target, updates


class DQNAgent(Agent):
    on_policy = False

    def __init__(self, cfg, hp: DQNConfig = DQNConfig()):
        self.cfg = cfg
        self.hp = hp

    def act_fn(self):
        cfg = self.cfg

        def fn(params, obs):
            q, _, _ = policy_apply(params, cfg, obs)
            return q, q.amax(dim=-1)  # greedy value as "V"

        return fn

    def epsilon(self, step: int) -> float:
        """Linear ε schedule: ``eps_start → eps_end`` over ``eps_steps``
        train steps, clamped at both endpoints."""
        hp = self.hp
        frac = min(max(step / hp.eps_steps, 0.0), 1.0)
        return hp.eps_start + (hp.eps_end - hp.eps_start) * frac

    def init_state(self, capacity: int, obs_shape, params,
                   obs_dtype=torch.float32, *, device="cuda"):
        return {"replay": replay_init(capacity, obs_shape, obs_dtype,
                                      device=device),
                "target": params,
                "updates": 0}

    def make_update_step(self, optimizer, lr_schedule):
        """``update(params, opt_state, agent_state, batch, step) -> (params,
        opt_state, agent_state, metrics)``: one TD step on a replayed batch,
        then the target maintenance."""
        cfg, hp = self.cfg, self.hp

        def update(params, opt_state, agent_state, batch, step):
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            with torch.enable_grad():
                loss, metrics = dqn_loss(tree_unflatten(params, leaves),
                                         agent_state["target"], batch, cfg,
                                         hp.gamma)
                # the value head takes no part: its gradient is zero
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            params, opt_state = optimizer.update(
                tree_unflatten(params, grads), opt_state, params,
                lr_schedule(step))
            target, updates = dqn_sync_target(agent_state["target"], params,
                                              agent_state["updates"],
                                              hp.target_sync)
            agent_state = dict(agent_state, target=target, updates=updates)
            return params, opt_state, agent_state, dict(metrics,
                                                        loss=loss.detach())

        return update

    def make_train_step(self, env, optimizer, lr_schedule):
        hp = self.hp
        act = self.act_fn()
        update = self.make_update_step(optimizer, lr_schedule)

        def train_step(params, opt_state, agent_state, env_state, obs,
                       act_generator, env_generator, step,
                       draws: Optional[DQNDraws] = None):
            replay = agent_state["replay"]
            eps = self.epsilon(step)
            rewards, dones = [], []
            # ---- acting: ε-greedy master over all actors (lines 4-10) ----
            with torch.no_grad():
                for t in range(hp.t_max):
                    q, _ = act(params, obs)
                    greedy = q.argmax(dim=-1)
                    if draws is None:
                        u = torch.rand(greedy.shape, generator=act_generator,
                                       device=greedy.device)
                        rand = torch.randint(0, q.shape[-1], greedy.shape,
                                             generator=act_generator,
                                             device=greedy.device)
                    else:
                        u = draws.u[t].to(greedy.device)
                        rand = draws.rand[t].to(greedy.device, torch.int64)
                    action = torch.where(u < eps, rand, greedy)
                    env_state, next_obs, reward, done = env.step(
                        env_state, action, env_generator)
                    replay_add(replay, obs, action, reward, next_obs, done)
                    rewards.append(reward)
                    dones.append(done)
                    obs = next_obs
            # ---- synchronous batched update from replay ----
            batch = replay_sample(replay, act_generator, hp.batch_size,
                                  None if draws is None else draws.idx)
            params, opt_state, agent_state, metrics = update(
                params, opt_state, agent_state, batch, step)
            metrics["reward_sum"] = torch.stack(rewards).sum()
            metrics["episodes"] = torch.stack(dones).sum()
            return params, opt_state, agent_state, env_state, obs, metrics

        return train_step
