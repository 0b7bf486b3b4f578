"""PPO inside the PAAC framework — a beyond-paper extension (the port of
``repro/core/agents/ppo.py``).

The paper argues its framework hosts "any other reinforcement learning
algorithm" (§4). PAAC-A2C takes one gradient step per batch; PPO's clipped
surrogate allows several epochs over the same synchronous batch — a natural
fit because the framework already stores acting-time log-probs in the
trajectory (``rollout.Transition.logp``). Uses GAE
(``returns.gae_advantages``). It draws from the generators as PAAC does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.agents.base import Agent
from repro_torch.core.returns import gae_advantages
from repro_torch.core.rollout import rollout
from repro_torch.models import policy_apply
from repro_torch.utils.tree import tree_leaves, tree_unflatten


class PPOConfig(NamedTuple):
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    entropy_beta: float = 0.01
    value_coef: float = 0.5
    t_max: int = 16
    epochs: int = 4


def ppo_loss(params, cfg, hp: PPOConfig, traj, adv, returns):
    """The clipped surrogate, value and entropy terms over a time-major
    trajectory and its (T, E) advantages and returns. Advantages are
    normalised with the population std (``correction=0``), as ``jnp.std``
    computes it. Returns ``(total, metrics)``."""
    T, E = traj.action.shape
    obs = traj.obs.reshape((T * E,) + tuple(traj.obs.shape[2:]))
    logits, values, _ = policy_apply(params, cfg, obs)
    logp_all = F.log_softmax(logits, dim=-1)
    actions = traj.action.reshape(T * E)
    logp = logp_all.gather(1, actions[:, None])[:, 0]
    ratio = torch.exp(logp - traj.logp.reshape(T * E))
    a = adv.reshape(T * E)
    a = (a - a.mean()) / (a.std(correction=0) + 1e-8)
    unclipped = ratio * a
    clipped = torch.clamp(ratio, 1 - hp.clip_eps, 1 + hp.clip_eps) * a
    policy_loss = -torch.minimum(unclipped, clipped).mean()
    value_loss = (returns.reshape(T * E) - values).square().mean()
    entropy = -(logp_all.exp() * logp_all).sum(dim=-1).mean()
    total = policy_loss + hp.value_coef * value_loss - hp.entropy_beta * entropy
    return total, {
        "policy_loss": policy_loss.detach(),
        "value_loss": value_loss.detach(),
        "entropy": entropy.detach(),
        "clip_frac": ((ratio - 1).abs() > hp.clip_eps).float().mean().detach(),
    }


class PPOAgent(Agent):
    on_policy = True

    def __init__(self, cfg, hp: PPOConfig = PPOConfig()):
        self.cfg = cfg
        self.hp = hp

    def act_fn(self):
        cfg = self.cfg

        def fn(params, obs):
            logits, value, _ = policy_apply(params, cfg, obs)
            return logits, value

        return fn

    def make_update_step(self, optimizer, lr_schedule):
        """``update(params, opt_state, traj, bootstrap, step) -> (params,
        opt_state, metrics)``: GAE over the trajectory, then ``epochs``
        gradient steps on it; the metrics are the last epoch's."""
        cfg, hp = self.cfg, self.hp

        def update(params, opt_state, traj, bootstrap, step):
            adv, returns = gae_advantages(traj.reward, traj.done, traj.value,
                                          bootstrap, hp.gamma, hp.lam)
            lr = lr_schedule(step)
            for _ in range(hp.epochs):
                leaves = [p.detach().requires_grad_(True)
                          for p in tree_leaves(params)]
                with torch.enable_grad():
                    loss, metrics = ppo_loss(tree_unflatten(params, leaves),
                                             cfg, hp, traj, adv, returns)
                    grads = torch.autograd.grad(loss, leaves)
                params, opt_state = optimizer.update(
                    tree_unflatten(params, grads), opt_state, params, lr)
            return params, opt_state, dict(metrics, loss=loss.detach())

        return update

    def make_train_step(self, env, optimizer, lr_schedule):
        hp = self.hp
        act = self.act_fn()
        update = self.make_update_step(optimizer, lr_schedule)

        def train_step(params, opt_state, env_state, obs, act_generator,
                       env_generator, step, actions=None):
            env_state, last_obs, traj = rollout(
                act, env, params, env_state, obs, act_generator,
                env_generator, hp.t_max, actions=actions)
            with torch.no_grad():
                _, bootstrap = act(params, last_obs)
            params, opt_state, metrics = update(params, opt_state, traj,
                                                bootstrap, step)
            metrics["reward_sum"] = traj.reward.sum()
            metrics["episodes"] = traj.done.sum()
            return params, opt_state, env_state, last_obs, metrics

        return train_step
