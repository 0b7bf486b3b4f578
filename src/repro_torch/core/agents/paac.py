"""Parallel Advantage Actor-Critic — the paper's demonstrated instance (§4).

Losses are the paper's equations (10)–(11):

  ∇θ  ≈ 1/(n_e·t_max) Σ_e Σ_t (R_t − V(s_t)) ∇ log π(a_t|s_t) + β ∇ H(π)
  ∇θv ≈ ∇ 1/(n_e·t_max) Σ_e Σ_t (R_t − V(s_t))²

with the shared-trunk two-headed network of §5.1, RMSProp with shared
statistics and global-norm clipping at 40. One ``train_step`` call is one
full Algorithm-1 iteration: collect (rollout and the bootstrap value), then
update (the learning forward over all n_e·t_max frames with gradients,
n-step returns through K1, the losses, the backward and the optimizer).
The two halves are separate steps, so that an update can be fed a
trajectory from elsewhere. The token policies' trajectory-batch train step
(``make_llm_train_step``) comes with the token training path (ROADMAP
Queue 1 item 11).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.agents.base import Agent
from repro_torch.core.returns import n_step_returns
from repro_torch.core.rollout import make_collect_fn
from repro_torch.models import policy_apply
from repro_torch.utils.tree import tree_leaves, tree_unflatten


class PAACConfig(NamedTuple):
    gamma: float = 0.99
    entropy_beta: float = 0.01
    t_max: int = 5
    value_coef: float = 0.5


def paac_losses(logits, values, actions, returns, beta, value_coef,
                weights=None):
    """Equations (10) and (11), averaged over the n_e·t_max batch.

    logits: (N, A) fp32; values/returns: (N,); actions: (N,) int.
    weights: optional (N,) per-sample importance weights (no gradient);
    ``None`` is the paper's on-policy case (all ones).
    """
    logp = F.log_softmax(logits, dim=-1)
    logp_a = logp.gather(1, actions[:, None])[:, 0]
    adv = (returns - values).detach()
    w = 1.0 if weights is None else weights.detach()
    policy_loss = -(w * adv * logp_a).mean()
    entropy = -(logp.exp() * logp).sum(dim=-1).mean()
    value_loss = (w * (returns - values).square()).mean()
    total = policy_loss - beta * entropy + value_coef * value_loss
    return total, {
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy,
    }


def trajectory_logits_values(params, cfg, traj):
    """One batched learning-pass forward over a time-major ``Transition``.

    Returns ``(logits (N, A), values (N,))`` flattened time-major to the
    n_e·t_max batch (index = t·n_e + e).
    """
    T, E = traj.action.shape
    obs = traj.obs.reshape((T * E,) + tuple(traj.obs.shape[2:]))
    logits, values, _ = policy_apply(params, cfg, obs)
    return logits, values


def trajectory_forward(params, cfg, hp, traj, bootstrap):
    """Recompute the learning-pass forward over a time-major ``Transition``
    (never the acting-time values). Returns ``(logits, values, actions,
    returns)`` flattened to the n_e·t_max batch the paper's equations
    average over. K1 reads the trajectory time-major, so its (T, E) returns
    flatten to the same index t·n_e + e with no transposes."""
    T, E = traj.action.shape
    logits, values = trajectory_logits_values(params, cfg, traj)
    returns = n_step_returns(traj.reward, traj.done, bootstrap,
                             hp.gamma).reshape(T * E)
    actions = traj.action.reshape(T * E)
    return logits, values, actions, returns


def loss_and_grads(params, cfg, hp, traj, bootstrap):
    """The PAAC loss of ``traj`` and its gradient with respect to every
    parameter. ``bootstrap`` (E,) is V(s_{t_max+1}) without a gradient.
    Returns ``(loss, metrics, grads)``: 0-d tensors and a tree shaped like
    ``params``, all without a graph."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        logits, values, actions, returns = trajectory_forward(
            tree_unflatten(params, leaves), cfg, hp, traj, bootstrap)
        loss, metrics = paac_losses(logits, values, actions, returns,
                                    hp.entropy_beta, hp.value_coef)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


class PAACAgent(Agent):
    """The paper's agent. model cfg + hyperparameters -> steps."""

    on_policy = True

    def __init__(self, cfg, hp: PAACConfig = PAACConfig()):
        self.cfg = cfg
        self.hp = hp

    # -- acting --------------------------------------------------------------
    def act_fn(self):
        cfg = self.cfg

        def fn(params, obs):
            logits, value, _ = policy_apply(params, cfg, obs)
            return logits, value

        return fn

    # -- the two halves of an Algorithm-1 iteration --------------------------
    def make_collect_step(self, env):
        """``collect(params, env_state, obs, act_generator, env_generator,
        actions=None) -> (env_state, last_obs, traj, bootstrap)``."""
        act = self.act_fn()
        collect = make_collect_fn(act, env, self.hp.t_max)

        def collect_step(params, env_state, obs, act_generator, env_generator,
                         actions=None):
            env_state, last_obs, traj = collect(params, env_state, obs,
                                                act_generator, env_generator,
                                                actions)
            with torch.no_grad():
                _, bootstrap = act(params, last_obs)  # V(s_{tmax+1})
            return env_state, last_obs, traj, bootstrap

        return collect_step

    def make_update_step(self, optimizer, lr_schedule):
        """``update(params, opt_state, traj, bootstrap, step) -> (params,
        opt_state, metrics)``."""
        cfg, hp = self.cfg, self.hp

        def update(params, opt_state, traj, bootstrap, step):
            loss, metrics, grads = loss_and_grads(params, cfg, hp, traj,
                                                  bootstrap)
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 lr_schedule(step))
            metrics["loss"] = loss
            return params, opt_state, metrics

        return update

    # -- env-in-the-loop train step (Algorithm 1) ----------------------------
    def make_train_step(self, env, optimizer, lr_schedule):
        collect = self.make_collect_step(env)
        update = self.make_update_step(optimizer, lr_schedule)

        def train_step(params, opt_state, env_state, obs, act_generator,
                       env_generator, step):
            env_state, last_obs, traj, bootstrap = collect(
                params, env_state, obs, act_generator, env_generator)
            params, opt_state, metrics = update(params, opt_state, traj,
                                                bootstrap, step)
            metrics["reward_sum"] = traj.reward.sum()
            metrics["episodes"] = traj.done.sum()
            return params, opt_state, env_state, last_obs, metrics

        return train_step
