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
trajectory from elsewhere.

``make_llm_train_step`` is the trajectory-batch form for the token
policies: the batch is {tokens (B, T+1), rewards (B, T), dones (B, T)},
one sequence one actor's trajectory, and one call is the learning forward
with gradients (K3 and its backward in every attention layer, K6 and its
backward in every Mamba2 layer), the n-step returns (K1), the losses with
the MoE aux loss, the backward and one optimizer update. Token policies
act on their last position.
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
    moe_aux_coef: float = 0.01


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
    if cfg.family != "cnn":  # token policies: the last position
        logits, values = logits[:, -1], values[:, -1]
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
    def loss_fn(p):
        logits, values, actions, returns = trajectory_forward(
            p, cfg, hp, traj, bootstrap)
        return paac_losses(logits, values, actions, returns,
                           hp.entropy_beta, hp.value_coef)

    return value_and_grad(loss_fn, params)


def value_and_grad(loss_fn, params):
    """``loss_fn(params) -> (loss, metrics)`` and the loss's gradient with
    respect to every parameter. Returns ``(loss, metrics, grads)``: 0-d
    tensors and a tree shaped like ``params``, all without a graph."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def returns_through_bootstrap(rewards, dones, bootstrap, gamma: float):
    """Batch-major n-step returns (B, T) of rewards/dones (B, T) from
    ``bootstrap`` (B,) through K1, with the gradient the reference's
    autodiff of its scan gives the bootstrap: dR_t/db = prod over s >= t of
    gamma (1 - done_s). K1 takes no input that needs a gradient, so it gets
    the bootstrap detached and that gradient rides on a term that is 0."""
    returns = n_step_returns(rewards.T, dones.T, bootstrap.detach(),
                             gamma)  # (T, B)
    if bootstrap.requires_grad:
        disc = gamma * (1.0 - dones.T.float())
        coef = torch.flip(torch.cumprod(torch.flip(disc, (0,)), 0), (0,))
        returns = returns + coef * (bootstrap - bootstrap.detach())
    return returns.T


def llm_loss(params, cfg, hp, batch):
    """The trajectory-batch PAAC loss of the reference's
    ``make_llm_train_step``: inputs tokens[:, :-1] and actions
    tokens[:, 1:], a vision trunk's text positions only, returns
    bootstrapped from the last value, ``paac_losses`` plus ``moe_aux_coef``
    times the MoE aux loss. Returns (loss, metrics)."""
    tokens = batch["tokens"]  # (B, T+1)
    inputs, actions = tokens[:, :-1], tokens[:, 1:]
    prefix = batch.get("prefix", batch.get("frames"))
    logits, values, aux = policy_apply(params, cfg, inputs, prefix,
                                       train=True)
    if cfg.prefix_len:  # score text positions only (vlm)
        logits = logits[:, cfg.prefix_len:]
        values = values[:, cfg.prefix_len:]
    B, T = actions.shape
    returns = returns_through_bootstrap(batch["rewards"], batch["dones"],
                                        values[:, -1], hp.gamma)
    total, metrics = paac_losses(
        logits.reshape(B * T, -1), values.reshape(B * T),
        actions.reshape(B * T).long(), returns.reshape(B * T),
        hp.entropy_beta, hp.value_coef)
    if "moe_aux" in aux:
        total = total + hp.moe_aux_coef * aux["moe_aux"]
    return total, metrics


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
            if cfg.family != "cnn":
                # token policies: obs is the token context; act on its last
                # position
                return logits[:, -1], value[:, -1]
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

    # -- trajectory-batch train step (token archs) ---------------------------
    def make_llm_train_step(self, optimizer, lr_schedule):
        """``train_step(params, opt_state, batch, step) -> (params,
        opt_state, metrics)``; ``batch`` holds ``tokens`` (B, T+1),
        ``rewards`` and ``dones`` (B, T), and ``prefix`` (a vision trunk's
        patch embeddings) or ``frames`` (an encoder-decoder's)."""
        cfg, hp = self.cfg, self.hp

        def train_step(params, opt_state, batch, step):
            loss, metrics, grads = value_and_grad(
                lambda p: llm_loss(p, cfg, hp, batch), params)
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 lr_schedule(step))
            metrics["loss"] = loss
            return params, opt_state, metrics

        return train_step
