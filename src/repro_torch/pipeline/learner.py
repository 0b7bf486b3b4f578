"""The pipeline's learning half: V-trace-corrected PAAC update (a port of
``repro.pipeline.learner.make_learner_step``).

The learner consumes rollouts that may be several updates stale (up to
``queue_depth``, from any of the ``num_actors`` replicas). Following IMPALA
(Espeholt et al., 2018), the n-step targets are replaced by full V-trace:

    ρ_t = min(ρ̄, π_learner(a_t|s_t) / π_behaviour(a_t|s_t))
    c_t = min(c̄, π_learner(a_t|s_t) / π_behaviour(a_t|s_t))
    δ_t = ρ_t (r_t + γ_t V(s_{t+1}) − V(s_t))
    v_t = V(s_t) + δ_t + γ_t c_t (v_{t+1} − V(s_{t+1}))

with the behaviour log-prob recorded at acting time (``Transition.logp``),
values and the bootstrap recomputed under the *learner's* params, and the
policy gradient driven by ρ_t (r_t + γ_t v_{t+1} − V(s_t)). The targets
come from ``core.returns.vtrace_returns``: K2 on the card. The port feeds
it the time-major (T, E) tensors as they are, so the reference's five
transposes around the call (``repro/pipeline/learner.py:118-127``) go.

ρ̄ = c̄ = ∞ (literally ``float("inf")``) is the synchronous limit: the
correction is left out and the step computes the plain PAAC loss on
n-step returns — through ``trajectory_forward`` and K1, bit for bit the
synchronous update, which is how the lockstep tests pin the pipeline to
``ParallelRL``.

``make_learner_step`` returns
``(params, opt_state, traj, last_obs, step) -> (params, opt_state, metrics)``
— the learning half of ``PAACAgent.make_train_step`` with the rollout
replaced by a ring payload. With ``fused_publish=True`` the step also
writes the actor-facing snapshot:
``(params, opt_state, traj, last_obs, step, publish_dst) ->
(params, opt_state, published, metrics)``, where ``publish_dst`` is the
stale ping-pong buffer from ``PingPongParamSlot.reserve`` and
``published`` is that buffer after the new params were copied into it in
place (``copy_`` under ``no_grad``). The reference donates params, opt
state and that buffer to XLA; PyTorch has no donation, and needs none:
the learner's working params and optimizer state are new tensors each
update, private to the learner thread, and actors only ever see the two
published buffers.

The reference's ``make_sharded_learner_step`` (the mesh plane) waits for
ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.agents.paac import (paac_losses, trajectory_forward,
                                          trajectory_logits_values)
from repro_torch.core.returns import vtrace_returns
from repro_torch.utils.tree import tree_leaves, tree_unflatten

__all__ = ["make_learner_step"]


def make_learner_step(agent, optimizer, lr_schedule, rho_bar: float = 1.0,
                      c_bar: float = 1.0,
                      fused_publish: bool = False) -> Callable:
    """Build the pipelined learner's update step for a PAAC agent.

    ``fused_publish=False`` (default): the plain update. ``fused_publish=
    True``: the extra ``publish_dst`` argument and ``published`` output of
    the module docstring.
    """
    cfg, hp = agent.cfg, agent.hp
    act = agent.act_fn()
    # the infinite-clip (synchronous) limit takes the sync path's loss
    exact_sync = math.isinf(rho_bar) and math.isinf(c_bar)

    def _rho(logp_now, behaviour_logp):
        return torch.exp(logp_now.detach()
                         - behaviour_logp.reshape(logp_now.shape).float())

    def loss_sync(params, traj, bootstrap):
        # ρ̄ = c̄ = ∞: correction disabled — the paper's on-policy loss, the
        # same graph as the synchronous update (bitwise lockstep); ρ only
        # feeds the metrics
        logits, values, actions, returns = trajectory_forward(
            params, cfg, hp, traj, bootstrap)
        total, metrics = paac_losses(logits, values, actions, returns,
                                     hp.entropy_beta, hp.value_coef)
        with torch.no_grad():
            logp_now = F.log_softmax(logits, dim=-1).gather(
                1, actions[:, None])[:, 0]
        return total, metrics, _rho(logp_now, traj.logp)

    def loss_vtrace(params, traj, bootstrap):
        T, E = traj.action.shape
        logits, values = trajectory_logits_values(params, cfg, traj)
        actions = traj.action.reshape(T * E)
        logp_all = F.log_softmax(logits, dim=-1)
        logp_now = logp_all.gather(1, actions[:, None])[:, 0]
        rho = _rho(logp_now, traj.logp)
        # time-major (T, E) straight into K2: the flattened batch index is
        # t·E + e, so no transposes
        vs, pg_adv = vtrace_returns(traj.reward, traj.done,
                                    values.detach().reshape(T, E), bootstrap,
                                    rho.reshape(T, E), hp.gamma, rho_bar,
                                    c_bar)
        vs, pg_adv = vs.reshape(T * E), pg_adv.reshape(T * E)
        policy_loss = -(pg_adv * logp_now).mean()
        entropy = -(logp_all.exp() * logp_all).sum(dim=-1).mean()
        value_loss = (vs - values).square().mean()
        total = (policy_loss - hp.entropy_beta * entropy
                 + hp.value_coef * value_loss)
        return total, {"policy_loss": policy_loss, "value_loss": value_loss,
                       "entropy": entropy}, rho

    loss_fn = loss_sync if exact_sync else loss_vtrace

    def _update(params, opt_state, traj, last_obs, step):
        with torch.no_grad():  # V(s_{tmax+1}) under the learner's params
            _, bootstrap = act(params, last_obs)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics, rho = loss_fn(tree_unflatten(params, leaves), traj,
                                         bootstrap)
            grads = torch.autograd.grad(loss, leaves)
        params, opt_state = optimizer.update(tree_unflatten(params, grads),
                                             opt_state, params,
                                             lr_schedule(step))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["rho_mean"] = rho.mean()
        metrics["rho_clip_frac"] = (rho > rho_bar).float().mean()
        metrics["c_clip_frac"] = (rho > c_bar).float().mean()
        metrics["loss"] = loss.detach()
        metrics["reward_sum"] = traj.reward.sum()
        metrics["episodes"] = traj.done.sum()
        return params, opt_state, metrics

    if not fused_publish:
        return _update

    def learner_step(params, opt_state, traj, last_obs, step, publish_dst):
        params, opt_state, metrics = _update(params, opt_state, traj,
                                             last_obs, step)
        # bitwise snapshot for the actors, written over the stale buffer
        with torch.no_grad():
            for dst, src in zip(tree_leaves(publish_dst), tree_leaves(params)):
                dst.copy_(src)
        return params, opt_state, publish_dst, metrics

    return learner_step
