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

``make_sharded_learner_step`` is the mesh plane's twin: the same update
on a batch split over the lanes of a ``RolloutMesh``. Lane ``i`` computes
its bootstrap, its loss (V-trace through K2, or n-step through K1 at
ρ̄ = c̄ = ∞) and its backward on its own device with its own param
replica; the lanes' shards are equal, so the global batch mean is the
mean of the lanes' means, and each lane's loss is scaled by 1/D before
its backward. The partial gradients are summed in lane order on lane 0's
device, and only then clipped at the global norm (inside
``optimizer.update``) and applied: one RMSProp update on shared
statistics, as the reference's all-reduce followed by its replicated
update. The new params are copied to every lane's replica. One process,
one learner thread: no process group. At D = 1 the step is
``make_learner_step``'s, bit for bit.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.agents.paac import (paac_losses, trajectory_forward,
                                          trajectory_logits_values)
from repro_torch.core.returns import vtrace_returns
from repro_torch.distributed.sharding import replicated_sharding
from repro_torch.utils.tree import tree_leaves, tree_unflatten

__all__ = ["make_learner_step", "make_sharded_learner_step"]


def _make_grad_fn(agent, rho_bar: float, c_bar: float) -> Callable:
    """``grad_fn(params, traj, last_obs, scale=1) -> (grads, metrics)``:
    the bootstrap under ``params``, the loss (``scale`` times it, when not
    1, goes into the backward) and its gradients, leaf for leaf in
    ``tree_leaves(params)`` order, with the update's metrics."""
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

    def grad_fn(params, traj, last_obs, scale: float = 1.0):
        with torch.no_grad():  # V(s_{tmax+1}) under the learner's params
            _, bootstrap = act(params, last_obs)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics, rho = loss_fn(tree_unflatten(params, leaves), traj,
                                         bootstrap)
            grads = torch.autograd.grad(loss if scale == 1.0
                                        else loss * scale, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["rho_mean"] = rho.mean()
        metrics["rho_clip_frac"] = (rho > rho_bar).float().mean()
        metrics["c_clip_frac"] = (rho > c_bar).float().mean()
        metrics["loss"] = loss.detach()
        metrics["reward_sum"] = traj.reward.sum()
        metrics["episodes"] = traj.done.sum()
        return grads, metrics

    return grad_fn


def _publish(publish_dst, params) -> None:
    """The new params copied over the stale ping-pong buffer, in place."""
    with torch.no_grad():
        for dst, src in zip(tree_leaves(publish_dst), tree_leaves(params)):
            dst.copy_(src)


def make_learner_step(agent, optimizer, lr_schedule, rho_bar: float = 1.0,
                      c_bar: float = 1.0,
                      fused_publish: bool = False) -> Callable:
    """Build the pipelined learner's update step for a PAAC agent.

    ``fused_publish=False`` (default): the plain update. ``fused_publish=
    True``: the extra ``publish_dst`` argument and ``published`` output of
    the module docstring.
    """
    grad_fn = _make_grad_fn(agent, rho_bar, c_bar)

    def _update(params, opt_state, traj, last_obs, step):
        grads, metrics = grad_fn(params, traj, last_obs)
        params, opt_state = optimizer.update(tree_unflatten(params, grads),
                                             opt_state, params,
                                             lr_schedule(step))
        return params, opt_state, metrics

    if not fused_publish:
        return _update

    def learner_step(params, opt_state, traj, last_obs, step, publish_dst):
        params, opt_state, metrics = _update(params, opt_state, traj,
                                             last_obs, step)
        # bitwise snapshot for the actors, written over the stale buffer
        _publish(publish_dst, params)
        return params, opt_state, publish_dst, metrics

    return learner_step


def _on_device(device):
    """Make ``device`` current while a lane's work is issued (on the CPU,
    nothing): a kernel wrapper that launches on ``current_stream()`` then
    takes the lane device's stream."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


# the metrics that are sums over the batch; every other one is a batch mean
_SUMMED = ("reward_sum", "episodes")


def make_sharded_learner_step(agent, optimizer, lr_schedule, mesh,
                              rho_bar: float = 1.0, c_bar: float = 1.0,
                              fused_publish: bool = True) -> Callable:
    """The mesh plane's twin of ``make_learner_step`` over ``mesh`` (a
    ``repro_torch.launch.mesh.RolloutMesh`` of D lanes).

    ``(replicas, opt_state, traj, last_obs, step[, publish_dst]) ->
    (replicas, opt_state[, published], metrics)``: ``replicas`` holds one
    param tree a lane, lane ``i``'s on ``mesh.devices[i]``, and lane 0's is
    the learner's; ``traj`` and ``last_obs`` hold one part a lane, lane
    ``i``'s on its device (``MeshTrajectoryRing.get``'s ``Lanes``);
    ``opt_state`` lives on lane 0's device; ``publish_dst`` holds one stale
    ping-pong tree a lane. The math is ``make_learner_step``'s on the
    lanes' parts put side by side along the env axis (module docstring);
    the metrics are global: batch means averaged over the lanes, sums
    summed, in lane order on lane 0's device. The update issues each
    lane's work with the lane's device current, on that device's current
    stream.
    """
    devices = list(mesh.devices)
    D, dev0 = len(devices), devices[0]
    grad_fn = _make_grad_fn(agent, rho_bar, c_bar)
    replicate = replicated_sharding(mesh)

    def _update(replicas, opt_state, traj, last_obs, step):
        if not len(replicas) == len(traj) == len(last_obs) == D:
            raise ValueError(
                f"the sharded step runs {D} lanes; got {len(replicas)} "
                f"replicas and {len(traj)}/{len(last_obs)} trajectory parts")
        grads, metrics = None, None
        for i, d in enumerate(devices):
            with _on_device(d):
                # equal shards: the global mean is the mean of the lanes'
                g_i, m_i = grad_fn(replicas[i], traj[i], last_obs[i],
                                   1.0 / D)
            if i == 0:
                grads, metrics = list(g_i), m_i
                continue
            # lane order, on lane 0's device: the reduction the reference's
            # all-reduce makes, before the clip
            grads = [a + b.to(dev0) for a, b in zip(grads, g_i)]
            metrics = {k: v + m_i[k].to(dev0) for k, v in metrics.items()}
        if D > 1:
            metrics = {k: v if k in _SUMMED else v / D
                       for k, v in metrics.items()}
        p0 = replicas[0]
        with _on_device(dev0):
            p0, opt_state = optimizer.update(tree_unflatten(p0, grads),
                                             opt_state, p0, lr_schedule(step))
        # the replicated output: lane i's copy (a lane on lane 0's device
        # shares lane 0's tensors, which no update writes in place)
        return replicate.split(p0), opt_state, metrics

    if not fused_publish:
        return _update

    def learner_step(replicas, opt_state, traj, last_obs, step, publish_dst):
        replicas, opt_state, metrics = _update(replicas, opt_state, traj,
                                               last_obs, step)
        for d, dst, src in zip(devices, publish_dst, replicas):
            with _on_device(d):
                _publish(dst, src)
        return replicas, opt_state, publish_dst, metrics

    return learner_step
