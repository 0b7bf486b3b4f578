"""Deterministic emulations of the baselines the paper compares against
(the port of ``repro/core/agents/baselines.py``).

The paper's argument (§1, §3) is that PAAC avoids two specific failure
modes, reproduced here *as controlled pathologies* so that runs can compare
convergence:

* **A3C-sim** — stale gradients: gradients are computed w.r.t. a parameter
  copy that lags ``delay`` updates behind (gradients "computed w.r.t. stale
  parameters while updates applied to a new parameter set", fn.1). Updates
  remain sequential (lock-free write races are not representable
  deterministically).
* **GA3C-sim** — policy lag: actions are selected with a parameter copy that
  lags ``delay`` updates behind the learner (GA3C's queue between predictor
  and trainer), so learning is slightly off-policy exactly as described in
  Babaeizadeh et al. 2016.

``delay`` = 1 refreshes the copy after every update and recovers exact
PAAC — a clean ablation axis. The update is PAAC's (n-step returns through
K1 on the card), and it draws from the generators as PAAC does. The stale
copy is a reference to an earlier parameter tree, which stays as it was
because the optimizers return new tensors and never write into old ones.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.agents.paac import PAACAgent, PAACConfig, loss_and_grads


class LaggedConfig(NamedTuple):
    gamma: float = 0.99
    entropy_beta: float = 0.01
    t_max: int = 5
    value_coef: float = 0.5
    delay: int = 4  # parameter-copy staleness in updates


class LaggedPAACAgent(PAACAgent):
    """A2C with a lagging parameter copy.

    mode="grad"  -> A3C-sim  (gradient computed at stale params)
    mode="act"   -> GA3C-sim (actions sampled from stale params)
    """

    def __init__(self, cfg, hp: LaggedConfig = LaggedConfig(),
                 mode: str = "grad"):
        super().__init__(cfg, PAACConfig(hp.gamma, hp.entropy_beta, hp.t_max,
                                         hp.value_coef))
        if mode not in ("grad", "act"):
            raise ValueError(f"mode must be 'grad' or 'act', got {mode!r}")
        self.lag_hp = hp
        self.mode = mode

    def init_state(self, params):
        return {"stale": params, "since": 0}

    def make_lagged_update(self, optimizer, lr_schedule):
        """``update(params, opt_state, agent_state, traj, bootstrap, step) ->
        (params, opt_state, agent_state, metrics)``: the gradient at the
        stale copy ("grad") or at the params ("act"), applied to the params;
        then the copy's refresh every ``delay`` updates."""
        cfg, hp, lag, mode = self.cfg, self.hp, self.lag_hp, self.mode

        def update(params, opt_state, agent_state, traj, bootstrap, step):
            stale = agent_state["stale"]
            grad_params = stale if mode == "grad" else params
            loss, metrics, grads = loss_and_grads(grad_params, cfg, hp, traj,
                                                  bootstrap)
            # the update is applied to the CURRENT params (the inconsistency)
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 lr_schedule(step))
            since = agent_state["since"] + 1
            if since >= lag.delay:
                stale, since = params, 0
            metrics["loss"] = loss
            return params, opt_state, {"stale": stale, "since": since}, metrics

        return update

    def make_train_step(self, env, optimizer, lr_schedule):
        collect = self.make_collect_step(env)
        update = self.make_lagged_update(optimizer, lr_schedule)
        mode = self.mode

        def train_step(params, opt_state, agent_state, env_state, obs,
                       act_generator, env_generator, step, actions=None):
            acting_params = agent_state["stale"] if mode == "act" else params
            env_state, last_obs, traj, bootstrap = collect(
                acting_params, env_state, obs, act_generator, env_generator,
                actions)
            params, opt_state, agent_state, metrics = update(
                params, opt_state, agent_state, traj, bootstrap, step)
            metrics["reward_sum"] = traj.reward.sum()
            metrics["episodes"] = traj.done.sum()
            return params, opt_state, agent_state, env_state, last_obs, metrics

        return train_step
