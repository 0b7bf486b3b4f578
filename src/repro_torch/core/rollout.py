"""The master loop — paper Algorithm 1 lines 4–10.

One step of ``rollout`` is one framework timestep:

  1. the *master* evaluates the policy for ALL ``n_e`` environments in one
     batched forward (line 5-6),
  2. actions are sampled per environment (independent categorical draws,
     Gumbel-max from an explicit generator),
  3. the *workers* apply all actions in parallel (line 7-10) — here the
     batched env step on the same device.

Acting runs under ``torch.no_grad()``: the learning pass recomputes the
forward with gradients.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.utils.sampling import categorical


class Transition(NamedTuple):
    obs: torch.Tensor  # (T, E, *obs_shape)
    action: torch.Tensor  # (T, E) int64
    reward: torch.Tensor  # (T, E) float32
    done: torch.Tensor  # (T, E) bool
    value: torch.Tensor  # (T, E) — V(s_t) computed during acting (line 6)
    logp: torch.Tensor  # (T, E) — log π(a_t|s_t) at acting time


def behaviour_logp(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """log π(a|s) = logits[a] − logsumexp(logits), from the sampled action's
    logit alone (no (E, A) log_softmax is materialized)."""
    picked = logits.gather(1, action[:, None])[:, 0]
    return picked - torch.logsumexp(logits, dim=1)


@torch.no_grad()
def rollout(act_fn: Callable,  # (params, obs) -> (logits (E,A), value (E,))
            env, params, env_state, obs,
            act_generator: torch.Generator, env_generator: torch.Generator,
            t_max: int, *, actions: Optional[torch.Tensor] = None):
    """Collect ``t_max`` steps from all n_e environments.

    Actions are drawn from ``act_generator``; the env steps draw from
    ``env_generator``. ``actions`` (T, E), if given, replaces the draws:
    a test seam that replays another run's actions.

    Returns (env_state, last_obs, traj: Transition [time-major]).
    """
    steps = []
    for t in range(t_max):
        logits, value = act_fn(params, obs)
        action = (categorical(logits, act_generator) if actions is None
                  else actions[t].to(device=logits.device, dtype=torch.int64))
        logp = behaviour_logp(logits, action)
        env_state, next_obs, reward, done = env.step(env_state, action,
                                                     env_generator)
        steps.append((obs, action, reward, done, value, logp))
        obs = next_obs
    traj = Transition(*(torch.stack(x) for x in zip(*steps)))
    return env_state, obs, traj


def make_collect_fn(act_fn: Callable, env, t_max: int) -> Callable:
    """The acting half of Algorithm 1, detached from the learning half:
    ``collect(params, env_state, obs, act_generator, env_generator,
    actions=None) -> (env_state, last_obs, traj)``."""

    def collect(params, env_state, obs, act_generator, env_generator,
                actions=None):
        return rollout(act_fn, env, params, env_state, obs, act_generator,
                       env_generator, t_max, actions=actions)

    return collect
