"""Vectorized environment API on tensors.

The paper maintains ``n_e`` environment instances stepped by ``n_w`` worker
threads (§3). Here, as in ``repro``, the whole vector of ``n_e`` instances
is one state — a dict of tensors with leading axis n_e, on the env's
device — and every step is a handful of batched tensor operations over all
of them: the "workers" are the lanes of those operations.

Contract:

* ``reset(generator) -> state``      state dict, leaves (n_e, ...)
* ``observe(state) -> obs``          (n_e, *obs_shape)
* ``step(state, actions, generator) -> (state, obs, reward, done)``
    - auto-resets finished instances (paper §5.1 restarts on terminal)
    - reward: (n_e,) float32 — done: (n_e,) bool flags the transition that
      ended an episode (reward is the pre-reset reward)

Every random draw comes from the explicit ``torch.Generator``, which lives
on the env's device. Nothing in a step waits for the device: finished rows
are replaced by masks, never by indexing with a host-side list.
"""
from __future__ import annotations

import abc
import copy
from typing import Tuple

import torch

from repro_torch.device import resolve_device


def narrow_vector_env(env: "VectorEnv", n_envs: int,
                      device=None) -> "VectorEnv":
    """A view of ``env`` batched over ``n_envs`` instances instead, and
    living on ``device`` when one is given.

    The vector API is shape-polymorphic, so a narrowed env is the same
    object graph with the batch width overridden — wrappers are narrowed
    recursively so e.g. a ``FrameStack`` delegates to an inner env of the
    matching width. With ``device``, the env's tables are copied there and
    everything it makes (states, observations, rewards) is made there: the
    mesh plane's lane ``i`` steps its own copy on its own device.
    """
    narrowed = copy.copy(env)
    narrowed.n_envs = n_envs
    if device is not None:
        narrowed.device = resolve_device(device)
        for name, value in vars(env).items():
            if isinstance(value, torch.Tensor):
                setattr(narrowed, name, value.to(narrowed.device))
    inner = getattr(env, "env", None)
    if isinstance(inner, VectorEnv):
        narrowed.env = narrow_vector_env(inner, n_envs, device)
    return narrowed


def where_rows(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Row r of the result is ``a[r]`` where ``mask[r]``, else ``b[r]``."""
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


class VectorEnv(abc.ABC):
    """Base class: subclasses implement the batched dynamics (``reset``,
    ``observe``, ``_step_batch``); this class adds the auto-reset."""

    obs_shape: Tuple[int, ...]
    num_actions: int

    def __init__(self, n_envs: int, device="cuda"):
        self.n_envs = n_envs
        self.device = resolve_device(device)

    @abc.abstractmethod
    def reset(self, generator):  # -> state of n_envs fresh instances
        ...

    @abc.abstractmethod
    def observe(self, state):  # -> obs
        ...

    @abc.abstractmethod
    def _step_batch(self, state, actions, generator):  # -> (state, reward, done)
        """One transition of every instance, without the auto-reset."""

    def step(self, state, actions, generator):
        new_state, reward, done = self._step_batch(state, actions, generator)
        # auto-reset finished instances: a fresh state for every row, kept
        # where done (as the reference's vmapped reset and where)
        fresh = self.reset(generator)
        new_state = {k: where_rows(done, fresh[k], v)
                     for k, v in new_state.items()}
        return new_state, self.observe(new_state), reward.float(), done
