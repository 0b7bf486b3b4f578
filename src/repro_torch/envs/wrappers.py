"""Environment wrappers (paper §5.1 pipeline pieces)."""
from __future__ import annotations

import torch

from repro_torch.envs.base import VectorEnv, where_rows


class FrameStack(VectorEnv):
    """Stack the last ``n`` observations along a trailing channel axis.

    Converts (n_e, H, W) frames into (n_e, H, W, n) — the input format of the
    paper's CNNs (84×84×4), channels last as in ``repro``.
    """

    def __init__(self, env: VectorEnv, n: int = 4):
        super().__init__(env.n_envs, env.device)
        self.env = env
        self.n = n
        self.obs_shape = tuple(env.obs_shape) + (n,)
        self.num_actions = env.num_actions

    def _repeat(self, frame):
        return frame[..., None].expand(frame.shape + (self.n,))

    def reset(self, generator):
        inner = self.env.reset(generator)
        stack = self._repeat(self.env.observe(inner)).contiguous()
        return {"inner": inner, "stack": stack}

    def observe(self, state):
        return state["stack"]

    def step(self, state, actions, generator):
        inner, obs, reward, done = self.env.step(state["inner"], actions,
                                                 generator)
        stack = torch.cat([state["stack"][..., 1:], obs[..., None]], dim=-1)
        # reset the stack of finished episodes (no cross-episode leakage)
        stack = where_rows(done, self._repeat(obs), stack)
        return {"inner": inner, "stack": stack}, stack, reward, done

    # the raw-transition hook is unused (``step`` is overridden)
    def _step_batch(self, state, actions, generator):
        raise NotImplementedError
