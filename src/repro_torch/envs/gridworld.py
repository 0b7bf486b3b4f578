"""GridWorld: N×N grid, agent navigates to a goal.

Reward: +1 at goal (episode ends), -0.01 per step, timeout at ``max_steps``.
Observation: one-hot x/y of agent and goal (4N floats). Actions: 4 moves.
A fast-converging sanity environment for the PAAC learning tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.envs.base import VectorEnv


class GridWorld(VectorEnv):
    def __init__(self, n_envs: int, size: int = 5, max_steps: int = 50,
                 device="cuda"):
        super().__init__(n_envs, device)
        self.size = size
        self.max_steps = max_steps
        self.obs_shape = (4 * size,)
        self.num_actions = 4
        self._moves = torch.tensor([[0, 1], [0, -1], [1, 0], [-1, 0]],
                                   dtype=torch.int32, device=self.device)

    def reset(self, generator):
        n, kw = self.n_envs, dict(generator=generator, device=self.device,
                                  dtype=torch.int32)
        return {"pos": torch.randint(0, self.size, (n, 2), **kw),
                "goal": torch.randint(0, self.size, (n, 2), **kw),
                "t": torch.zeros((n,), dtype=torch.int32, device=self.device)}

    def observe(self, state):
        cells = torch.cat([state["pos"], state["goal"]], dim=1).long()
        return F.one_hot(cells, self.size).reshape(cells.shape[0], -1).float()

    def _step_batch(self, state, actions, generator):
        pos = (state["pos"] + self._moves[actions]).clamp(0, self.size - 1)
        at_goal = (pos == state["goal"]).all(dim=1)
        t = state["t"] + 1
        reward = torch.where(at_goal, 1.0, -0.01)
        done = at_goal | (t >= self.max_steps)
        return {"pos": pos, "goal": state["goal"], "t": t}, reward, done
