"""Catch (bsuite-style): a ball falls down a rows×cols board; the paddle on
the bottom row must catch it. Reward ±1 on the final row. Obs: flat board."""
from __future__ import annotations

import torch

from repro_torch.envs.base import VectorEnv


class Catch(VectorEnv):
    def __init__(self, n_envs: int, rows: int = 10, cols: int = 5,
                 device="cuda"):
        super().__init__(n_envs, device)
        self.rows, self.cols = rows, cols
        self.obs_shape = (rows * cols,)
        self.num_actions = 3  # left, stay, right
        self._r = torch.arange(rows, dtype=torch.int32, device=self.device)
        self._c = torch.arange(cols, dtype=torch.int32, device=self.device)
        self._fall = torch.tensor([1, 0], dtype=torch.int32, device=self.device)

    def reset(self, generator):
        n = self.n_envs
        col = torch.randint(0, self.cols, (n,), generator=generator,
                            device=self.device, dtype=torch.int32)
        return {"ball": torch.stack([torch.zeros_like(col), col], dim=1),
                "paddle": torch.full((n,), self.cols // 2, dtype=torch.int32,
                                     device=self.device)}

    def observe(self, state):
        r, c = self._r[None, :, None], self._c[None, None, :]
        ball, paddle = state["ball"], state["paddle"]
        board = (((r == ball[:, 0, None, None]) & (c == ball[:, 1, None, None]))
                 | ((r == self.rows - 1) & (c == paddle[:, None, None])))
        return board.float().reshape(ball.shape[0], -1)

    def _step_batch(self, state, actions, generator):
        paddle = (state["paddle"] + actions.to(torch.int32) - 1).clamp(
            0, self.cols - 1)
        ball = state["ball"] + self._fall
        done = ball[:, 0] >= self.rows - 1
        caught = ball[:, 1] == paddle
        reward = torch.where(done, torch.where(caught, 1.0, -1.0), 0.0)
        return {"ball": ball, "paddle": paddle}, reward, done
