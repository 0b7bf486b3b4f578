"""AtariLike: a procedural 84×84 pixel game standing in for ALE.

A port of ``repro.envs.atari_like``, batched over n_e on the env's device.
The game ("CatchPixels"): a ball falls from the top at a random column with
random horizontal drift and bounces off walls; the agent moves a paddle
along the bottom row. +1 for a catch, -1 for a miss; episode = ``lives``
balls. The physics is int32, as in the reference, and the ball respawns
from the step's draws only when it reaches the bottom, so a transition
without a spawn matches the reference frame for frame.

The paper's pre-processing pipeline (§5.1) is built in:
* action repeat 4 (the frame rendered after the repeat covers the sprites'
  travel cells, which stands for the per-pixel max of the last two frames),
* frame stack of 4 (the wrapper in ``wrappers.py``),
* 1–30 random no-op actions after reset.

The no-op start is looked up, not stepped. A no-op frame from a fresh spawn
moves only the ball: the paddle holds (action 1 adds nothing), and the ball
falls 2 rows a frame from row 0, so within ``max_noops`` < 40 frames it
never reaches the bottom row and no life, reward or respawn happens. The
state after n no-op frames is then a function of (n, spawn column, spawn
drift) alone; ``__init__`` tabulates it once with the same frame function
the physics uses, and ``reset`` gathers from the table. The reset that the
auto-reset computes for every row on every step so costs a few launches
instead of ~30 physics frames of them.
"""
from __future__ import annotations

import torch

from repro_torch.envs.base import VectorEnv

SIZE = 84
PADDLE_W = 8
BALL = 3  # ball sprite size
ROW_BOTTOM = SIZE - 4
FALL = 2  # rows a frame of a freshly spawned ball


def _bounce(col, vx):
    """One frame of horizontal motion: move, reverse off a side wall, clip."""
    col = col + vx
    vx = torch.where((col <= BALL) | (col >= SIZE - BALL), -vx, vx)
    return col.clamp(BALL, SIZE - BALL), vx


class AtariLike(VectorEnv):
    obs_shape = (SIZE, SIZE)
    num_actions = 3  # left, stay, right

    def __init__(self, n_envs: int, lives: int = 5, action_repeat: int = 4,
                 max_noops: int = 30, device="cuda"):
        super().__init__(n_envs, device)
        if FALL * max_noops >= ROW_BOTTOM:
            raise ValueError(f"max_noops {max_noops}: a no-op start that "
                             "long reaches the bottom row, which the tabulated "
                             f"start does not model (at most "
                             f"{(ROW_BOTTOM - 1) // FALL})")
        self.lives = lives
        self.action_repeat = action_repeat
        self.max_noops = max_noops
        self._idx = torch.arange(SIZE, dtype=torch.int32, device=self.device)
        # (max_noops + 1, columns BALL..SIZE-BALL, drifts -2..2): the column
        # and drift after n no-op frames
        col, vx = torch.meshgrid(
            torch.arange(BALL, SIZE - BALL + 1, dtype=torch.int32),
            torch.arange(-2, 3, dtype=torch.int32), indexing="ij")
        cols, vxs = [col], [vx]
        for _ in range(max_noops):
            col, vx = _bounce(col, vx)
            cols.append(col)
            vxs.append(vx)
        self._noop_col = torch.stack(cols).to(self.device)
        self._noop_vx = torch.stack(vxs).to(self.device)

    def _spawn_ball(self, generator):
        n, kw = self.n_envs, dict(generator=generator, device=self.device,
                                  dtype=torch.int32)
        col = torch.randint(BALL, SIZE - BALL, (n,), **kw)
        vx = torch.randint(-2, 3, (n,), **kw)  # -2..2 horizontal drift
        return torch.stack([torch.zeros_like(col), col,
                            torch.full_like(col, FALL), vx], dim=1)

    def reset(self, generator):
        n, kw = self.n_envs, dict(generator=generator, device=self.device,
                                  dtype=torch.int32)
        state = {
            "ball": self._spawn_ball(generator),  # (row, col, vy, vx)
            "paddle": torch.randint(PADDLE_W, SIZE - PADDLE_W, (n,), **kw),
            "lives": torch.full((n,), self.lives, dtype=torch.int32,
                                device=self.device),
        }
        # paper §5.1: 1..30 no-op actions before handing control to the agent
        n_noops = torch.randint(1, self.max_noops + 1, (n,), **kw)
        return self.noop_start(state, n_noops)

    def noop_start(self, state, n_noops):
        """``state`` (fresh spawns) after ``n_noops`` (n,) no-op frames each:
        what the reference's ``fori_loop`` of ``_physics`` with action 1
        gives."""
        ball = state["ball"]
        n, c0, v0 = n_noops.long(), (ball[:, 1] - BALL).long(), (ball[:, 3] + 2).long()
        ball = torch.stack([ball[:, 0] + ball[:, 2] * n_noops,
                            self._noop_col[n, c0, v0], ball[:, 2],
                            self._noop_vx[n, c0, v0]], dim=1)
        return {"ball": ball, "paddle": state["paddle"], "lives": state["lives"]}

    def _physics(self, state, action, generator):
        """One raw emulator frame; ``action`` is int32."""
        paddle = (state["paddle"] + (action - 1) * 3).clamp(PADDLE_W,
                                                            SIZE - PADDLE_W)
        row, col, vy, vx = state["ball"].unbind(1)
        row = row + vy
        col, vx = _bounce(col, vx)
        at_bottom = row >= ROW_BOTTOM
        caught = at_bottom & ((col - paddle).abs() <= PADDLE_W)
        reward = torch.where(at_bottom, torch.where(caught, 1.0, -1.0), 0.0)
        lives = state["lives"] - at_bottom.to(torch.int32)
        ball = torch.where(at_bottom[:, None], self._spawn_ball(generator),
                           torch.stack([row, col, vy, vx], dim=1))
        new_state = {"ball": ball, "paddle": paddle, "lives": lives}
        return new_state, reward, lives <= 0

    def render(self, state):
        """(n, 84, 84) float32 frames: ball and paddle sprites on black."""
        idx = self._idx[None, :]
        ball_r, ball_c = state["ball"][:, 0, None], state["ball"][:, 1, None]
        ball_rows = (idx - ball_r).abs() <= BALL // 2
        ball_cols = (idx - ball_c).abs() <= BALL // 2
        paddle_cols = (idx - state["paddle"][:, None]).abs() <= PADDLE_W
        paddle_rows = self._idx >= ROW_BOTTOM
        frame = ((ball_rows[:, :, None] & ball_cols[:, None, :])
                 | (paddle_rows[None, :, None] & paddle_cols[:, None, :]))
        return frame.float()

    def observe(self, state):
        return self.render(state)

    def _step_batch(self, state, actions, generator):
        """Action repeat 4; the post-repeat frame stands for the per-pixel
        max of the two latest frames, as in the reference."""
        action = actions.to(torch.int32)
        total_r = torch.zeros((self.n_envs,), device=self.device)
        done_any = torch.zeros((self.n_envs,), dtype=torch.bool,
                               device=self.device)
        for _ in range(self.action_repeat):
            state, r, d = self._physics(state, action, generator)
            total_r = total_r + r
            done_any = done_any | d
        return state, total_r, done_any
