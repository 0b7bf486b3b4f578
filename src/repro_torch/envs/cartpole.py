"""CartPole with the standard Gym dynamics, batched on tensors (the port of
``repro/envs/cartpole.py``).

The state is fp32 and every step takes the reference's operations in the
reference's order, so one step from the same state agrees with it to the
last few bits (sin and cos may differ by an ulp between the libraries).
The limits are fp32 constants, as the reference's weakly typed Python
floats become when they meet its fp32 state.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.envs.base import VectorEnv


class CartPole(VectorEnv):
    obs_shape = (4,)
    num_actions = 2

    def __init__(self, n_envs: int, max_steps: int = 200, device="cuda"):
        super().__init__(n_envs, device)
        self.max_steps = max_steps
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_limit = float(np.float32(12 * 2 * math.pi / 360))
        self.x_limit = float(np.float32(2.4))

    def reset(self, generator):
        n = self.n_envs
        u = torch.rand((n, 4), generator=generator, device=self.device)
        return {"s": u * 0.1 - 0.05,
                "t": torch.zeros((n,), dtype=torch.int32, device=self.device)}

    def observe(self, state):
        return state["s"].float()

    def _step_batch(self, state, actions, generator):
        x, x_dot, theta, theta_dot = state["s"].unbind(dim=1)
        force = torch.where(actions == 1, self.force_mag, -self.force_mag)
        costheta, sintheta = torch.cos(theta), torch.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        s = torch.stack([x + self.tau * x_dot,
                         x_dot + self.tau * xacc,
                         theta + self.tau * theta_dot,
                         theta_dot + self.tau * thetaacc], dim=1)
        t = state["t"] + 1
        fail = (s[:, 0].abs() > self.x_limit) | (s[:, 2].abs() > self.theta_limit)
        done = fail | (t >= self.max_steps)
        return {"s": s, "t": t}, torch.ones_like(x), done
