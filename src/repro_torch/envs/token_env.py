"""TokenEnv: a token-manipulation game for LLM policies (the port of
``repro/envs/token_env.py``).

The observation is the token history, the action is the next token, and
the reward is programmatic — the RLHF-style generation setting, which is
the modern instance of the paper's master/actor pattern (batched action
selection = batched decode).

Game ("k-back echo"): at each step the correct action is the token emitted
``k`` steps ago (the prompt seeds the first k tokens). Reward +1 for the
correct token, 0 otherwise. Episodes run ``horizon`` steps. The history is
an int32 (n_e, ctx) tensor: a vector policy (``paac_vector``) acts on the
raw token ids, which its trunk casts to its compute dtype.
"""
from __future__ import annotations

import torch

from repro_torch.envs.base import VectorEnv


class TokenEnv(VectorEnv):
    def __init__(self, n_envs: int, vocab: int = 64, ctx: int = 32, k: int = 2,
                 horizon: int = 64, device="cuda"):
        super().__init__(n_envs, device)
        self.vocab = vocab
        self.ctx = ctx
        self.k = k
        self.horizon = horizon
        self.obs_shape = (ctx,)
        self.num_actions = vocab

    def reset(self, generator):
        n = self.n_envs
        return {"hist": torch.randint(0, self.vocab, (n, self.ctx),
                                      generator=generator, device=self.device,
                                      dtype=torch.int32),
                "t": torch.zeros((n,), dtype=torch.int32, device=self.device)}

    def observe(self, state):
        return state["hist"]

    def _step_batch(self, state, actions, generator):
        hist = state["hist"]
        actions = actions.to(torch.int32)
        reward = (actions == hist[:, -self.k]).float()
        hist = torch.cat([hist[:, 1:], actions[:, None]], dim=1)
        t = state["t"] + 1
        return {"hist": hist, "t": t}, reward, t >= self.horizon
