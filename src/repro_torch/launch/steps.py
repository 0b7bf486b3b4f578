"""Step builders shared by the port's launchers.

* ``build_train_step(cfg)`` — the PAAC synchronous update (Algorithm 1
  lines 16-18) over a trajectory batch of a token policy: the learning
  forward with gradients, K1's n-step returns, the backward and one
  optimizer update.
* ``build_serve_step(cfg)`` — the master's batched action selection
  (paper §3): one token per actor against the cache, all rows at one
  position (a scalar ``pos``).

The reference's prefill step builder waits for the slice that uses it.
"""
from __future__ import annotations

from repro_torch.core.agents.paac import PAACAgent, PAACConfig
from repro_torch.models import policy_decode
from repro_torch.optim import make_optimizer, paac_scaled_lr
from repro_torch.utils.sampling import categorical


def build_train_step(cfg, *, optimizer: str = "rmsprop", n_e: int = 256):
    """Returns ``(train_step(params, opt_state, batch, step), optimizer)``,
    with the learning rate ``paac_scaled_lr(n_e)``."""
    agent = PAACAgent(cfg, PAACConfig())
    opt = make_optimizer(optimizer)
    step = agent.make_llm_train_step(opt, paac_scaled_lr(n_e))
    return step, opt


def build_serve_step(cfg):
    def serve_step(params, cache, token, pos: int, generator):
        """One master step: sample π for every actor (batched decode).
        Returns (action (B, 1), value (B,), cache)."""
        logits, value, cache = policy_decode(params, cfg, cache, token, pos)
        action = categorical(logits, generator)
        return action[:, None], value, cache

    return serve_step
