"""Step builders shared by the port's launchers.

* ``build_train_step(cfg)`` — the PAAC synchronous update (Algorithm 1
  lines 16-18) over a trajectory batch of a token policy: the learning
  forward with gradients, K1's n-step returns, the backward and one
  optimizer update.
* ``build_prefill_step(cfg)`` — batched full-context policy evaluation
  (the dry-run's ``prefill_32k``): the last position's logits and value,
  and the filled cache.
* ``build_serve_step(cfg)`` — the master's batched action selection
  (paper §3): one token per actor against the cache, all rows at one
  position (a scalar ``pos``).
"""
from __future__ import annotations

from repro_torch.core.agents.paac import PAACAgent, PAACConfig
from repro_torch.models import policy_decode, policy_prefill
from repro_torch.optim import make_optimizer, paac_scaled_lr
from repro_torch.utils.sampling import categorical


def build_train_step(cfg, *, optimizer: str = "rmsprop", n_e: int = 256):
    """Returns ``(train_step(params, opt_state, batch, step), optimizer)``,
    with the learning rate ``paac_scaled_lr(n_e)``."""
    agent = PAACAgent(cfg, PAACConfig())
    opt = make_optimizer(optimizer)
    step = agent.make_llm_train_step(opt, paac_scaled_lr(n_e))
    return step, opt


def build_prefill_step(cfg):
    def prefill_step(params, batch):
        """``batch`` holds ``tokens`` (B, S) and, for a vision or an
        encoder-decoder trunk, ``prefix`` or ``frames``. Returns (logits
        (B, A), value (B,), cache) of the last position."""
        tokens = batch["tokens"]
        prefix = batch.get("prefix", batch.get("frames"))
        logits, values, cache = policy_prefill(params, cfg, tokens, prefix)
        return logits[:, -1], values[:, -1], cache

    return prefill_step


def build_serve_step(cfg):
    def serve_step(params, cache, token, pos: int, generator):
        """One master step: sample π for every actor (batched decode).
        Returns (action (B, 1), value (B,), cache)."""
        logits, value, cache = policy_decode(params, cfg, cache, token, pos)
        action = categorical(logits, generator)
        return action[:, None], value, cache

    return serve_step
