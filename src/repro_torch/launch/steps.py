"""Step builders shared by the port's launchers.

* ``build_serve_step(cfg)`` — the master's batched action selection
  (paper §3): one token per actor against the cache, all rows at one
  position (a scalar ``pos``).

The reference's train and prefill step builders wait for the slices that
use them.
"""
from __future__ import annotations

from repro_torch.models import policy_decode
from repro_torch.utils.sampling import categorical


def build_serve_step(cfg):
    def serve_step(params, cache, token, pos: int, generator):
        """One master step: sample π for every actor (batched decode).
        Returns (action (B, 1), value (B,), cache)."""
        logits, value, cache = policy_decode(params, cfg, cache, token, pos)
        action = categorical(logits, generator)
        return action[:, None], value, cache

    return serve_step
