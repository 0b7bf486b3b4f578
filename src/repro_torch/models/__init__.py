"""Unified policy/value model API of the port (token families).

The same functional surface as ``repro.models``, for the families ported
so far (dense GQA):

* ``init_policy(cfg, *, generator, device)``           -> params
* ``init_policy_cache(cfg, batch, max_len, *, device)``  -> decode cache
* ``policy_prefill(params, cfg, tokens, …)``  -> (logits, values, cache)
* ``policy_decode(params, cfg, cache, tok, pos)`` -> (logits, value, cache)

Logits and values are fp32. ``device`` defaults to ``"cuda"`` and raises
when no CUDA device is present; pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.heads import apply_heads, init_heads


def init_policy(cfg, *, generator, device="cuda"):
    """Random parameters drawn from ``generator``, which must live on
    ``device``."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters "
                         f"are asked for on {dev}")
    return {"trunk": tfm.init_model(generator, cfg),
            "heads": init_heads(generator, cfg)}


def init_policy_cache(cfg, batch: int, max_len: int, dtype=None, *,
                      device="cuda"):
    return tfm.init_cache(cfg, batch, max_len, dtype,
                          device=resolve_device(device))


def _heads(params, cfg, hidden):
    embed = params["trunk"]["embed"] if cfg.tie_policy_head else None
    return apply_heads(params["heads"], cfg, hidden, embed)


def policy_prefill(params, cfg, tokens, *, window: Optional[int] = None,
                   max_len: Optional[int] = None):
    """tokens (B, S) -> (logits (B, S, A), values (B, S), cache)."""
    hidden, cache = tfm.prefill(params["trunk"], cfg, tokens, window=window,
                                max_len=max_len)
    logits, values = _heads(params, cfg, hidden)
    return logits, values, cache


def policy_decode(params, cfg, cache, token, pos, *,
                  window: Optional[int] = None):
    """One decode step: token (B, 1) -> (logits (B, A), value (B,), cache)."""
    hidden, cache = tfm.decode_step(params["trunk"], cfg, cache, token, pos,
                                    window=window)
    logits, value = _heads(params, cfg, hidden)
    return logits[:, 0], value[:, 0], cache
