"""Grouped-query attention: prefill and single-token decode over a KV cache.

The port's counterpart of ``repro/models/attention.py``, GQA only. Prefill
attention runs in kernel K3 and decode attention in kernel K4, through
``repro_torch.kernels.ops``: on CUDA tensors the hand-written kernels, on
CPU tensors their plain versions.

Unlike the reference, whose arrays are immutable, ``gqa_decode`` writes the
new token's K/V into the cache in place and returns the same cache: the
serving cache is the largest thing on the card after the weights, and a
copy per step would double its traffic.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, init_linear, linear

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1, item 11)"


def _check_window(cfg, window: int) -> None:
    if window or cfg.sliding_window:
        raise NotImplementedError(f"sliding-window attention {_NOT_PORTED}")


def init_gqa(generator, cfg, dtype, *, cross: bool = False):
    """Weights for grouped-query attention, with QKV bias when the config
    asks for it."""
    if cross:
        raise NotImplementedError(f"cross-attention {_NOT_PORTED}")
    if cfg.attention != "gqa":
        raise NotImplementedError(f"{cfg.attention} attention {_NOT_PORTED}")
    _check_window(cfg, 0)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": init_linear(generator, cfg.d_model, H * D, dtype, bias=cfg.qkv_bias),
        "wk": init_linear(generator, cfg.d_model, Hkv * D, dtype, bias=cfg.qkv_bias),
        "wv": init_linear(generator, cfg.d_model, Hkv * D, dtype, bias=cfg.qkv_bias),
        "wo": init_linear(generator, H * D, cfg.d_model, dtype,
                          scale=1.0 / math.sqrt(2 * max(cfg.num_layers, 1))),
    }


def gqa_prefill(p, cfg, x, *, window: int = 0):
    """Causal self-attention over x (B, S, d_model) that also returns the
    cache contents (roped K, V), each (B, S, Hkv, D)."""
    _check_window(cfg, window)
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, H, D)
    k = linear(p["wk"], x).reshape(B, S, Hkv, D)
    v = linear(p["wv"], x).reshape(B, S, Hkv, D)
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True)
    return linear(p["wo"], out.reshape(B, S, H * D)), (k, v)


def init_gqa_cache(cfg, batch: int, max_len: int, dtype, device):
    _check_window(cfg, 0)
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, Hkv, D), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, Hkv, D), dtype=dtype, device=device),
    }


def gqa_decode(p, cfg, x, cache, pos, *, window: int = 0):
    """Single-token decode of x (B, 1, d_model) against ``cache`` (one
    layer's {"k", "v"}, each (B, slots, Hkv, D)). Returns (out, cache).

    ``pos`` is an int (every row at the same position — the lockstep
    launcher) or a (B,) int32 tensor on x's device (each row at its own
    position — the serving engine). Row b's token is written at slot
    ``pos[b] % slots`` and attends to slots <= pos[b]; every op is per row,
    so row b's output depends only on row b's token, position and cache.
    """
    _check_window(cfg, window)
    B = x.shape[0]
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    slots = ck.shape[1]
    q = linear(p["wq"], x).reshape(B, 1, H, D)
    k = linear(p["wk"], x).reshape(B, 1, Hkv, D)
    v = linear(p["wv"], x).reshape(B, 1, Hkv, D)
    if isinstance(pos, torch.Tensor):
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
        rows = torch.arange(B, device=x.device)
        write = pos.long() % slots
        ck[rows, write] = k[:, 0].to(ck.dtype)
        cv[rows, write] = v[:, 0].to(cv.dtype)
    else:
        pos = int(pos) if isinstance(pos, np.integer) else pos
        at = torch.full((1,), pos, device=x.device)
        q = apply_rope(q, at, cfg.rope_theta)
        k = apply_rope(k, at, cfg.rope_theta)
        ck[:, pos % slots] = k[:, 0].to(ck.dtype)
        cv[:, pos % slots] = v[:, 0].to(cv.dtype)
    out = ops.decode_attention(q.reshape(B, H, D).to(ck.dtype), ck, cv, pos)
    out = out.reshape(B, 1, H * D).to(x.dtype)
    return linear(p["wo"], out), cache
