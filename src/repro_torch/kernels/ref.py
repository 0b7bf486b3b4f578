"""Plain PyTorch versions of the port's kernels: the oracles.

Each function is the direct definition, materializing whatever
intermediates it likes, as ``repro/kernels/ref.py`` does for the Pallas
kernels. On the CPU the dispatch in ``ops.py`` runs these; on the card
``chip_smoke.py`` holds each hand-written kernel against them.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D). Returns (B, Sq, H, Dv)."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, pos, *, scale=None):
    """q: (B, H, D); caches: (B, S, Hkv, D). ``pos`` is an int (every row
    attends to slots <= pos) or a (B,) integer tensor (row b attends to
    slots <= pos[b]). Returns (B, H, Dv)."""
    B, H, D = q.shape
    _, S, Hkv, Dv = v_cache.shape
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    slots = torch.arange(S, device=q.device)
    if isinstance(pos, torch.Tensor):
        valid = slots[None, :] <= pos.to(q.device)[:, None]  # (B, S)
    else:
        valid = (slots <= int(pos))[None, :]  # (1, S)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, H, Dv).to(q.dtype)
