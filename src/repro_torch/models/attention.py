"""Attention: grouped-query (GQA, self and cross) and multi-head latent
(MLA), prefill and single-token decode over a cache, with or without a
sliding window.

The port's counterpart of ``repro/models/attention.py``. Prefill and
cross-attention run in kernel K3 (MLA's with q/k wider than v), GQA decode
and the decoder's one-token cross-attention in K4, MLA's absorbed decode in
K5, through ``repro_torch.kernels.ops``: on CUDA tensors the hand-written
kernels, on CPU tensors their plain versions. MLA's naive decode is plain
PyTorch, as the reference computes it outside any Pallas kernel.

A sliding window keeps a ring cache of ``min(max_len, sliding_window)``
slots: token t lives at slot t % slots, and decode attends to the slots
younger than ``min(window or slots, pos + 1)``, the reference's age rule.
With the ring's own size that rule is what K4 and K5 compute without a
window (slots <= pos, every slot once the ring has filled), so a decode
passes the kernels a window only when it is narrower than the cache.

Unlike the reference, whose arrays are immutable, ``gqa_decode`` and
``mla_decode`` write the new token's cache entries in place and return the
same cache: the serving cache is the largest thing on the card after the
weights, and a copy per step would double its traffic.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, live_slots
from repro_torch.models.common import (apply_rope, init_linear, init_rmsnorm,
                                       linear, rmsnorm)


def _slots(cfg, max_len: int) -> int:
    """Cache slots: a ring of ``min(max_len, sliding_window)`` when the
    config has a window, else ``max_len``."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def _kernel_window(window: int, slots: int) -> int:
    """The window a decode passes K4/K5: the reference's ``window or
    slots``, or 0 where that covers the whole cache (the kernels' rule
    without a window is the same there)."""
    win = window or slots
    return win if win < slots else 0


def init_gqa(generator, cfg, dtype, *, cross: bool = False):
    """Weights for grouped-query attention, with QKV bias when the config
    asks for it; ``cross`` (a decoder block's cross-attention) has the
    same shapes."""
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": init_linear(generator, cfg.d_model, H * D, dtype, bias=cfg.qkv_bias),
        "wk": init_linear(generator, cfg.d_model, Hkv * D, dtype, bias=cfg.qkv_bias),
        "wv": init_linear(generator, cfg.d_model, Hkv * D, dtype, bias=cfg.qkv_bias),
        "wo": init_linear(generator, H * D, cfg.d_model, dtype,
                          scale=1.0 / math.sqrt(2 * max(cfg.num_layers, 1))),
    }


def project_kv(p, cfg, src):
    """K and V of src (B, Sk, d_model), each (B, Sk, Hkv, D), unroped: of
    the encoder output, what a decoder block's cross-attention reads and
    its cross cache holds."""
    B, Sk, _ = src.shape
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    return (linear(p["wk"], src).reshape(B, Sk, Hkv, D),
            linear(p["wv"], src).reshape(B, Sk, Hkv, D))


def cross_forward(p, cfg, x, k, v):
    """Cross-attention of x (B, S, d_model) over the K/V (B, Sk, Hkv, D)
    that ``project_kv`` made of the encoder's output: K3, non-causal, no
    rope, the function the reference's ``gqa_forward(kv_src=...,
    causal=False, use_rope=False)`` computes. Returns (B, S, d_model)."""
    B, S, _ = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, H, D)
    out = ops.flash_attention(q, k, v, causal=False)
    return linear(p["wo"], out.reshape(B, S, H * D))


def cross_decode(p, cfg, x, ck, cv):
    """One decoder token x (B, 1, d_model) against the cross cache ck/cv
    (B, Sk, Hkv, D): K4 with every slot live (pos = Sk - 1), the function
    the reference's ``_cross_decode`` computes."""
    B = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(B, H, D).to(ck.dtype)
    out = ops.decode_attention(q, ck, cv, ck.shape[1] - 1)
    return linear(p["wo"], out.reshape(B, 1, H * D).to(x.dtype))


def gqa_prefill(p, cfg, x, *, window: int = 0):
    """Causal self-attention over x (B, S, d_model), each query over the
    ``window`` newest keys when it is > 0, that also returns the cache
    contents (roped K, V), each (B, S, Hkv, D)."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, H, D)
    k = linear(p["wk"], x).reshape(B, S, Hkv, D)
    v = linear(p["wv"], x).reshape(B, S, Hkv, D)
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    return linear(p["wo"], out.reshape(B, S, H * D)), (k, v)


def init_gqa_cache(cfg, batch: int, max_len: int, dtype, device):
    """A ring of ``min(max_len, sliding_window)`` slots under a window,
    else ``max_len`` slots."""
    slots = _slots(cfg, max_len)
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, slots, Hkv, D), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, Hkv, D), dtype=dtype, device=device),
    }


def gqa_decode(p, cfg, x, cache, pos, *, window: int = 0):
    """Single-token decode of x (B, 1, d_model) against ``cache`` (one
    layer's {"k", "v"}, each (B, slots, Hkv, D)). Returns (out, cache).

    ``pos`` is an int (every row at the same position — the lockstep
    launcher) or a (B,) int32 tensor on x's device (each row at its own
    position — the serving engine). Row b's token is written at slot
    ``pos[b] % slots`` and attends to slots <= pos[b], or to the slots
    younger than ``min(window, pos[b] + 1)`` for a ``window`` narrower than
    the cache; every op is per row, so row b's output depends only on row
    b's token, position and cache.
    """
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
    out = ops.decode_attention(q.reshape(B, H, D).to(ck.dtype), ck, cv, pos,
                               window=_kernel_window(window, slots))
    out = out.reshape(B, 1, H * D).to(x.dtype)
    return linear(p["wo"], out), cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(generator, cfg, dtype):
    """Weights for MLA: low-rank queries (when ``q_lora_rank``), the shared
    latent projection to (c_kv || k_rope), and ``wukv`` from the latent to
    each head's (k_nope || v)."""
    device = generator.device
    H = cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    p = {}
    if cfg.q_lora_rank:
        p["wdq"] = init_linear(generator, cfg.d_model, cfg.q_lora_rank, dtype)
        p["q_norm"] = init_rmsnorm(cfg.q_lora_rank, dtype, device)
        p["wuq"] = init_linear(generator, cfg.q_lora_rank, H * qk, dtype)
    else:
        p["wq"] = init_linear(generator, cfg.d_model, H * qk, dtype)
    p["wdkv"] = init_linear(generator, cfg.d_model,
                            cfg.kv_lora_rank + cfg.qk_rope_dim, dtype)
    p["kv_norm"] = init_rmsnorm(cfg.kv_lora_rank, dtype, device)
    p["wukv"] = init_linear(generator, cfg.kv_lora_rank,
                            H * (cfg.qk_nope_dim + cfg.v_head_dim), dtype)
    p["wo"] = init_linear(generator, H * cfg.v_head_dim, cfg.d_model, dtype,
                          scale=1.0 / math.sqrt(2 * max(cfg.num_layers, 1)))
    return p


def _mla_queries(p, cfg, x):
    """x (B, S, d_model) -> (q_nope (B, S, H, nope), q_rope (B, S, H, rope)),
    q_rope not yet roped."""
    B, S, _ = x.shape
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = linear(p["wuq"], rmsnorm(p["q_norm"], linear(p["wdq"], x),
                                     cfg.norm_eps))
    else:
        q = linear(p["wq"], x)
    q = q.reshape(B, S, cfg.num_heads, qk)
    return q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]


def _mla_latent(p, cfg, x):
    """The compressed per-token latent: (c_kv normalised (B, S, rank),
    k_rope not yet roped (B, S, rope))."""
    ckv = linear(p["wdkv"], x)
    c, k_rope = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    return rmsnorm(p["kv_norm"], c, cfg.norm_eps), k_rope


def mla_forward(p, cfg, x, *, window: int = 0):
    """Causal MLA over x (B, S, d_model), each query over the ``window``
    newest keys when it is > 0, through K3 with q/k of width qk_nope +
    qk_rope and v of width v_head. Returns (out, (c, kr)): the cache
    contents, the normalised latent (B, S, rank) and the roped shared keys
    (B, S, rope)."""
    B, S, _ = x.shape
    H, nope, rope = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    pos = torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_queries(p, cfg, x)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    c, k_rope = _mla_latent(p, cfg, x)
    k_rope = apply_rope(k_rope, pos, cfg.rope_theta)  # (B, S, rope)
    kv = linear(p["wukv"], c).reshape(B, S, H, nope + cfg.v_head_dim)
    k = torch.cat([kv[..., :nope], k_rope[:, :, None, :].expand(B, S, H, rope)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = kv[..., nope:].contiguous()
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              scale=1.0 / math.sqrt(nope + rope))
    y = linear(p["wo"], out.reshape(B, S, H * cfg.v_head_dim))
    return y, (c, k_rope)


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device):
    """The latent cache, with ``init_gqa_cache``'s slots."""
    slots = _slots(cfg, max_len)
    return {
        "c": torch.zeros((batch, slots, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        "kr": torch.zeros((batch, slots, cfg.qk_rope_dim), dtype=dtype,
                          device=device),
    }


def mla_decode(p, cfg, x, cache, pos, *, window: int = 0):
    """Single-token MLA decode of x (B, 1, d_model) against ``cache`` (one
    layer's {"c" (B, slots, rank), "kr" (B, slots, rope)}). Returns (out,
    cache); ``pos`` and ``window`` as in ``gqa_decode``.

    ``cfg.mla_absorb`` selects the latent-space path: W_uk folded into the
    query (``q_lat``), attention over the latent cache in K5, W_uv applied to
    its latent output. Otherwise the naive path rebuilds every head's K/V
    from the whole latent cache each step, in plain PyTorch. The matmuls
    keep the cache dtype with fp32 accumulation and fp32 softmax, as the
    reference's do.
    """
    B = x.shape[0]
    H = cfg.num_heads
    nope, vdim, rank = cfg.qk_nope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    cc, ckr = cache["c"], cache["kr"]
    slots = cc.shape[1]
    q_nope, q_rope = _mla_queries(p, cfg, x)  # (B, 1, H, *)
    c_new, kr_new = _mla_latent(p, cfg, x)  # (B, 1, rank), (B, 1, rope)
    if isinstance(pos, torch.Tensor):
        q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)
        kr_new = apply_rope(kr_new, pos[:, None], cfg.rope_theta)
        rows = torch.arange(B, device=x.device)
        write = pos.long() % slots
        cc[rows, write] = c_new[:, 0].to(cc.dtype)
        ckr[rows, write] = kr_new[:, 0].to(ckr.dtype)
    else:
        pos = int(pos) if isinstance(pos, np.integer) else pos
        at = torch.full((1,), pos, device=x.device)
        q_rope = apply_rope(q_rope, at, cfg.rope_theta)
        kr_new = apply_rope(kr_new, at, cfg.rope_theta)
        cc[:, pos % slots] = c_new[:, 0].to(cc.dtype)
        ckr[:, pos % slots] = kr_new[:, 0].to(ckr.dtype)

    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_dim)
    wukv = p["wukv"]["w"].reshape(rank, H, nope + vdim)
    w_uk, w_uv = wukv[..., :nope], wukv[..., nope:]  # (rank, H, nope/v)
    qr = q_rope[:, 0].to(ckr.dtype).contiguous()  # (B, H, rope)
    if cfg.mla_absorb:
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
        o_lat = ops.mla_decode_attention(
            q_lat.to(cc.dtype).contiguous(), qr, cc, ckr, pos, scale,
            _kernel_window(window, slots))  # (B, H, rank)
        out = torch.einsum("bhr,rhv->bhv", o_lat.to(w_uv.dtype), w_uv)
    else:
        kv = torch.einsum("bkr,rhe->bkhe", cc, wukv.to(cc.dtype))
        k_nope, v = kv[..., :nope], kv[..., nope:]
        s = torch.einsum("bhn,bkhn->bhk", q_nope[:, 0].to(kv.dtype).float(),
                         k_nope.float())
        s = s + torch.einsum("bhr,bkr->bhk", qr.float(), ckr.float())
        # (B or 1, slots): the slots K5 would read
        valid = live_slots(pos, slots, _kernel_window(window, slots),
                           x.device)
        s = (s * scale).masked_fill(~valid[:, None, :], NEG_INF)
        pr = torch.softmax(s, dim=-1)
        out = torch.einsum("bhk,bkhv->bhv", pr.to(v.dtype).float(), v.float())
    out = out.reshape(B, 1, H * vdim).to(x.dtype)
    return linear(p["wo"], out), cache
