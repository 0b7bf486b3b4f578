"""Decoder trunk of the dense family: init, prefill, decode step, cache.

The port's counterpart of ``repro/models/transformer.py`` for the dense
family (the serving slice). Layer parameters are stacked on a leading
layer axis, as the reference's scanned stack lays them out, and the layers
run as a Python loop over that axis. The cache is per layer
``(L, B, slots, Hkv, D)``, as in the reference; ``decode_step`` updates it
in place (see ``attention.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (
    dtype_of,
    embed_init,
    init_rmsnorm,
    rmsnorm,
)
from repro_torch.models.mlp import init_mlp, mlp_forward


def _check_family(cfg) -> None:
    if (cfg.family != "dense" or cfg.attention != "gqa" or cfg.num_experts
            or not cfg.d_ff or cfg.first_dense_layers or cfg.is_encoder_decoder
            or cfg.frontend_dim or cfg.prefix_len):
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family is ported yet; MoE, MLA, "
            "SSM, hybrid, encoder-decoder and vision trunks wait for "
            "ROADMAP.md Queue 1, item 11")


# ---------------------------------------------------------------------------
# Single blocks
# ---------------------------------------------------------------------------


def init_attn_block(generator, cfg, dtype):
    """Transformer block: GQA + SwiGLU FFN, pre-norm."""
    device = generator.device
    return {"ln1": init_rmsnorm(cfg.d_model, dtype, device),
            "attn": attn.init_gqa(generator, cfg, dtype),
            "ln2": init_rmsnorm(cfg.d_model, dtype, device),
            "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, cfg.mlp)}


def attn_block_forward(p, cfg, x, *, window: int = 0):
    """Full-sequence block. Returns (x, (k, v)) — the cache contents."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, kv = attn.gqa_prefill(p["attn"], cfg, h, window=window)
    x = x + y
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp_forward(p["mlp"], h), kv


def attn_block_decode(p, cfg, x, cache, pos, *, window: int = 0):
    """Single-token block step. cache: this layer's {"attn": {"k", "v"}}."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, _ = attn.gqa_decode(p["attn"], cfg, h, cache["attn"], pos, window=window)
    x = x + y
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp_forward(p["mlp"], h), cache


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def _stack(trees):
    """Stack a list of equal parameter trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_model(generator, cfg):
    _check_family(cfg)
    dtype = dtype_of(cfg.param_dtype)
    device = generator.device
    p = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)}
    blocks = []
    for _ in range(cfg.num_layers):
        blocks.append(init_attn_block(generator, cfg, dtype))
    p["layers"] = _stack(blocks)
    del blocks
    p["final_norm"] = init_rmsnorm(cfg.d_model, dtype, device)
    return p


def embed_tokens(p, cfg, tokens):
    """tokens: (B, S) integer ids -> (B, S, d_model) in the compute dtype."""
    return p["embed"][tokens].to(dtype_of(cfg.compute_dtype))


def x_final(params, cfg, x):
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, dtype=None, *, device):
    _check_family(cfg)
    if dtype is None:
        dtype = dtype_of(cfg.cache_dtype or cfg.compute_dtype)
    one = attn.init_gqa_cache(cfg, batch, max_len, dtype, device)
    L = cfg.num_layers
    return {"layers": {"attn": {
        name: torch.zeros((L,) + tuple(t.shape), dtype=dtype, device=device)
        for name, t in one.items()}}}


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def prefill(params, cfg, tokens, *, window: Optional[int] = None,
            max_len: Optional[int] = None):
    """Full-sequence causal pass that also fills the KV cache.

    ``max_len`` sizes the cache with decode headroom (defaults to S); slots
    [S, max_len) stay zero. Returns (hidden (B, S, d), cache).
    """
    _check_family(cfg)
    win = cfg.sliding_window if window is None else window
    x = embed_tokens(params, cfg, tokens)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, max_len or S, device=x.device)
    ck, cv = cache["layers"]["attn"]["k"], cache["layers"]["attn"]["v"]
    for i in range(cfg.num_layers):
        x, (k, v) = attn_block_forward(layer(params["layers"], i), cfg, x,
                                       window=win)
        ck[i, :, :S] = k.to(ck.dtype)
        cv[i, :, :S] = v.to(cv.dtype)
    return x_final(params, cfg, x), cache


def decode_step(params, cfg, cache, token, pos, *, window: Optional[int] = None):
    """One autoregressive step. token: (B, 1) integer ids; pos: an int
    (every row at the same position) or a (B,) int32 tensor (per-row
    positions). Updates ``cache`` in place; returns (hidden (B, 1, d), cache).
    """
    win = cfg.sliding_window if window is None else window
    x = embed_tokens(params, cfg, token)
    layers = cache["layers"]
    for i in range(cfg.num_layers):
        x, _ = attn_block_decode(layer(params["layers"], i), cfg, x,
                                 layer(layers, i), pos, window=win)
    return x_final(params, cfg, x), cache
