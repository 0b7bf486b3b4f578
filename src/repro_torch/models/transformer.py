"""Decoder trunks of the dense (GQA or MLA) and SSM families: init,
prefill, decode step, cache.

The port's counterpart of ``repro/models/transformer.py`` for the families
served so far. Layer parameters are stacked on a leading layer axis, as the
reference's scanned stack lays them out, and the layers run as a Python
loop over that axis. Every cache leaf is per layer ``(L, B, ...)``, as in
the reference: GQA's ``{"k", "v"}`` (L, B, slots, Hkv, D), MLA's ``{"c",
"kr"}`` (L, B, slots, rank / rope), Mamba2's conv buffers and fp32 state.
``decode_step`` updates the cache in place (see ``attention.py`` and
``ssm.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import (
    dtype_of,
    embed_init,
    init_rmsnorm,
    rmsnorm,
)
from repro_torch.models.mlp import init_mlp, mlp_forward


def _check_family(cfg) -> None:
    dense = (cfg.family == "dense" and cfg.attention in ("gqa", "mla")
             and cfg.d_ff and not cfg.num_experts
             and not cfg.first_dense_layers)
    if (not (dense or cfg.family == "ssm") or cfg.is_encoder_decoder
            or cfg.frontend_dim or cfg.prefix_len):
        raise NotImplementedError(
            f"{cfg.name}: only the dense (GQA or MLA) and SSM families are "
            "ported yet; MoE, hybrid, encoder-decoder and vision trunks wait "
            "for ROADMAP.md Queue 1, item 11")


# ---------------------------------------------------------------------------
# Single blocks
# ---------------------------------------------------------------------------


def init_attn_block(generator, cfg, dtype):
    """Transformer block: GQA or MLA + FFN, pre-norm."""
    device = generator.device
    init = attn.init_mla if cfg.attention == "mla" else attn.init_gqa
    return {"ln1": init_rmsnorm(cfg.d_model, dtype, device),
            "attn": init(generator, cfg, dtype),
            "ln2": init_rmsnorm(cfg.d_model, dtype, device),
            "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, cfg.mlp)}


def attn_block_forward(p, cfg, x, *, window: int = 0):
    """Full-sequence block. Returns (x, cache contents): (k, v) for GQA,
    (c, kr) for MLA."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    fwd = attn.mla_forward if cfg.attention == "mla" else attn.gqa_prefill
    y, kv = fwd(p["attn"], cfg, h, window=window)
    x = x + y
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp_forward(p["mlp"], h), kv


def attn_block_decode(p, cfg, x, cache, pos, *, window: int = 0):
    """Single-token block step. cache: this layer's {"attn": {...}}."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    dec = attn.mla_decode if cfg.attention == "mla" else attn.gqa_decode
    y, _ = dec(p["attn"], cfg, h, cache["attn"], pos, window=window)
    x = x + y
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp_forward(p["mlp"], h), cache


def init_ssm_block(generator, cfg, dtype):
    """Mamba2 block, pre-norm, no MLP."""
    return {"ln": init_rmsnorm(cfg.d_model, dtype, generator.device),
            "mamba": ssm.init_mamba2(generator, cfg, dtype)}


def ssm_block_forward(p, cfg, x):
    """Full-sequence block. Returns (x, (state, conv tails)) — the cache
    contents."""
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    y, contents = ssm.mamba2_forward(p["mamba"], cfg, h, return_state=True)
    return x + y, contents


def ssm_block_decode(p, cfg, x, cache):
    """Single-token block step; ``cache`` is this layer's Mamba2 cache."""
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    y, _ = ssm.mamba2_decode(p["mamba"], cfg, h, cache)
    return x + y, cache


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
    block = init_ssm_block if cfg.family == "ssm" else init_attn_block
    blocks = []
    for _ in range(cfg.num_layers):
        blocks.append(block(generator, cfg, dtype))
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
# KV / state cache
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, dtype=None, *, device):
    """Zeroed per-layer cache, each leaf (L, batch, ...). The SSM state is
    fp32 whatever ``dtype`` is; an SSM cache does not depend on
    ``max_len``."""
    _check_family(cfg)
    if dtype is None:
        dtype = dtype_of(cfg.cache_dtype or cfg.compute_dtype)
    if cfg.family == "ssm":
        one = ssm.init_mamba2_cache(cfg, batch, dtype, "meta")
    elif cfg.attention == "mla":
        one = {"attn": attn.init_mla_cache(cfg, batch, max_len, dtype, "meta")}
    else:
        one = {"attn": attn.init_gqa_cache(cfg, batch, max_len, dtype, "meta")}
    L = cfg.num_layers

    def stack(tree):
        if isinstance(tree, dict):
            return {k: stack(v) for k, v in tree.items()}
        return torch.zeros((L,) + tuple(tree.shape), dtype=tree.dtype,
                           device=device)

    return {"layers": stack(one)}


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def prefill(params, cfg, tokens, *, window: Optional[int] = None,
            max_len: Optional[int] = None):
    """Full-sequence causal pass that also fills the cache: each layer's
    K/V or MLA latent, or its final SSM state and conv tails.

    ``max_len`` sizes an attention cache with decode headroom (defaults to
    S); slots [S, max_len) stay zero. Returns (hidden (B, S, d), cache).
    """
    _check_family(cfg)
    win = cfg.sliding_window if window is None else window
    x = embed_tokens(params, cfg, tokens)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, max_len or S, device=x.device)
    lc = cache["layers"]
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        if cfg.family == "ssm":
            x, (state, (tx, tB, tC)) = ssm_block_forward(lp, cfg, x)
            lc["state"][i] = state
            lc["conv_x"][i] = tx.to(lc["conv_x"].dtype)
            lc["conv_B"][i] = tB.to(lc["conv_B"].dtype)
            lc["conv_C"][i] = tC.to(lc["conv_C"].dtype)
            continue
        x, kv = attn_block_forward(lp, cfg, x, window=win)
        for name, t in zip(lc["attn"], kv):  # (k, v) or (c, kr)
            lc["attn"][name][i, :, :S] = t.to(lc["attn"][name].dtype)
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
        lp, lc = layer(params["layers"], i), layer(layers, i)
        if cfg.family == "ssm":  # the recurrence needs no position
            x, _ = ssm_block_decode(lp, cfg, x, lc)
        else:
            x, _ = attn_block_decode(lp, cfg, x, lc, pos, window=win)
    return x_final(params, cfg, x), cache
