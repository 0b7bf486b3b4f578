"""Decoder trunks of the dense and MoE (GQA or MLA), SSM, hybrid, vision
and audio encoder-decoder families: init, prefill, decode step, cache.

The port's counterpart of ``repro/models/transformer.py``. Layer
parameters are stacked on a leading layer axis, as the
reference's scanned stack lays them out, and the layers run as a Python
loop over that axis. An MoE trunk (DeepSeek-V2, DBRX) runs its
``first_dense_layers`` with a dense FFN as a stack of their own,
``"first"``, before ``"layers"``, whose blocks carry a ``"moe"`` FFN
(``moe.py``). A hybrid trunk (Zamba2) runs ``"groups"``, a stack of stacks
(n_groups, shared_attn_every, ...) of Mamba2 blocks, each group followed by
one application of the single ``"shared"`` attention block (one weight
copy, no layer axis), then a ``"tail"`` stack of the remaining
``num_layers % shared_attn_every`` Mamba2 blocks. The shared block's FFN
is built as the reference builds it, ``dense_ff=cfg.d_ff``: a dense MLP
when ``d_ff`` is set (a config's experts are then ignored), the MoE block
when ``d_ff`` is 0 and the config has experts; the hybrid's ``forward``
drops that block's aux loss, as the reference's group does, so its
``moe_aux`` is 0 in both forms. Every cache leaf is per
layer ``(L, B, ...)``, as in the reference: GQA's ``{"k", "v"}`` (L, B,
slots, Hkv, D), MLA's ``{"c", "kr"}`` (L, B, slots, rank / rope), Mamba2's
conv buffers and fp32 state; an MoE trunk's cache is ``{"first": {"attn":
...}, "layers": {"attn": ...}}``, a hybrid's ``{"groups": (n_groups,
every, B, ...), "shared": {"attn": ...} (n_groups, B, ...), "tail": (rem,
B, ...)}``: one K/V cache per application of the shared block.
``decode_step`` updates the cache in place (see ``attention.py`` and
``ssm.py``).

A vision trunk (Pixtral) is a dense decoder whose input is a prefix of
patch embeddings, through ``"frontend_proj"``, before the text tokens. An
encoder-decoder trunk (SeamlessM4T) runs its frame embeddings, through
``"frontend_proj"``, once through the ``"encoder"`` stack and its
``"norm"``; each decoder block of ``"layers"`` adds a cross-attention
(``"ln_x"``, ``"xattn"``) over the encoder's output, whose K/V the
prefill computes once per layer into the cache's ``"cross"`` {"k", "v"}
(L, B, encoder length, Hkv, D). The encoder is causal, as the
reference's is (its ``_run_encoder`` passes ``causal=False``, which
``attn_block_forward`` never hands on to ``gqa_prefill``).

With a sliding window an attention cache is a ring (``attention.py``);
the prefill places the last ``slots`` tokens where decoding them would
have put them, token t at slot t % slots, as the reference's
``_cache_from_kv`` does.

Unlike the reference, whose hybrid ``prefill`` returns the zero cache, the
port's fills it: every Mamba2 layer's final state and conv tails and each
shared application's K/V, as decoding the prompt token by token from the
zero cache would leave them.

``forward`` is the training pass of every trunk: no cache, gradients
through K3's backward (``kernels.ops.FlashAttention``), K6's
(``kernels.ops.SSDScan``) and the MoE aux loss. The SSM trunk runs each
Mamba2 layer under one remat; the hybrid each group (its Mamba2 layers,
then the shared block) under one, then each tail layer under its own, as
the reference's scans are wrapped.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import (
    dtype_of,
    embed_init,
    init_linear,
    init_rmsnorm,
    linear,
    rmsnorm,
)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch.utils.tree import tree_map


def _check_family(cfg) -> None:
    attention = cfg.attention in ("gqa", "mla")
    # attention blocks with one dense FFN of d_ff
    plain = (attention and cfg.d_ff and not cfg.num_experts
             and not cfg.first_dense_layers)
    trunk = {
        "dense": plain,
        "vlm": plain,
        "audio": (plain and cfg.attention == "gqa" and cfg.is_encoder_decoder
                  and cfg.encoder_layers >= 1),
        "moe": attention and cfg.num_experts,
        # the shared block's FFN: dense of d_ff when set (experts ignored),
        # else the MoE block
        "hybrid": (attention and (cfg.d_ff or cfg.num_experts)
                   and not cfg.first_dense_layers
                   and 1 <= cfg.shared_attn_every <= cfg.num_layers),
        "ssm": True,
    }
    front = cfg.family in ("vlm", "audio")
    if (not trunk.get(cfg.family) or (cfg.is_encoder_decoder
                                      and cfg.family != "audio")
            or ((cfg.frontend_dim or cfg.prefix_len) and not front)):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with these settings is not "
            "a trunk of the port (dense, MoE, SSM, hybrid, vision, audio "
            "encoder-decoder)")


# ---------------------------------------------------------------------------
# Single blocks
# ---------------------------------------------------------------------------


def init_attn_block(generator, cfg, dtype, *, dense_ff: int = 0,
                    cross: bool = False):
    """Transformer block: GQA or MLA (+ a GQA cross-attention when
    ``cross``) + FFN, pre-norm. The FFN is a dense MLP of width
    ``dense_ff`` when given, else the MoE block when the config has
    experts, else a dense MLP of width ``d_ff``."""
    device = generator.device
    init = attn.init_mla if cfg.attention == "mla" else attn.init_gqa
    p = {"ln1": init_rmsnorm(cfg.d_model, dtype, device),
         "attn": init(generator, cfg, dtype)}
    if cross:
        p["ln_x"] = init_rmsnorm(cfg.d_model, dtype, device)
        p["xattn"] = attn.init_gqa(generator, cfg, dtype, cross=True)
    p["ln2"] = init_rmsnorm(cfg.d_model, dtype, device)
    if dense_ff:
        p["mlp"] = init_mlp(generator, cfg.d_model, dense_ff, dtype, cfg.mlp)
    elif cfg.num_experts:
        p["moe"] = init_moe(generator, cfg, dtype)
    else:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, cfg.mlp)
    return p


def _ffn(p, cfg, h):
    """The block's FFN on the normed input: (y, the MoE aux loss, or 0.0
    for a dense FFN)."""
    if "moe" in p:
        return moe_forward(p["moe"], cfg, h)
    return mlp_forward(p["mlp"], h), 0.0


def attn_block_forward(p, cfg, x, *, window: int = 0, cross_kv=None):
    """Full-sequence block, causal; a decoder block of an encoder-decoder
    also attends to ``cross_kv``, the (k, v) ``attn.project_kv`` made of
    the encoder's output. Returns (x, aux loss, cache contents): (k, v) for
    GQA, (c, kr) for MLA."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    fwd = attn.mla_forward if cfg.attention == "mla" else attn.gqa_prefill
    y, kv = fwd(p["attn"], cfg, h, window=window)
    x = x + y
    if cross_kv is not None:
        h = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        x = x + attn.cross_forward(p["xattn"], cfg, h, *cross_kv)
    y, aux = _ffn(p, cfg, rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + y, aux, kv


def attn_block_decode(p, cfg, x, cache, pos, *, window: int = 0,
                      cross=None):
    """Single-token block step. cache: this layer's {"attn": {...}};
    ``cross`` this decoder layer's {"k", "v"} of the cross cache."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    dec = attn.mla_decode if cfg.attention == "mla" else attn.gqa_decode
    y, _ = dec(p["attn"], cfg, h, cache["attn"], pos, window=window)
    x = x + y
    if cross is not None:
        h = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        x = x + attn.cross_decode(p["xattn"], cfg, h, cross["k"], cross["v"])
    y, _ = _ffn(p, cfg, rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + y, cache


def init_ssm_block(generator, cfg, dtype):
    """Mamba2 block, pre-norm, no MLP."""
    return {"ln": init_rmsnorm(cfg.d_model, dtype, generator.device),
            "mamba": ssm.init_mamba2(generator, cfg, dtype)}


def ssm_block_forward(p, cfg, x, *, return_state: bool = True):
    """Full-sequence block. Returns (x, (state, conv tails)) — the cache
    contents — or, for the training pass (``return_state=False``), x."""
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    out = ssm.mamba2_forward(p["mamba"], cfg, h, return_state=return_state)
    if not return_state:
        return x + out
    y, contents = out
    return x + y, contents


def ssm_block_decode(p, cfg, x, cache):
    """Single-token block step; ``cache`` is this layer's Mamba2 cache."""
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    y, _ = ssm.mamba2_decode(p["mamba"], cfg, h, cache)
    return x + y, cache


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def _stack_init(make, *dims: int):
    """``prod(dims)`` layers from ``make()`` stacked on leading axes
    ``dims`` (one axis for a stack, two for the hybrid's stack of groups).
    Each stacked leaf is allocated once, from the first layer's shapes, and
    each layer is copied into its slice as soon as it is drawn: the peak is
    the stack plus one layer, not twice the stack. The draws are those of
    ``prod(dims)`` calls of ``make()`` in order, the last axis fastest."""
    n = math.prod(dims)
    first = make()
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    tree_map(lambda dst, src: dst[0].copy_(src), out, first)
    del first
    for i in range(1, n):
        one = make()
        tree_map(lambda dst, src: dst[i].copy_(src), out, one)
        del one
    return tree_map(lambda t: t.view(tuple(dims) + tuple(t.shape[1:])), out)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def _hybrid_dims(cfg):
    """(every, n_groups, rem): Mamba2 layers a group, groups, tail layers."""
    every = cfg.shared_attn_every
    return (every,) + divmod(cfg.num_layers, every)


def _stacks(cfg):
    """The trunk's stacks of attention blocks in the order they run, with
    their depths: ``"first"`` (the leading dense layers) then ``"layers"``."""
    n_first = cfg.first_dense_layers
    return [(name, n) for name, n in (("first", n_first),
                                      ("layers", cfg.num_layers - n_first))
            if n]


def init_model(generator, cfg):
    _check_family(cfg)
    dtype = dtype_of(cfg.param_dtype)
    device = generator.device
    p = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)}
    if cfg.frontend_dim:
        p["frontend_proj"] = init_linear(generator, cfg.frontend_dim,
                                         cfg.d_model, dtype)
    if cfg.family == "ssm":
        p["layers"] = _stack_init(
            lambda: init_ssm_block(generator, cfg, dtype), cfg.num_layers)
    elif cfg.family == "hybrid":
        every, n_groups, rem = _hybrid_dims(cfg)
        p["groups"] = _stack_init(
            lambda: init_ssm_block(generator, cfg, dtype), n_groups, every)
        if rem:
            p["tail"] = _stack_init(
                lambda: init_ssm_block(generator, cfg, dtype), rem)
        p["shared"] = init_attn_block(generator, cfg, dtype,
                                      dense_ff=cfg.d_ff)
    else:
        for name, n in _stacks(cfg):
            ff = (cfg.dense_d_ff or cfg.d_ff) if name == "first" else 0
            cross = cfg.is_encoder_decoder and name == "layers"
            p[name] = _stack_init(
                lambda: init_attn_block(generator, cfg, dtype, dense_ff=ff,
                                        cross=cross), n)
        if cfg.is_encoder_decoder:
            p["encoder"] = {
                "layers": _stack_init(
                    lambda: init_attn_block(generator, cfg, dtype),
                    cfg.encoder_layers),
                "norm": init_rmsnorm(cfg.d_model, dtype, device)}
    p["final_norm"] = init_rmsnorm(cfg.d_model, dtype, device)
    return p


def _front(p, cfg, embeds):
    """Front-end embeddings (B, S, frontend_dim) -> (B, S, d_model) in the
    compute dtype, through ``frontend_proj`` when the trunk has one."""
    x = embeds.to(dtype_of(cfg.compute_dtype))
    return linear(p["frontend_proj"], x) if "frontend_proj" in p else x


def embed_tokens(p, cfg, tokens, prefix_embeds=None):
    """tokens: (B, S) integer ids -> (B, S, d_model) in the compute dtype;
    ``prefix_embeds`` (B, S_pre, frontend_dim), when given, go through the
    front end and come first: (B, S_pre + S, d_model)."""
    x = p["embed"][tokens].to(dtype_of(cfg.compute_dtype))
    if prefix_embeds is not None:
        x = torch.cat([_front(p, cfg, prefix_embeds), x], dim=1)
    return x




def x_final(params, cfg, x):
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Full-sequence training pass
# ---------------------------------------------------------------------------


def _maybe_remat(fn, cfg, train: bool):
    """The reference's ``_maybe_remat`` as ``torch.utils.checkpoint``
    (non-reentrant): with ``train`` and ``cfg.remat`` "full" or "dots", a
    block keeps only its inputs and runs again in the backward. "dots"
    (save the products) recomputes the whole block too: remat changes no
    result, and one rule keeps the saved bytes a layer at one input."""
    if not train or cfg.remat == "none":
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _run_encoder(p, cfg, frames, train: bool = False):
    """The encoder over front-end frame embeddings (B, S_enc, d_model),
    then its norm; with ``train``, each layer under ``_maybe_remat``.
    Causal, as the reference's is (F17): each layer is a causal
    self-attention block without a window."""
    enc = p["encoder"]
    block = _maybe_remat(lambda lp, x: attn_block_forward(lp, cfg, x)[0],
                         cfg, train)
    x = frames
    for i in range(cfg.encoder_layers):
        x = block(layer(enc["layers"], i), x)
    return rmsnorm(enc["norm"], x, cfg.norm_eps)


def _train_block(p, cfg, x, window: int, enc_out):
    """One attention block of the training pass, its cross-attention K/V
    projected from ``enc_out`` inside it (so that remat recomputes them).
    Returns (x, aux loss)."""
    cross_kv = None if enc_out is None else attn.project_kv(p["xattn"], cfg,
                                                            enc_out)
    x, aux, _ = attn_block_forward(p, cfg, x, window=window,
                                   cross_kv=cross_kv)
    return x, aux


def _mamba_trunk(params, cfg, x, window: int, train: bool):
    """The SSM or hybrid trunk's training pass over x (B, S, d): each
    Mamba2 layer of an SSM trunk under its own ``_maybe_remat``; each
    hybrid group (its Mamba2 layers, then the shared block) under one,
    then each tail layer under its own. Returns x."""
    block = _maybe_remat(
        lambda p, x: ssm_block_forward(p, cfg, x, return_state=False), cfg,
        train)
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = block(layer(params["layers"], i), x)
        return x
    every, n_groups, _ = _hybrid_dims(cfg)

    def group(gp, shared, x):
        for i in range(every):
            x = ssm_block_forward(layer(gp, i), cfg, x, return_state=False)
        # an MoE shared block's aux loss is dropped, as the reference's
        # group drops it (``x, _, _ = attn_block_forward(...)``)
        return attn_block_forward(shared, cfg, x, window=window)[0]

    group = _maybe_remat(group, cfg, train)
    for g in range(n_groups):
        x = group(layer(params["groups"], g), params["shared"], x)
    if "tail" in params:
        for i in range(_depth(params["tail"])):
            x = block(layer(params["tail"], i), x)
    return x


def forward(params, cfg, tokens, prefix_embeds=None, *, train: bool = False,
            window: Optional[int] = None):
    """Causal full-sequence pass, the reference's ``forward``: tokens
    (B, S) and, for a vision trunk, patch embeddings put before them, or,
    for an encoder-decoder, the frame embeddings its encoder reads.
    ``train`` turns on ``cfg.remat`` (``_maybe_remat``): a layer of the
    attention and SSM trunks, a group or a tail layer of the hybrid's.
    Gradients flow whenever grad mode is on. Writes no cache. Returns
    (hidden (B, S', d), {"moe_aux": the Switch aux loss summed over the
    MoE layers, 0 for a trunk without experts})."""
    _check_family(cfg)
    win = cfg.sliding_window if window is None else window
    enc_out = None
    if cfg.is_encoder_decoder:
        if prefix_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder trunk needs "
                             "prefix_embeds, the encoder's frame embeddings")
        enc_out = _run_encoder(params, cfg,
                               _front(params, cfg, prefix_embeds), train)
        x = embed_tokens(params, cfg, tokens)
    else:
        x = embed_tokens(params, cfg, tokens, prefix_embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        x = _mamba_trunk(params, cfg, x, win, train)
        return x_final(params, cfg, x), {"moe_aux": aux_total}
    block = _maybe_remat(
        lambda p, x, e: _train_block(p, cfg, x, win, e), cfg, train)
    for name, n in _stacks(cfg):
        for i in range(n):
            x, aux = block(layer(params[name], i), x, enc_out)
            aux_total = aux_total + aux
    return x_final(params, cfg, x), {"moe_aux": aux_total}


# ---------------------------------------------------------------------------
# KV / state cache
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, dtype=None, *, device):
    """Zeroed per-layer cache, each leaf (L, batch, ...); a hybrid's
    ``"groups"`` leaves are (n_groups, every, batch, ...). The SSM state is
    fp32 whatever ``dtype`` is; a Mamba2 cache does not depend on
    ``max_len``."""
    _check_family(cfg)
    if dtype is None:
        dtype = dtype_of(cfg.cache_dtype or cfg.compute_dtype)
    if cfg.family in ("ssm", "hybrid"):
        mamba = ssm.init_mamba2_cache(cfg, batch, dtype, "meta")
    if cfg.family != "ssm":
        init = (attn.init_mla_cache if cfg.attention == "mla"
                else attn.init_gqa_cache)
        one = {"attn": init(cfg, batch, max_len, dtype, "meta")}
    if cfg.is_encoder_decoder:
        Hkv, D = cfg.num_kv_heads, cfg.head_dim
        xkv = torch.empty((batch, cfg.encoder_seq_len, Hkv, D), dtype=dtype,
                          device="meta")
    if cfg.family == "ssm":
        stacks = [("layers", mamba, (cfg.num_layers,))]
    elif cfg.family == "hybrid":
        every, n_groups, rem = _hybrid_dims(cfg)
        stacks = [("groups", mamba, (n_groups, every)),
                  ("shared", one, (n_groups,))]
        if rem:
            stacks.append(("tail", mamba, (rem,)))
    else:
        stacks = [(name, one, (n,)) for name, n in _stacks(cfg)]
    if cfg.is_encoder_decoder:
        stacks.append(("cross", {"k": xkv, "v": xkv}, (cfg.num_layers,)))
    return {name: tree_map(lambda t: torch.zeros(dims + tuple(t.shape),
                                                 dtype=t.dtype, device=device),
                           leaves)
            for name, leaves, dims in stacks}


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def _depth(stack) -> int:
    """Layers in a stack of Mamba2 blocks (its leading axis)."""
    return len(stack["ln"]["scale"])


def _ssm_prefill(params, cache, cfg, x):
    """The Mamba2 layers of one stack over x (B, S, d); each layer's final
    state and conv tails land in its slice of ``cache``. Returns x."""
    for i in range(_depth(params)):
        x, (state, tails) = ssm_block_forward(layer(params, i), cfg, x)
        lc = layer(cache, i)
        lc["state"].copy_(state)
        for leaf, t in zip(("conv_x", "conv_B", "conv_C"), tails):
            lc[leaf].copy_(t)
    return x


def _place_prefill(cfg, dst, t) -> None:
    """Write a prefill's per-token cache contents t (B, S, ...) into the
    cache leaf dst (B, slots, ...), as the reference's ``_cache_from_kv``
    places them: on a ring shorter than S (a sliding window) the last
    ``slots`` tokens, token j at slot j % slots (the tail rolled by S %
    slots); otherwise slots [0, S) with zero headroom after them (the last
    ``slots`` tokens, unrolled, if there is no window and S > slots)."""
    S, slots = t.shape[1], dst.shape[1]
    if slots >= S:
        dst[:, :S] = t
        return
    tail = t[:, S - slots:]
    r = S % slots if cfg.sliding_window else 0
    dst[:, r:] = tail[:, :slots - r]
    dst[:, :r] = tail[:, slots - r:]


def _attn_prefill(p, cfg, x, cache, window: int, enc_out=None, cross=None):
    """One attention block over x (B, S, d); its K/V or MLA latent land in
    ``cache``, one layer's {"attn": ...}, as ``_place_prefill`` places
    them. A decoder block of an encoder-decoder trunk also attends to
    ``enc_out`` and writes its cross-attention K/V into ``cross`` (its
    layer's {"k", "v"}). Returns x."""
    cross_kv = None
    if enc_out is not None:
        cross_kv = attn.project_kv(p["xattn"], cfg, enc_out)
        for leaf, t in zip(("k", "v"), cross_kv):
            cross[leaf].copy_(t)
    x, _, kv = attn_block_forward(p, cfg, x, window=window, cross_kv=cross_kv)
    lc = cache["attn"]
    for leaf, t in zip(lc, kv):  # (k, v) or (c, kr)
        _place_prefill(cfg, lc[leaf], t)
    return x


def prefill(params, cfg, tokens, prefix_embeds=None, *,
            window: Optional[int] = None, max_len: Optional[int] = None):
    """Full-sequence causal pass that also fills the cache: each layer's
    K/V or MLA latent, or its final SSM state and conv tails; a hybrid's
    too, the shared block's K/V once an application; an encoder-decoder's
    cross K/V once a decoder layer.

    ``prefix_embeds`` are a vision trunk's patch embeddings, put before the
    tokens (S counts them), or an encoder-decoder's frame embeddings, which
    the encoder reads. ``max_len`` sizes an attention cache with decode
    headroom (defaults to S); slots [S, max_len) stay zero. Returns
    (hidden (B, S, d), cache).
    """
    _check_family(cfg)
    win = cfg.sliding_window if window is None else window
    enc_out = None
    if cfg.is_encoder_decoder:
        if prefix_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder trunk needs "
                             "prefix_embeds, the encoder's frame embeddings")
        enc_out = _run_encoder(params, cfg, _front(params, cfg, prefix_embeds))
        x = embed_tokens(params, cfg, tokens)
    else:
        x = embed_tokens(params, cfg, tokens, prefix_embeds)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, max_len or S, device=x.device)
    if enc_out is not None and enc_out.shape[1] != cfg.encoder_seq_len:
        # the cross cache follows the frames given, as the reference's
        n, _, _, Hkv, D = cache["cross"]["k"].shape
        cache["cross"] = {k: torch.zeros((n, B, enc_out.shape[1], Hkv, D),
                                         dtype=v.dtype, device=v.device)
                          for k, v in cache["cross"].items()}
    if cfg.family == "ssm":
        x = _ssm_prefill(params["layers"], cache["layers"], cfg, x)
    elif cfg.family == "hybrid":
        for g in range(_hybrid_dims(cfg)[1]):
            x = _ssm_prefill(layer(params["groups"], g),
                             layer(cache["groups"], g), cfg, x)
            x = _attn_prefill(params["shared"], cfg, x,
                              layer(cache["shared"], g), win)
        if "tail" in params:
            x = _ssm_prefill(params["tail"], cache["tail"], cfg, x)
    else:
        for name, n in _stacks(cfg):
            for i in range(n):  # an encoder-decoder's one stack, "layers"
                cross = (None if enc_out is None
                         else layer(cache["cross"], i))
                x = _attn_prefill(layer(params[name], i), cfg, x,
                                  layer(cache[name], i), win, enc_out, cross)
    return x_final(params, cfg, x), cache


def ssm_stack_decode(params, cfg, x, cache):
    """One token through the Mamba2 layers of one stack, each on its slice
    of ``cache`` (updated in place); the recurrence needs no position.
    Returns x."""
    for i in range(_depth(params)):
        x, _ = ssm_block_decode(layer(params, i), cfg, x, layer(cache, i))
    return x


def decode_step(params, cfg, cache, token, pos, *, window: Optional[int] = None):
    """One autoregressive step. token: (B, 1) integer ids; pos: an int
    (every row at the same position) or a (B,) int32 tensor (per-row
    positions). An encoder-decoder's blocks also attend to the cache's
    ``"cross"``, which its prefill filled. Updates ``cache`` in place;
    returns (hidden (B, 1, d), cache).
    """
    win = cfg.sliding_window if window is None else window
    x = embed_tokens(params, cfg, token)
    if cfg.family == "ssm":
        x = ssm_stack_decode(params["layers"], cfg, x, cache["layers"])
        return x_final(params, cfg, x), cache
    if cfg.family == "hybrid":
        for g in range(_hybrid_dims(cfg)[1]):
            x = ssm_stack_decode(layer(params["groups"], g), cfg, x,
                                 layer(cache["groups"], g))
            x, _ = attn_block_decode(params["shared"], cfg, x,
                                     layer(cache["shared"], g), pos,
                                     window=win)
        if "tail" in params:
            x = ssm_stack_decode(params["tail"], cfg, x, cache["tail"])
        return x_final(params, cfg, x), cache
    for name, n in _stacks(cfg):
        for i in range(n):
            cross = layer(cache["cross"], i) if "cross" in cache else None
            x, _ = attn_block_decode(layer(params[name], i), cfg, x,
                                     layer(cache[name], i), pos, window=win,
                                     cross=cross)
    return x_final(params, cfg, x), cache
