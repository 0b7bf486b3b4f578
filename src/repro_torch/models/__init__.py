"""Unified policy/value model API of the port.

The same functional surface as ``repro.models``, for the families ported
so far — the paper's CNNs and MLP (``family == "cnn"``), the dense decoder
with GQA or MLA attention (qwen2-7b, glm4-9b, deepseek-coder-33b,
minicpm3-4b), the MoE decoder with GQA or MLA attention (``family ==
"moe"``: dbrx-132b, deepseek-v2-236b), the Mamba2 SSM (``family ==
"ssm"``, mamba2-370m), the hybrid of Mamba2 groups and one shared
attention block (``family == "hybrid"``, zamba2-7b), the vision decoder
with a prefix of patch embeddings (``family == "vlm"``, pixtral-12b) and
the audio encoder-decoder (``family == "audio"``,
seamless-m4t-large-v2), each with or without a sliding window:

* ``init_policy(cfg, *, generator, device)``           -> params
* ``policy_apply(params, cfg, obs/tokens, prefix_embeds=None, *, train,
  window)`` -> (logits, values, aux): the full pass, the training pass of
  every token family
* ``init_policy_cache(cfg, batch, max_len, *, device)``  -> decode cache
* ``policy_prefill(params, cfg, tokens, prefix_embeds=None, …)``
  -> (logits, values, cache)
* ``policy_decode(params, cfg, cache, tok, pos)`` -> (logits, value, cache)

Logits and values are fp32. ``device`` defaults to ``"cuda"`` and raises
when no CUDA device is present; pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.convnet import cnn_forward, init_cnn
from repro_torch.models.heads import apply_heads, init_heads


def init_policy(cfg, *, generator, device="cuda"):
    """Random parameters drawn from ``generator``, which must live on
    ``device``."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters "
                         f"are asked for on {dev}")
    if cfg.family == "cnn":
        trunk = init_cnn(generator, cfg)
    else:
        trunk = tfm.init_model(generator, cfg)
    return {"trunk": trunk, "heads": init_heads(generator, cfg)}


def policy_apply(params, cfg, obs, prefix_embeds=None, *, train: bool = False,
                 window: Optional[int] = None):
    """Full batched evaluation.

    CNN family: obs (B, *obs_shape) -> (logits (B, A), values (B,), {}).
    Token families: obs = tokens (B, S) -> per-position (logits (B, S', A),
    values (B, S')) and the aux dict of ``transformer.forward``;
    ``prefix_embeds`` as in ``policy_prefill``, ``train`` turns on
    ``cfg.remat``. Differentiable for every family: through K3's backward
    in attention layers and K6's in Mamba2 layers."""
    if cfg.family == "cnn":
        h = cnn_forward(params["trunk"], cfg, obs)
        logits, value = apply_heads(params["heads"], cfg, h)
        return logits, value, {}
    hidden, aux = tfm.forward(params["trunk"], cfg, obs, prefix_embeds,
                              train=train, window=window)
    logits, values = _heads(params, cfg, hidden)
    return logits, values, aux


def init_policy_cache(cfg, batch: int, max_len: int, dtype=None, *,
                      device="cuda"):
    return tfm.init_cache(cfg, batch, max_len, dtype,
                          device=resolve_device(device))


def _heads(params, cfg, hidden):
    embed = params["trunk"]["embed"] if cfg.tie_policy_head else None
    return apply_heads(params["heads"], cfg, hidden, embed)


def policy_prefill(params, cfg, tokens, prefix_embeds=None, *,
                   window: Optional[int] = None,
                   max_len: Optional[int] = None):
    """tokens (B, S) -> (logits (B, S', A), values (B, S'), cache).
    ``prefix_embeds`` (B, S_pre, frontend_dim): a vision trunk's patch
    embeddings, put before the tokens (S' = S_pre + S), or an
    encoder-decoder's frame embeddings, which its encoder reads (S' = S).
    ``window`` (default ``cfg.sliding_window``) limits each query to its
    ``window`` newest keys; ``max_len`` sizes the cache (default S')."""
    hidden, cache = tfm.prefill(params["trunk"], cfg, tokens, prefix_embeds,
                                window=window, max_len=max_len)
    logits, values = _heads(params, cfg, hidden)
    return logits, values, cache


def policy_decode(params, cfg, cache, token, pos, *,
                  window: Optional[int] = None):
    """One decode step: token (B, 1) -> (logits (B, A), value (B,), cache)."""
    hidden, cache = tfm.decode_step(params["trunk"], cfg, cache, token, pos,
                                    window=window)
    logits, value = _heads(params, cfg, hidden)
    return logits[:, 0], value[:, 0], cache
