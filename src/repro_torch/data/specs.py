"""Input stand-ins for every (architecture × input shape) of the dry-run
(a port of ``repro.data.specs``).

Each stand-in is a tensor on the ``meta`` device: it has the reference's
shape and dtype (int32 tokens, float32 rewards and embeddings, bool
dones) and allocates nothing. The modality front ends (audio frames,
vision patches) are stubs: they are precomputed embeddings of the right
shape, as in the reference.

Batch layout per shape kind:

* ``train``   — a PAAC trajectory batch: one sequence is one actor's
  ``t_max``-step trajectory (paper Algorithm 1 lines 4-10), so the train
  step receives tokens (B, S+1) [obs + actions], per-step rewards and
  episode-done flags.
* ``prefill`` — batched policy evaluation over full contexts.
* ``decode``  — the master's batched action selection (paper §3): one new
  token per actor against a KV/state cache of ``seq_len``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig

F32 = torch.float32
I32 = torch.int32


def step_kind(shape_name: str) -> str:
    return INPUT_SHAPES[shape_name].kind


def _text_len(cfg: ArchConfig, seq_len: int) -> int:
    """Token positions available after the multimodal prefix."""
    return seq_len - cfg.prefix_len


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _front_ends(cfg: ArchConfig, B: int) -> Dict[str, torch.Tensor]:
    width = cfg.frontend_dim or cfg.d_model
    specs = {}
    if cfg.modality == "vision":
        specs["prefix"] = _sd((B, cfg.prefix_len, width), F32)
    if cfg.is_encoder_decoder:
        specs["frames"] = _sd((B, cfg.encoder_seq_len, width), F32)
    return specs


def input_specs(cfg: ArchConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """Model inputs for one (arch, shape) pair as ``meta`` tensors."""
    shp = INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    if shp.kind == "train":
        T = _text_len(cfg, S)
        return {"tokens": _sd((B, T + 1), I32), "rewards": _sd((B, T), F32),
                "dones": _sd((B, T), torch.bool), **_front_ends(cfg, B)}
    if shp.kind == "prefill":
        return {"tokens": _sd((B, _text_len(cfg, S)), I32),
                **_front_ends(cfg, B)}
    # decode: one token per actor; the cache is made separately by
    # init_policy_cache in the dry-run
    return {"token": _sd((B, 1), I32)}
