"""PAAC two-headed output (paper §4).

A single trunk feeds two output layers: a softmax policy head (one logit per
action — for token-manipulation environments the action space is the
vocabulary) and a single linear value node. The logits are constrained
to (data, ..., model), as the reference's are; off a mesh that changes
nothing.
"""
from __future__ import annotations

from repro_torch.distributed.constraints import constrain
from repro_torch.models.common import dtype_of, init_linear, linear


def init_heads(generator, cfg):
    dtype = dtype_of(cfg.param_dtype)
    p = {}
    if not cfg.tie_policy_head:
        p["policy"] = init_linear(generator, cfg.d_model, cfg.actions(), dtype)
    p["value"] = init_linear(generator, cfg.d_model, 1, dtype, bias=True)
    return p


def apply_heads(p, cfg, hidden, embed=None):
    """hidden: (..., d_model) -> (logits (..., A) fp32, value (...,) fp32)."""
    if cfg.tie_policy_head:
        logits = hidden @ embed.T
    else:
        logits = linear(p["policy"], hidden)
    axes = ("data",) + (None,) * (logits.ndim - 2) + ("model",)
    logits = constrain(logits.float(), *axes)
    value = linear(p["value"], hidden).float()[..., 0]
    return logits, value
