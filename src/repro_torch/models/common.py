"""Shared model building blocks: initializers, linear layers, norms, RoPE.

Parameters are plain nested dicts of tensors, laid out as in ``repro``:
``x @ w`` with ``w`` shaped (in, out), layer stacks on a leading axis. Every
initializer draws from an explicit ``torch.Generator`` and places its
tensor on that generator's device.
"""
from __future__ import annotations

import math

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Initializers (the reference's distributions; torch draws, not JAX's)
# ---------------------------------------------------------------------------


def dense_init(generator, in_dim: int, out_dim: int, dtype, scale: float = 1.0):
    """LeCun-normal style init used for all projection matrices."""
    std = scale / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=generator,
                    device=generator.device)
    return w.mul_(std).to(dtype)  # in place: one fp32 draw alive, not two


def embed_init(generator, vocab: int, dim: int, dtype):
    w = torch.randn((vocab, dim), generator=generator, device=generator.device)
    return w.mul_(0.02).to(dtype)


def init_linear(generator, in_dim: int, out_dim: int, dtype,
                bias: bool = False, scale: float = 1.0):
    p = {"w": dense_init(generator, in_dim, out_dim, dtype, scale)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=generator.device)
    return p


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, dtype, device):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    """Computed in fp32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies for rotary embedding over ``dim`` channels."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary position embedding (halves convention), in fp32.

    x: (B, S, H, D) or (B, S, D); positions: (S,) or (B, S).
    """
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * inv_freq  # (S, d/2) or (B, S, d/2)
    if angles.dim() == 2:  # (S, d/2) -> broadcast over batch
        angles = angles[None]
    if x.dim() == 4:  # head axis present
        angles = angles[:, :, None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
