"""Dispatch between the hand-written kernels and their plain versions.

A tensor on the CPU goes to the plain version in ``ref.py``; a tensor on a
CUDA device goes to the hand-written kernel, which launches or raises.
Nothing falls back from one to the other. ``launches`` counts, per kernel,
the launches made through this module, so a run can show that its path
went through the kernels.
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda

launches = {"flash_attention": 0, "decode_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None):
    """K3. q (B, Sq, H, D); k/v (B, Sk, Hkv, D) -> (B, Sq, H, D)."""
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        scale=scale)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               scale=scale)
    launches["flash_attention"] += 1
    return out


def decode_attention(q, k_cache, v_cache, pos, *, scale=None):
    """K4. q (B, H, D); caches (B, S, Hkv, D); pos an int or a (B,) int32
    tensor -> (B, H, D)."""
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k_cache, v_cache, pos, scale=scale)
    out = decode_attention_cuda(q, k_cache, v_cache, pos, scale=scale)
    launches["decode_attention"] += 1
    return out
