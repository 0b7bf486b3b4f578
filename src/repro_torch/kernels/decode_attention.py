"""K4 on the card: single-token decode attention, ``csrc/decode_attention.cu``.

The hand-written CUDA kernel that replaces
``repro/kernels/decode_attention.py::decode_attention_pallas``, extended
to a per-row ``(B,)`` position besides the scalar one. Its plain version
is ``ref.decode_attention_ref``; ``ops.decode_attention`` picks between
the two by the device of the tensors it is given.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS

GMAX = 16  # most query heads per KV head the kernel's shared memory holds


def check_inputs(q, k_cache, v_cache, pos) -> None:
    """Raise ``ValueError`` on anything the kernel does not take."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype not in DTYPES:
            raise ValueError(f"decode_attention: {name} is {t.dtype}; the "
                             "kernel takes float32 or bfloat16")
        if t.dtype != q.dtype:
            raise ValueError("decode_attention: q and the caches must share "
                             "a dtype")
        if t.device != q.device:
            raise ValueError("decode_attention: q and the caches must share "
                             "a device")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte "
                             "aligned")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention: q must be (B, H, D) and the "
                         f"caches (B, S, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    if tuple(k_cache.shape) != tuple(v_cache.shape):
        raise ValueError("decode_attention: k_cache and v_cache differ in "
                         "shape")
    B, H, D = q.shape
    Bc, S, Hkv, Dc = k_cache.shape
    if Bc != B or Dc != D:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match the cache {tuple(k_cache.shape)}")
    if Hkv < 1 or H % Hkv or H // Hkv > GMAX:
        raise ValueError(f"decode_attention: {H} query heads over {Hkv} KV "
                         f"heads (at most {GMAX} a KV head)")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {D} not in {HEAD_DIMS}")
    if S < 1:
        raise ValueError("decode_attention: empty cache")
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
            raise ValueError(f"decode_attention: a tensor pos must be int32 "
                             f"of shape ({B},), got {pos.dtype} "
                             f"{tuple(pos.shape)}")
        if pos.device != q.device or not pos.is_contiguous():
            raise ValueError("decode_attention: pos must be contiguous on "
                             "q's device")
    elif isinstance(pos, (bool, np.bool_)) or not isinstance(
            pos, (int, np.integer)):
        raise ValueError(f"decode_attention: pos must be an int or a (B,) "
                         f"int32 tensor, got {type(pos).__name__}")
    elif not -2**31 <= int(pos) < 2**31:
        raise ValueError(f"decode_attention: pos {pos} is out of int32 range")


def _kernel():
    fn = _build.library("decode_attention").decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn



def decode_attention_cuda(q, k_cache, v_cache, pos, *, scale=None
                          ) -> torch.Tensor:
    """Launch K4 on ``q``'s card: q (B, H, D), caches (B, S, Hkv, D), pos an
    int or a (B,) int32 tensor -> (B, H, D) in q's dtype. Raises on CPU
    tensors and on any input the kernel does not take; a refused launch
    raises too."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda: tensors are on {q.device}, "
                         "not on a CUDA device")
    check_inputs(q, k_cache, v_cache, pos)
    B, H, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if isinstance(pos, torch.Tensor):
        pos_ptr, pos_scalar = pos.data_ptr(), 0
    else:
        pos_ptr, pos_scalar = None, int(pos)
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                out.data_ptr(), pos_ptr, pos_scalar, B, S, H, Hkv, D,
                DTYPES[q.dtype], float(scale), stream)
    if rc != 0:
        msg = _build.error_string("decode_attention", rc)
        raise RuntimeError(f"decode_attention kernel launch failed: {msg} "
                           f"(CUDA error {rc})")
    return out
