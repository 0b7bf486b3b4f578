"""K3 on the card: prefill flash attention, ``csrc/flash_attention.cu``.

The hand-written CUDA kernel that replaces
``repro/kernels/flash_attention.py::flash_attention_pallas``. Its plain
version is ``ref.flash_attention_ref``; ``ops.flash_attention`` picks
between the two by the device of the tensors it is given.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)  # head widths the kernel is instantiated for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(q, k, v, *, window: int = 0) -> None:
    """Raise ``ValueError`` on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; the "
                             "kernel takes float32 or bfloat16")
        if t.dtype != q.dtype:
            raise ValueError("flash_attention: q, k and v must share a dtype")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v must share a device")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    B, Sq, H, D = q.shape
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads do not group over "
                         f"{Hkv} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if Sq < 1 or Sk < 1:
        raise ValueError("flash_attention: empty sequence")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")


def _kernel():
    fn = _build.library("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn



def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         scale=None) -> torch.Tensor:
    """Launch K3 on ``q``'s card: q (B, Sq, H, D), k/v (B, Sk, Hkv, D) ->
    (B, Sq, H, D) in q's dtype. Raises on CPU tensors and on any input the
    kernel does not take; a refused launch raises too."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: tensors are on {q.device}, "
                         "not on a CUDA device")
    check_inputs(q, k, v, window=window)
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, H, Hkv, D, DTYPES[q.dtype], int(bool(causal)),
                int(window), float(scale), stream)
    if rc != 0:
        msg = _build.error_string("flash_attention", rc)
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"(CUDA error {rc})")
    return out
