"""K3 on the card: prefill flash attention, ``csrc/flash_attention_bf16.cu``
(bf16, on the tensor cores) and ``csrc/flash_attention.cu`` (fp32, the
parity path).

The hand-written CUDA kernels that replace
``repro/kernels/flash_attention.py::flash_attention_pallas``. As the TPU
kernel does, they take v narrower or wider than q and k (MLA prefill: q/k
96 wide and v 64 for minicpm3-4b, 192 and 128 for deepseek-v2) and write
the output as wide as v. Asked for it, they also write each row's
log-sum-exp (B, Sq, H) in fp32, what the backward of ``ops.flash_attention``
recomputes the probabilities from; the output's bits do not depend on it.
Its plain version is ``ref.flash_attention_ref``; ``ops.flash_attention``
picks between the two by the device of the tensors it is given.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 48, 64, 96, 112, 128, 192)  # q/k widths instantiated
V_DIMS = (32, 64, 112, 128)  # v widths, each with every q/k width
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LIBRARIES = {torch.float32: "flash_attention",
             torch.bfloat16: "flash_attention_bf16"}  # csrc/<name>.cu


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
    if tuple(k.shape[:3]) != tuple(v.shape[:3]):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ before the last dim")
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads do not group over "
                         f"{Hkv} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if v.shape[3] not in V_DIMS:
        raise ValueError(f"flash_attention: v width {v.shape[3]} not in "
                         f"{V_DIMS}")
    if Sq < 1 or Sk < 1:
        raise ValueError("flash_attention: empty sequence")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")


def _kernel(name: str):
    fn = getattr(_build.library(name), f"{name}_fwd")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         scale=None, return_lse: bool = False):
    """Launch K3 on ``q``'s card: q (B, Sq, H, D), k (B, Sk, Hkv, D), v
    (B, Sk, Hkv, Dv) -> (B, Sq, H, Dv) in q's dtype; with ``return_lse``
    also the rows' log-sum-exp (B, Sq, H) fp32. Raises on CPU tensors and
    on any input the kernel does not take; a refused launch raises too."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: tensors are on {q.device}, "
                         "not on a CUDA device")
    check_inputs(q, k, v, window=window)
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    name = LIBRARIES[q.dtype]
    fn = _kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, Sk, H, Hkv,
                D, Dv, int(bool(causal)), int(window), float(scale), stream)
    if rc != 0:
        msg = _build.error_string(name, rc)
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"(CUDA error {rc})")
    return (out, lse) if return_lse else out
