"""K4 on the card: single-token decode attention, ``csrc/decode_attention.cu``.

The hand-written CUDA kernel that replaces
``repro/kernels/decode_attention.py::decode_attention_pallas``, extended
to a per-row ``(B,)`` position besides the scalar one, and to a ``window``
the TPU kernel does not take (a ring's age mask narrower than the ring). As
the TPU kernel does, it takes a v cache of its own width Dv and writes (B,
H, Dv). It
splits each row's cache walk into blocks of ``SPLIT`` slots and merges the
splits in a second kernel; one call of ``decode_attention_cuda`` is one
launch of K4. Its plain version is ``ref.decode_attention_ref``;
``ops.decode_attention`` picks between the two by the device of the
tensors it is given.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

HEAD_DIMS = (32, 64, 112, 128)  # q/k widths the kernel is instantiated for
V_DIMS = (32, 64, 112, 128)  # v widths, each with every q/k width
GMAX = 16  # most query heads per KV head the kernel's shared memory holds
SPLIT = 64  # cache slots a block of the split kernel (csrc's SPLIT)


def num_splits(S: int) -> int:
    """Blocks a row's cache of capacity ``S`` is split into: the grid is
    sized from the capacity, never from ``pos``, so ``pos`` stays on the
    card."""
    return -(-S // SPLIT)


def check_inputs(q, k_cache, v_cache, pos, window: int = 0) -> None:
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
    if tuple(k_cache.shape[:-1]) != tuple(v_cache.shape[:-1]):
        raise ValueError(f"decode_attention: k_cache {tuple(k_cache.shape)} "
                         f"and v_cache {tuple(v_cache.shape)} differ before "
                         "the last dim")
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
    if v_cache.shape[3] not in V_DIMS:
        raise ValueError(f"decode_attention: v width {v_cache.shape[3]} not "
                         f"in {V_DIMS}")
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
    check_window(window, "decode_attention")


def check_window(window, what: str) -> None:
    """A window is a non-negative int32 (0: no window)."""
    if isinstance(window, (bool, np.bool_)) or not isinstance(
            window, (int, np.integer)) or not 0 <= int(window) < 2**31:
        raise ValueError(f"{what}: window must be an int in [0, 2**31), got "
                         f"{window!r}")


def _kernel():
    fn = _build.library("decode_attention").decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p] \
            + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q, k_cache, v_cache, pos, *, scale=None,
                          window: int = 0) -> torch.Tensor:
    """Launch K4 on ``q``'s card: q (B, H, D), k_cache (B, S, Hkv, D),
    v_cache (B, S, Hkv, Dv), pos an int or a (B,) int32 tensor, ``window``
    0 or the ring's window (``ref.live_slots``) -> (B, H, Dv) in q's dtype.
    Raises on CPU tensors and on any input the kernel does not take; a
    refused launch raises too."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda: tensors are on {q.device}, "
                         "not on a CUDA device")
    check_inputs(q, k_cache, v_cache, pos, window)
    B, H, D = q.shape
    _, S, Hkv, Dv = v_cache.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if isinstance(pos, torch.Tensor):
        pos_ptr, pos_scalar = pos.data_ptr(), 0
    else:
        pos_ptr, pos_scalar = None, int(pos)
    nsplit = num_splits(S)
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        # each split's (acc[Dv], m, l), fp32, on the current stream
        part = torch.empty(B * H * nsplit * (Dv + 2), dtype=torch.float32,
                           device=q.device)
        fn = _kernel()
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                out.data_ptr(), pos_ptr, pos_scalar, int(window),
                part.data_ptr(), nsplit, B, S, H, Hkv, D, Dv,
                DTYPES[q.dtype], float(scale), stream)
    if rc != 0:
        msg = _build.error_string("decode_attention", rc)
        raise RuntimeError(f"decode_attention kernel launch failed: {msg} "
                           f"(CUDA error {rc})")
    return out
