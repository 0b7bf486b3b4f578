"""K5 on the card: absorbed MLA decode attention, ``csrc/mla_decode_bf16.cu``
(bf16, split-K on the tensor cores) and ``csrc/mla_decode.cu`` (fp32, the
parity path, split-K on the CUDA cores).

The hand-written CUDA kernels that replace
``repro/kernels/mla_decode.py::mla_decode_attention_pallas``, extended to a
per-row ``(B,)`` position besides the scalar one and to a ring's
``window``, as K4 is. Both split each
row's cache walk into blocks of ``SPLIT`` slots and merge the splits in a
second kernel (K4's); one call of ``mla_decode_attention_cuda`` is one
launch of K5. Its plain version is ``ref.mla_decode_attention_ref``;
``ops.mla_decode_attention`` picks between the two by the device of the
tensors it is given.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import check_window
from repro_torch.kernels.flash_attention import DTYPES

LATENT_DIMS = (32, 64, 128, 256, 512)  # R the kernel is instantiated for
ROPE_DIMS = (16, 32, 64)  # Rr, each with every R
SPLIT = 64  # cache slots a block of the split kernels (csrc's SPLIT)
LIBRARIES = {torch.float32: "mla_decode",
             torch.bfloat16: "mla_decode_bf16"}  # csrc/<name>.cu


def num_splits(S: int) -> int:
    """Blocks a row's cache of capacity ``S`` is split into: the grid is
    sized from the capacity, never from ``pos``, so ``pos`` stays on the
    card."""
    return -(-S // SPLIT)


def scratch_floats(B: int, S: int, H: int, R: int) -> int:
    """fp32 scratch of one call: each split's (acc[R], m, l) per row and
    head."""
    return B * num_splits(S) * H * (R + 2)


def check_inputs(q_lat, q_rope, c_cache, kr_cache, pos, window: int = 0
                 ) -> None:
    """Raise ``ValueError`` on anything the kernel does not take."""
    named = (("q_lat", q_lat), ("q_rope", q_rope), ("c_cache", c_cache),
             ("kr_cache", kr_cache))
    for name, t in named:
        if t.dtype not in DTYPES:
            raise ValueError(f"mla_decode_attention: {name} is {t.dtype}; the "
                             "kernel takes float32 or bfloat16")
        if t.dtype != q_lat.dtype:
            raise ValueError("mla_decode_attention: the queries and the "
                             "caches must share a dtype")
        if t.device != q_lat.device:
            raise ValueError("mla_decode_attention: the queries and the "
                             "caches must share a device")
        if t.dim() != 3:
            raise ValueError(f"mla_decode_attention: {name} must be 3-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"mla_decode_attention: {name} must be "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"mla_decode_attention: {name} must be 16-byte "
                             "aligned")
    B, H, R = q_lat.shape
    Bc, S, Rc = c_cache.shape
    Rr = q_rope.shape[2]
    if tuple(q_rope.shape[:2]) != (B, H) or Bc != B or Rc != R or tuple(
            kr_cache.shape) != (B, S, Rr):
        raise ValueError(
            f"mla_decode_attention: q_lat {tuple(q_lat.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, c_cache {tuple(c_cache.shape)} and "
            f"kr_cache {tuple(kr_cache.shape)} do not match")
    if R not in LATENT_DIMS:
        raise ValueError(f"mla_decode_attention: latent width {R} not in "
                         f"{LATENT_DIMS}")
    if Rr not in ROPE_DIMS:
        raise ValueError(f"mla_decode_attention: rope width {Rr} not in "
                         f"{ROPE_DIMS}")
    if H < 1 or S < 1:
        raise ValueError("mla_decode_attention: no heads or an empty cache")
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
            raise ValueError(f"mla_decode_attention: a tensor pos must be "
                             f"int32 of shape ({B},), got {pos.dtype} "
                             f"{tuple(pos.shape)}")
        if pos.device != q_lat.device or not pos.is_contiguous():
            raise ValueError("mla_decode_attention: pos must be contiguous "
                             "on q_lat's device")
    elif isinstance(pos, (bool, np.bool_)) or not isinstance(
            pos, (int, np.integer)):
        raise ValueError(f"mla_decode_attention: pos must be an int or a "
                         f"(B,) int32 tensor, got {type(pos).__name__}")
    elif not -2**31 <= int(pos) < 2**31:
        raise ValueError(f"mla_decode_attention: pos {pos} is out of int32 "
                         "range")
    check_window(window, "mla_decode_attention")


def _kernel(name: str):
    fn = getattr(_build.library(name), f"{name}_fwd")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p] \
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mla_decode_attention_cuda(q_lat, q_rope, c_cache, kr_cache, pos,
                              scale: float, window: int = 0) -> torch.Tensor:
    """Launch K5 on ``q_lat``'s card: q_lat (B, H, R), q_rope (B, H, Rr),
    c_cache (B, S, R), kr_cache (B, S, Rr), pos an int or a (B,) int32
    tensor, ``window`` 0 or the ring's window -> (B, H, R) in q_lat's
    dtype. Raises on CPU tensors and on any input the kernel does not take;
    a refused launch raises too."""
    if q_lat.device.type != "cuda":
        raise ValueError(f"mla_decode_attention_cuda: tensors are on "
                         f"{q_lat.device}, not on a CUDA device")
    check_inputs(q_lat, q_rope, c_cache, kr_cache, pos, window)
    B, H, R = q_lat.shape
    S, Rr = kr_cache.shape[1], kr_cache.shape[2]
    if isinstance(pos, torch.Tensor):
        pos_ptr, pos_scalar = pos.data_ptr(), 0
    else:
        pos_ptr, pos_scalar = None, int(pos)
    name = LIBRARIES[q_lat.dtype]
    out = torch.empty_like(q_lat)
    with torch.cuda.device(q_lat.device):
        # each split's (acc[R], m, l), fp32, on the current stream
        part = torch.empty(scratch_floats(B, S, H, R), dtype=torch.float32,
                           device=q_lat.device)
        fn = _kernel(name)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q_lat.data_ptr(), q_rope.data_ptr(), c_cache.data_ptr(),
                kr_cache.data_ptr(), out.data_ptr(), pos_ptr, pos_scalar,
                int(window), part.data_ptr(), num_splits(S), B, S, H, R, Rr,
                float(scale), stream)
    if rc != 0:
        msg = _build.error_string(name, rc)
        raise RuntimeError(f"mla_decode_attention kernel launch failed: {msg} "
                           f"(CUDA error {rc})")
    return out
