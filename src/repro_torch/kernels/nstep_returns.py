"""K1 on the card: batched n-step returns, ``csrc/nstep_returns.cu``.

The hand-written CUDA kernel that replaces
``repro/kernels/nstep_returns.py::nstep_returns_pallas``. It reads the
trajectory time-major, as the rollout stores it: rewards (T, E) float32,
dones (T, E) bool, bootstrap (E,) float32 -> returns (T, E) float32. Its
plain version is ``ref.nstep_returns_ref``, with the same signature;
``ops.nstep_returns`` picks between the two by the device of the tensors
it is given. The launch shape (``launch_shape``: tile of columns, chunk of
steps) is chosen here and checked again by the C entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, column_scan

MAX_CHUNK = 128  # steps a chunk at most, csrc/nstep_returns.cu: CHUNK


def check_inputs(rewards, dones, bootstrap) -> None:
    """Raise ``ValueError`` on anything the kernel does not take. Returns
    are targets: an input that requires a gradient is refused, so a missing
    ``detach`` shows instead of silently cutting the graph."""
    inputs = (("rewards", rewards, torch.float32), ("dones", dones, torch.bool),
              ("bootstrap", bootstrap, torch.float32))
    for name, t, _ in inputs:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"nstep_returns: {name} must be a tensor, got "
                             f"{type(t).__name__}")
    for name, t, dtype in inputs:
        if t.dtype != dtype:
            raise ValueError(f"nstep_returns: {name} is {t.dtype}; the kernel "
                             f"takes {dtype}")
        if t.device != rewards.device:
            raise ValueError("nstep_returns: rewards, dones and bootstrap must "
                             "share a device")
        if not t.is_contiguous():
            raise ValueError(f"nstep_returns: {name} must be contiguous")
        if t.requires_grad:
            raise ValueError(f"nstep_returns: {name} requires grad; returns "
                             "are targets, detach it first")
    if rewards.dim() != 2 or rewards.shape[0] < 1 or rewards.shape[1] < 1:
        raise ValueError(f"nstep_returns: rewards must be (T, E) with T, E >= "
                         f"1, got {tuple(rewards.shape)}")
    T, E = rewards.shape
    if tuple(dones.shape) != (T, E) or tuple(bootstrap.shape) != (E,):
        raise ValueError(f"nstep_returns: dones {tuple(dones.shape)} and "
                         f"bootstrap {tuple(bootstrap.shape)} must be ({T}, "
                         f"{E}) and ({E},)")
    if T * E >= 2**31:
        raise ValueError(f"nstep_returns: {T} x {E} elements exceed int32")


def launch_shape(T: int, E: int):
    """``(tile, chunk, blocks, smem_bytes)`` of K1 at (T, E): one float
    input beside the dones, chunks of at most 128 steps (at most 217,472
    bytes of shared memory)."""
    return column_scan.launch_shape(T, E, 1, 1, MAX_CHUNK)


def _kernel():
    fn = _build.library("nstep_returns").nstep_returns_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def nstep_returns_cuda(rewards, dones, bootstrap, gamma: float
                       ) -> torch.Tensor:
    """Launch K1 on the tensors' card: rewards (T, E) float32, dones (T, E)
    bool, bootstrap (E,) float32 -> returns (T, E) float32. Raises on any
    input the kernel does not take, on CPU tensors, and when the launch is
    refused."""
    check_inputs(rewards, dones, bootstrap)
    if rewards.device.type != "cuda":
        raise ValueError(f"nstep_returns_cuda: tensors are on "
                         f"{rewards.device}, not on a CUDA device")
    T, E = rewards.shape
    tile, chunk, _, _ = launch_shape(T, E)
    out = torch.empty_like(rewards)
    rc = _build.call_on(rewards.device, _kernel(), rewards.data_ptr(),
                        dones.data_ptr(), bootstrap.data_ptr(),
                        out.data_ptr(), T, E, float(gamma), tile, chunk)
    if rc != 0:
        msg = _build.error_string("nstep_returns", rc)
        raise RuntimeError(f"nstep_returns kernel launch failed: {msg} "
                           f"(CUDA error {rc})")
    return out
