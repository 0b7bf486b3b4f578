"""K2 on the card: batched V-trace targets, ``csrc/vtrace.cu``.

The hand-written CUDA kernel that replaces
``repro/kernels/vtrace.py::vtrace_returns_pallas``. It reads the trajectory
time-major, as the rollout stores it: rewards, values and rho (T, E)
float32, dones (T, E) bool, bootstrap (E,) float32 -> ``(vs, pg_adv)``,
each (T, E) float32. Its plain version is ``ref.vtrace_returns_ref``, with
the same signature; ``ops.vtrace_returns`` picks between the two by the
device of the tensors it is given. The clips ``rho_bar`` and ``c_bar`` may
be ``inf`` (no clip) or any finite value such as 1e9. The launch shape
(``launch_shape``: tile of columns, chunk of steps) is chosen here and
checked again by the C entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, column_scan

MAX_CHUNK = 64  # steps a chunk at most, csrc/vtrace.cu: CHUNK


def check_inputs(rewards, dones, values, bootstrap, rho) -> None:
    """Raise ``ValueError`` on anything the kernel does not take. V-trace
    targets carry no gradient: an input that requires one is refused, so a
    missing ``detach`` shows instead of silently cutting the graph."""
    inputs = (("rewards", rewards, torch.float32), ("dones", dones, torch.bool),
              ("values", values, torch.float32),
              ("bootstrap", bootstrap, torch.float32),
              ("rho", rho, torch.float32))
    for name, t, _ in inputs:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"vtrace_returns: {name} must be a tensor, got "
                             f"{type(t).__name__}")
    for name, t, dtype in inputs:
        if t.dtype != dtype:
            raise ValueError(f"vtrace_returns: {name} is {t.dtype}; the "
                             f"kernel takes {dtype}")
        if t.device != rewards.device:
            raise ValueError("vtrace_returns: rewards, dones, values, "
                             "bootstrap and rho must share a device")
        if not t.is_contiguous():
            raise ValueError(f"vtrace_returns: {name} must be contiguous")
        if t.requires_grad:
            raise ValueError(f"vtrace_returns: {name} requires grad; V-trace "
                             "targets are constants, detach it first")
    if rewards.dim() != 2 or rewards.shape[0] < 1 or rewards.shape[1] < 1:
        raise ValueError(f"vtrace_returns: rewards must be (T, E) with T, E "
                         f">= 1, got {tuple(rewards.shape)}")
    T, E = rewards.shape
    for name, t in (("dones", dones), ("values", values), ("rho", rho)):
        if tuple(t.shape) != (T, E):
            raise ValueError(f"vtrace_returns: {name} {tuple(t.shape)} must "
                             f"be ({T}, {E}) like rewards")
    if tuple(bootstrap.shape) != (E,):
        raise ValueError(f"vtrace_returns: bootstrap "
                         f"{tuple(bootstrap.shape)} must be ({E},)")
    if T * E >= 2**31:
        raise ValueError(f"vtrace_returns: {T} x {E} elements exceed int32")


def launch_shape(T: int, E: int):
    """``(tile, chunk, blocks, smem_bytes)`` of K2 at (T, E): three float
    inputs beside the dones, chunks of at most 64 steps (at most 199,040
    bytes of shared memory)."""
    return column_scan.launch_shape(T, E, 3, 2, MAX_CHUNK)


def _kernel():
    fn = _build.library("vtrace").vtrace_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
            ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def vtrace_returns_cuda(rewards, dones, values, bootstrap, rho, gamma: float,
                        rho_bar: float = 1.0, c_bar: float = 1.0):
    """Launch K2 on the tensors' card: rewards, values, rho (T, E) float32,
    dones (T, E) bool, bootstrap (E,) float32 -> ``(vs, pg_adv)``, each
    (T, E) float32. Raises on any input the kernel does not take, on CPU
    tensors, and when the launch is refused."""
    check_inputs(rewards, dones, values, bootstrap, rho)
    if rewards.device.type != "cuda":
        raise ValueError(f"vtrace_returns_cuda: tensors are on "
                         f"{rewards.device}, not on a CUDA device")
    T, E = rewards.shape
    tile, chunk, _, _ = launch_shape(T, E)
    vs = torch.empty_like(rewards)
    pg_adv = torch.empty_like(rewards)
    rc = _build.call_on(rewards.device, _kernel(), rewards.data_ptr(),
                        dones.data_ptr(), values.data_ptr(), rho.data_ptr(),
                        bootstrap.data_ptr(), vs.data_ptr(),
                        pg_adv.data_ptr(), T, E, float(gamma),
                        float(rho_bar), float(c_bar), tile, chunk)
    if rc != 0:
        msg = _build.error_string("vtrace", rc)
        raise RuntimeError(f"vtrace kernel launch failed: {msg} "
                           f"(CUDA error {rc})")
    return vs, pg_adv
