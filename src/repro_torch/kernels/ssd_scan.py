"""K6 on the card: the chunked Mamba2 SSD scan, ``csrc/ssd_scan_bf16.cu``
(bf16, chunk-parallel on the tensor cores) and ``csrc/ssd_scan.cu`` (fp32,
the parity path, a block a (row, head) on the CUDA cores).

The hand-written CUDA kernels that replace
``repro/kernels/ssd_scan.py::ssd_scan_pallas``. Unlike the TPU kernel they
also return the final state, which prefill puts in the decode cache. The
bf16 kernel runs in three launches (chunk-local states and C.B^T, the carry
over the chunks, the outputs); one call of ``ssd_scan_cuda`` is one launch
of K6. Its plain version is ``ref.ssd_scan_ref`` (the algorithm of
``repro/models/ssm.py::ssd_chunked``); ``ops.ssd_scan`` picks between the
two by the device of the tensors it is given.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

HEAD_DIM = 64  # P, the head width of every Mamba2 config
STATE_DIMS = (16, 32, 64, 128)  # N the kernel is instantiated for
MAX_CHUNK = 128
LIBRARIES = {torch.float32: "ssd_scan",
             torch.bfloat16: "ssd_scan_bf16"}  # csrc/<name>.cu


def scratch_floats(B: int, S: int, H: int, N: int, chunk: int) -> int:
    """fp32 scratch of one bf16 call: the chunk states (B, nc, H, 64, N),
    C.B^T (B, nc, 128, 128) and the chunk totals (B, nc, H), nc = S /
    chunk. The fp32 kernel takes none."""
    nc = S // chunk
    return B * nc * (H * HEAD_DIM * N + MAX_CHUNK * MAX_CHUNK + H)


def check_inputs(x, dt, A_log, B_mat, C_mat, D_vec, *, chunk: int) -> None:
    """Raise ``ValueError`` on anything the kernel does not take. Both
    routes refuse a sequence that is not a whole number of chunks, as
    ``ssd_chunked``'s assert does."""
    named = (("x", x), ("dt", dt), ("A_log", A_log), ("B_mat", B_mat),
             ("C_mat", C_mat), ("D_vec", D_vec))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"ssd_scan: {name} must be a tensor, got "
                             f"{type(t).__name__}")
        if t.device != x.device:
            raise ValueError("ssd_scan: every input must share x's device")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    for name, t in (("x", x), ("B_mat", B_mat), ("C_mat", C_mat)):
        if t.data_ptr() % 16:  # staged 16 bytes a load
            raise ValueError(f"ssd_scan: {name} must be 16-byte aligned")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan: x is {x.dtype}; the kernel takes "
                         "float32 or bfloat16")
    for name, t in (("B_mat", B_mat), ("C_mat", C_mat)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_scan: {name} is {t.dtype}, x {x.dtype}; "
                             "they must share a dtype")
    for name, t in (("dt", dt), ("A_log", A_log), ("D_vec", D_vec)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan: {name} is {t.dtype}; it must be "
                             "float32")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1] if B_mat.dim() == 3 else -1
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A_log.shape) != (H,)
            or tuple(D_vec.shape) != (H,) or tuple(B_mat.shape) != (Bsz, S, N)
            or tuple(C_mat.shape) != (Bsz, S, N)):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A_log "
            f"{tuple(A_log.shape)}, B {tuple(B_mat.shape)}, C "
            f"{tuple(C_mat.shape)} and D {tuple(D_vec.shape)} do not match")
    if P != HEAD_DIM:
        raise ValueError(f"ssd_scan: head width {P}; the kernel takes "
                         f"{HEAD_DIM}")
    if N not in STATE_DIMS:
        raise ValueError(f"ssd_scan: state width {N} not in {STATE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if S < 1 or S % chunk:
        raise ValueError(f"ssd_scan: seq {S} % chunk {chunk} != 0")
    if Bsz < 1 or H < 1 or Bsz * S * H * P >= 2**31:
        raise ValueError(f"ssd_scan: shape {tuple(x.shape)} is empty or "
                         "exceeds int32 indexing")


def _kernel(name: str):
    fn = getattr(_build.library(name), f"{name}_fwd")
    if fn.argtypes is None:
        n_ptr = 9 if name == "ssd_scan_bf16" else 8  # + the scratch
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(x, dt, A_log, B_mat, C_mat, D_vec, *, chunk: int):
    """Launch K6 on ``x``'s card: x (B, S, H, 64), dt (B, S, H) fp32, A_log
    and D_vec (H,) fp32, B_mat/C_mat (B, S, N) in x's dtype -> ``(y,
    final_state)``, y (B, S, H, 64) in x's dtype and the state (B, H, 64, N)
    fp32. Raises on CPU tensors and on any input the kernel does not take;
    a refused launch raises too."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda: tensors are on {x.device}, not on "
                         "a CUDA device")
    check_inputs(x, dt, A_log, B_mat, C_mat, D_vec, chunk=chunk)
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    name = LIBRARIES[x.dtype]
    fn = _kernel(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [x.data_ptr(), dt.data_ptr(), A_log.data_ptr(),
                B_mat.data_ptr(), C_mat.data_ptr(), D_vec.data_ptr(),
                y.data_ptr(), state.data_ptr()]
        if name == "ssd_scan_bf16":
            work = torch.empty(scratch_floats(Bsz, S, H, N, int(chunk)),
                               dtype=torch.float32, device=x.device)
            ptrs.append(work.data_ptr())
        rc = fn(*ptrs, Bsz, S, H, P, N, int(chunk), stream)
    if rc != 0:
        msg = _build.error_string(name, rc)
        raise RuntimeError(f"ssd_scan kernel launch failed: {msg} "
                           f"(CUDA error {rc})")
    return y, state
