"""Dispatch between the hand-written kernels and their plain versions.

A tensor on the CPU goes to the plain version in ``ref.py``; a tensor on a
CUDA device goes to the hand-written kernel, which launches or raises.
Nothing falls back from one to the other. ``launches`` counts, per kernel,
the launches made through this module, so a run can show that its path
went through the kernels.

K3 is differentiable: when grad mode is on and q, k or v needs a gradient,
``flash_attention`` runs through ``FlashAttention``, whose forward is K3
writing each row's log-sum-exp too (the plain version on the CPU) and whose
backward is ``ref.flash_attention_bwd``, plain tensor algebra, as the
reference's custom VJP is plain XLA (F4: the TPU kernel has no backward).
K6 is differentiable the same way: ``ssd_scan`` runs through ``SSDScan``,
whose forward is K6 (the plain version on the CPU) and whose backward is
``ref.ssd_scan_bwd``, autograd through the plain version recomputed with
its exponents in float64 and its decay masked before ``exp`` (F21), as the
reference differentiates ``ssd_chunked`` with XLA's autodiff.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.mla_decode import mla_decode_attention_cuda
from repro_torch.kernels.nstep_returns import check_inputs as _check_nstep
from repro_torch.kernels.nstep_returns import nstep_returns_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.kernels.vtrace import check_inputs as _check_vtrace
from repro_torch.kernels.vtrace import vtrace_returns_cuda

launches = {"nstep_returns": 0, "vtrace_returns": 0, "flash_attention": 0,
            "decode_attention": 0, "mla_decode_attention": 0, "ssd_scan": 0}
# calls of each kernel's backward (plain tensor algebra, not a launch)
backward_calls = {"flash_attention": 0, "ssd_scan": 0}


def reset_launches() -> None:
    for counts in (launches, backward_calls):
        for name in counts:
            counts[name] = 0


def _by_columns(fn, rewards, dones, bootstrap):
    """``fn`` on each device's columns of DTensor inputs (the dry-run's):
    K1 computes each column alone, so the env axis may be split over the
    mesh (rewards' ``Shard(1)``, the bootstrap's ``Shard(0)``) and every
    other mesh dim is replicated. Returns a DTensor placed as the columns
    were."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    mesh = rewards.device_mesh
    cols = tuple(Shard(1) if p == Shard(1) else Replicate()
                 for p in rewards.placements)
    vec = tuple(Shard(0) if p == Shard(1) else Replicate() for p in cols)

    def local(x, placements):
        if isinstance(x, DTensor):
            return x.redistribute(mesh, placements).to_local()
        return distribute_tensor(x, mesh, placements).to_local()

    out = fn(local(rewards, cols), local(dones, cols),
             local(bootstrap, vec))
    return DTensor.from_local(out, mesh, cols, shape=rewards.shape,
                              stride=rewards.stride())


def nstep_returns(rewards, dones, bootstrap, gamma: float):
    """K1. Time-major rewards (T, E) float32, dones (T, E) bool, bootstrap
    (E,) float32 -> returns (T, E) float32. Both routes refuse the same
    inputs. DTensors (the dry-run's) run on each device's columns."""
    if hasattr(rewards, "device_mesh"):
        return _by_columns(lambda r, d, b: nstep_returns(r, d, b, gamma),
                           rewards, dones, bootstrap)
    if rewards.device.type == "cpu":
        _check_nstep(rewards, dones, bootstrap)
        return _ref.nstep_returns_ref(rewards, dones, bootstrap, gamma)
    out = nstep_returns_cuda(rewards, dones, bootstrap, gamma)
    launches["nstep_returns"] += 1
    return out


def vtrace_returns(rewards, dones, values, bootstrap, rho, gamma: float,
                   rho_bar: float = 1.0, c_bar: float = 1.0):
    """K2. Time-major rewards, values, rho (T, E) float32, dones (T, E)
    bool, bootstrap (E,) float32 -> ``(vs, pg_adv)``, each (T, E) float32.
    Both routes refuse the same inputs."""
    if rewards.device.type == "cpu":
        _check_vtrace(rewards, dones, values, bootstrap, rho)
        return _ref.vtrace_returns_ref(rewards, dones, values, bootstrap, rho,
                                       gamma, rho_bar, c_bar)
    out = vtrace_returns_cuda(rewards, dones, values, bootstrap, rho, gamma,
                              rho_bar, c_bar)
    launches["vtrace_returns"] += 1
    return out


def _flash_attention(q, k, v, causal, window, scale, return_lse=False):
    """K3 on q's device: the kernel (counted) on a CUDA tensor, the plain
    version on a CPU one."""
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        scale=scale, return_lse=return_lse)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               scale=scale, return_lse=return_lse)
    launches["flash_attention"] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """K3 with a gradient: the forward keeps (q, k, v, out, lse) and the
    backward recomputes each block's probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = _flash_attention(q, k, v, causal, window, scale,
                                    return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = {"causal": causal, "window": window, "scale": scale}
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ref.flash_attention_bwd(q, k, v, out, lse, d_out,
                                              **ctx.opts)
        backward_calls["flash_attention"] += 1
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None):
    """K3. q (B, Sq, H, D); k (B, Sk, Hkv, D); v (B, Sk, Hkv, Dv) ->
    (B, Sq, H, Dv). Differentiable through ``FlashAttention`` when one of
    q, k, v needs a gradient; otherwise the launch writes no LSE."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return _flash_attention(q, k, v, causal, window, scale)


def decode_attention(q, k_cache, v_cache, pos, *, scale=None,
                     window: int = 0):
    """K4. q (B, H, D); k_cache (B, S, Hkv, D); v_cache (B, S, Hkv, Dv);
    pos an int or a (B,) int32 tensor; ``window`` > 0 keeps the ring's
    slots younger than it (``ref.live_slots``) -> (B, H, Dv)."""
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k_cache, v_cache, pos, scale=scale,
                                         window=window)
    out = decode_attention_cuda(q, k_cache, v_cache, pos, scale=scale,
                                window=window)
    launches["decode_attention"] += 1
    return out


def mla_decode_attention(q_lat, q_rope, c_cache, kr_cache, pos, scale: float,
                         window: int = 0):
    """K5. Absorbed queries q_lat (B, H, R) and q_rope (B, H, Rr); latent
    cache c (B, S, R) and roped keys kr (B, S, Rr); pos an int or a (B,)
    int32 tensor; ``window`` as in ``decode_attention`` -> the latent
    output (B, H, R)."""
    if q_lat.device.type == "cpu":
        return _ref.mla_decode_attention_ref(q_lat, q_rope, c_cache, kr_cache,
                                             pos, scale, window)
    out = mla_decode_attention_cuda(q_lat, q_rope, c_cache, kr_cache, pos,
                                    scale, window)
    launches["mla_decode_attention"] += 1
    return out


def _ssd_scan(x, dt, A_log, B_mat, C_mat, D_vec, chunk):
    """K6 on x's device: the kernel (counted) on a CUDA tensor, the plain
    version on a CPU one."""
    if x.device.type == "cpu":
        return _ref.ssd_scan_ref(x, dt, A_log, B_mat, C_mat, D_vec,
                                 chunk=chunk)
    out = ssd_scan_cuda(x, dt, A_log, B_mat, C_mat, D_vec, chunk=chunk)
    launches["ssd_scan"] += 1
    return out


class SSDScan(torch.autograd.Function):
    """K6 with a gradient: the forward keeps its six inputs and the
    backward recomputes the plain version from them."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B_mat, C_mat, D_vec, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A_log, B_mat, C_mat, D_vec)
        ctx.chunk = chunk
        return _ssd_scan(x, dt, A_log, B_mat, C_mat, D_vec, chunk)

    @staticmethod
    def backward(ctx, d_y, d_state):
        grads = _ref.ssd_scan_bwd(*ctx.saved_tensors, d_y, d_state,
                                  chunk=ctx.chunk)
        backward_calls["ssd_scan"] += 1
        return grads + (None,)


def ssd_scan(x, dt, A_log, B_mat, C_mat, D_vec, *, chunk: int):
    """K6. x (B, S, H, P); dt (B, S, H) fp32; A_log, D_vec (H,) fp32;
    B_mat/C_mat (B, S, N) -> ``(y (B, S, H, P), final state (B, H, P, N)
    fp32)``. S must be a multiple of ``chunk`` on both routes.
    Differentiable through ``SSDScan`` when one of the inputs needs a
    gradient; otherwise the launch is the same as without one."""
    args = (x, dt, A_log, B_mat, C_mat, D_vec)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SSDScan.apply(*args, chunk)
    return _ssd_scan(*args, chunk)
