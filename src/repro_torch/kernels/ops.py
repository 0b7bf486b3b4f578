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
from repro_torch.kernels.nstep_returns import check_inputs as _check_nstep
from repro_torch.kernels.nstep_returns import nstep_returns_cuda
from repro_torch.kernels.vtrace import check_inputs as _check_vtrace
from repro_torch.kernels.vtrace import vtrace_returns_cuda

launches = {"nstep_returns": 0, "vtrace_returns": 0, "flash_attention": 0,
            "decode_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nstep_returns(rewards, dones, bootstrap, gamma: float):
    """K1. Time-major rewards (T, E) float32, dones (T, E) bool, bootstrap
    (E,) float32 -> returns (T, E) float32. Both routes refuse the same
    inputs."""
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
