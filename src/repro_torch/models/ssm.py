"""Mamba2 block via State-Space Duality (SSD), arXiv:2405.21060.

The port's counterpart of ``repro/models/ssm.py``. The projections stay
separate (w_z, w_x, w_B, w_C, w_dt), as the reference lays them out, so its
parameters bridge unchanged. The chunked SSD scan of prefill runs in kernel
K6 through ``repro_torch.kernels.ops.ssd_scan`` (its plain version,
``ssd_chunked``'s algorithm, on the CPU), which also returns the final state
for the decode cache; with a gradient it runs through ``ops.SSDScan`` (K6
forward, the plain backward). Decode is the O(1) recurrent form, plain
PyTorch as in the reference: the state (B, H, P, N) fp32 plus (K-1)-deep
causal conv buffers, updated in place in the cache, as ``gqa_decode``
updates its KV. ``dt_bias``, ``A_log`` and ``D`` stay fp32 leaves in a bf16
model, and take their gradients in fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import (init_linear, init_rmsnorm, linear,
                                       rmsnorm)


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    return d_inner, H, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba2(generator, cfg, dtype):
    d_inner, H, P, N = _dims(cfg)
    K = cfg.ssm_conv
    device = generator.device
    # dt bias initialised so softplus(dt_bias) spans [1e-3, 1e-1]
    u = torch.rand((H,), generator=generator, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))

    def conv(width):
        w = torch.randn((K, width), generator=generator, device=device)
        return (w / math.sqrt(K)).to(dtype)

    return {
        "w_z": init_linear(generator, cfg.d_model, d_inner, dtype),
        "w_x": init_linear(generator, cfg.d_model, d_inner, dtype),
        "w_B": init_linear(generator, cfg.d_model, N, dtype),
        "w_C": init_linear(generator, cfg.d_model, N, dtype),
        "w_dt": init_linear(generator, cfg.d_model, H, dtype),
        "conv_x": conv(d_inner),
        "conv_B": conv(N),
        "conv_C": conv(N),
        "dt_bias": dt_bias.float(),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "norm": init_rmsnorm(d_inner, dtype, device),
        "out_proj": init_linear(
            generator, d_inner, cfg.d_model, dtype,
            scale=1.0 / math.sqrt(2 * max(cfg.num_layers, 1))),
    }


def _causal_conv(x, w):
    """x: (B, S, C); w: (K, C) depthwise causal conv."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))


def _tail(x, n: int):
    """The last ``n`` steps of x (B, S, C), zero-padded on the left when
    S < n, as the causal conv sees them."""
    return F.pad(x, (0, 0, n, 0))[:, -n:, :]


def mamba2_forward(p, cfg, x, *, return_state: bool = False):
    """Full-sequence Mamba2 block. x: (B, S, d_model). With
    ``return_state`` also returns (final state (B, H, P, N) fp32, the conv
    tails (x, B, C) of the last K-1 pre-conv steps) for the decode cache.
    S must be a multiple of the chunk when it is longer than one."""
    Bsz, S, _ = x.shape
    d_inner, H, P, N = _dims(cfg)
    z = linear(p["w_z"], x)
    xr = linear(p["w_x"], x)
    Br = linear(p["w_B"], x)
    Cr = linear(p["w_C"], x)
    dt = linear(p["w_dt"], x)
    xs = F.silu(_causal_conv(xr, p["conv_x"]))
    Bm = F.silu(_causal_conv(Br, p["conv_B"]))
    Cm = F.silu(_causal_conv(Cr, p["conv_C"]))
    dt = F.softplus(dt.float() + p["dt_bias"])
    y, state = ops.ssd_scan(xs.reshape(Bsz, S, H, P), dt, p["A_log"], Bm, Cm,
                            p["D"], chunk=min(cfg.ssm_chunk, S))
    y = y.reshape(Bsz, S, d_inner) * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = linear(p["out_proj"], y)
    if return_state:
        K = cfg.ssm_conv
        tails = (_tail(xr, K - 1), _tail(Br, K - 1), _tail(Cr, K - 1))
        return out, (state, tails)
    return out


def init_mamba2_cache(cfg, batch: int, dtype, device):
    d_inner, H, P, N = _dims(cfg)
    K = cfg.ssm_conv
    return {
        "conv_x": torch.zeros((batch, K - 1, d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, K - 1, N), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, K - 1, N), dtype=dtype, device=device),
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
    }


def _conv_step(buf, new, w):
    """Ring conv step. buf: (B, K-1, C); new: (B, C); w: (K, C)."""
    win = torch.cat([buf, new[:, None, :]], dim=1)  # (B, K, C)
    out = torch.einsum("bkc,kc->bc", win, w)
    return out, win[:, 1:, :]


def mamba2_decode(p, cfg, x, cache):
    """Single-token recurrent step. x: (B, 1, d_model); ``cache`` is one
    layer's {"conv_x", "conv_B", "conv_C", "state"}, updated in place.
    Every op is per row. Returns (out (B, 1, d_model), cache)."""
    Bsz = x.shape[0]
    d_inner, H, P, N = _dims(cfg)
    x0 = x[:, 0, :]
    z = linear(p["w_z"], x0)
    xr = linear(p["w_x"], x0)
    Br = linear(p["w_B"], x0)
    Cr = linear(p["w_C"], x0)
    dt = linear(p["w_dt"], x0)
    xs, ncx = _conv_step(cache["conv_x"], xr, p["conv_x"])
    Bm, ncB = _conv_step(cache["conv_B"], Br, p["conv_B"])
    Cm, ncC = _conv_step(cache["conv_C"], Cr, p["conv_C"])
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, H)
    lam = torch.exp(-torch.exp(p["A_log"])[None, :] * dt)  # (B, H)
    xh = xs.reshape(Bsz, H, P).float()
    upd = (dt[:, :, None] * xh)[..., None] * Bm.float()[:, None, None, :]
    state = cache["state"] * lam[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype) * F.silu(z)[:, None, :]
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    cache["conv_x"].copy_(ncx)
    cache["conv_B"].copy_(ncB)
    cache["conv_C"].copy_(ncC)
    cache["state"].copy_(state)
    return linear(p["out_proj"], y), cache
