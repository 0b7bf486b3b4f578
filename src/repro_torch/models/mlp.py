"""Feed-forward blocks: SwiGLU (llama-style) and GELU (classic)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import init_linear, linear


def init_mlp(generator, d_model: int, d_ff: int, dtype, kind: str = "swiglu"):
    p = {"wi": init_linear(generator, d_model, d_ff, dtype)}
    if kind == "swiglu":
        p["wg"] = init_linear(generator, d_model, d_ff, dtype)
    p["wo"] = init_linear(generator, d_ff, d_model, dtype)
    return p


def mlp_forward(p, x):
    if "wg" in p:
        h = F.silu(linear(p["wi"], x)) * linear(p["wg"], x)
    else:
        h = F.gelu(linear(p["wi"], x), approximate="tanh")
    return linear(p["wo"], h)
