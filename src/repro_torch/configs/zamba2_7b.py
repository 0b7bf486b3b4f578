"""Zamba2-7B — hybrid: Mamba2 trunk + one shared attention+MLP block.

[arXiv:2411.15242] 81 Mamba2 layers, d_model 3584, ssm_state 64; a single
shared attention block (32 heads) + MLP (d_ff 14336) applied every 6 Mamba2
layers (one weight copy, per-application KV cache). vocab 32000.

Natively sub-quadratic: runs long_500k (O(1) SSM state; the shared
attention applications use the sliding-window cache there).
"""
from repro_torch.configs.base import ArchConfig, register


@register("zamba2-7b")
def zamba2_7b() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        source="arXiv:2411.15242",
        num_layers=81,
        d_model=3584,
        vocab_size=32000,
        attention="gqa",
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        ssm_state=64,
        ssm_conv=4,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=128,
        shared_attn_every=6,
        supports_long_context=True,
        remat="full",
    )
