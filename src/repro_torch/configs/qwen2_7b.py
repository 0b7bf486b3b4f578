"""Qwen2-7B — dense decoder, GQA kv=4, QKV bias.

[arXiv:2407.10671] 28L, d_model 3584, 28 heads, d_ff 18944, vocab 152064.
"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen2-7b")
def qwen2_7b() -> ArchConfig:
    return ArchConfig(
        name="qwen2-7b",
        family="dense",
        source="arXiv:2407.10671",
        num_layers=28,
        d_model=3584,
        vocab_size=152064,
        attention="gqa",
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        qkv_bias=True,
        d_ff=18944,
        supports_long_context=True,
        remat="full",
    )
