"""GLM4-9B — dense decoder, RoPE, extreme GQA (kv=2).

[hf:THUDM/glm-4-9b] 40L, d_model 4096, 32 heads (GQA kv=2), d_ff 13696,
vocab 151552, QKV bias.
"""
from repro_torch.configs.base import ArchConfig, register


@register("glm4-9b")
def glm4_9b() -> ArchConfig:
    return ArchConfig(
        name="glm4-9b",
        family="dense",
        source="hf:THUDM/glm-4-9b",
        num_layers=40,
        d_model=4096,
        vocab_size=151552,
        attention="gqa",
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        qkv_bias=True,
        d_ff=13696,
        supports_long_context=True,
        remat="full",
    )
