"""DeepSeek-Coder-33B — dense llama-architecture decoder.

[arXiv:2401.14196] 62L, d_model 7168, 56 heads (GQA kv=8), d_ff 19200,
vocab 32256.
"""
from repro_torch.configs.base import ArchConfig, register


@register("deepseek-coder-33b")
def deepseek_coder_33b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-coder-33b",
        family="dense",
        source="arXiv:2401.14196",
        num_layers=62,
        d_model=7168,
        vocab_size=32256,
        attention="gqa",
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        supports_long_context=True,
        remat="full",
    )
