"""DBRX-132B — fine-grained MoE: 16 experts, top-4.

[hf:databricks/dbrx-base] 40L, d_model 6144, 48 heads (GQA kv=8),
per-expert d_ff 10752, vocab 100352.
"""
from repro_torch.configs.base import ArchConfig, register


@register("dbrx-132b")
def dbrx_132b() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b",
        family="moe",
        source="hf:databricks/dbrx-base",
        num_layers=40,
        d_model=6144,
        vocab_size=100352,
        attention="gqa",
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        num_experts=16,
        num_experts_per_tok=4,
        moe_d_ff=10752,
        supports_long_context=True,
        remat="full",
    )
