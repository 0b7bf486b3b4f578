"""DeepSeek-V2 236B — MoE (160 routed experts top-6, 2 shared) with MLA.

[arXiv:2405.04434] 60L, d_model 5120, 128 heads, vocab 102400.
MLA: kv_lora 512, q_lora 1536, qk_nope 128, qk_rope 64, v_head 128.
MoE: per-expert d_ff 1536, first layer dense (d_ff 12288).
"""
from repro_torch.configs.base import ArchConfig, register


@register("deepseek-v2-236b")
def deepseek_v2_236b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        source="arXiv:2405.04434",
        num_layers=60,
        d_model=5120,
        vocab_size=102400,
        attention="mla",
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        d_ff=1536,
        num_experts=160,
        num_experts_per_tok=6,
        num_shared_experts=2,
        moe_d_ff=1536,
        first_dense_layers=1,
        dense_d_ff=12288,
        supports_long_context=True,
        remat="full",
    )
