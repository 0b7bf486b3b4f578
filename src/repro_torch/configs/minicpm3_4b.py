"""MiniCPM3-4B — dense decoder with Multi-head Latent Attention.

[hf:openbmb/MiniCPM3-4B] 62L, d_model 2560, 40 heads (kv=40 via MLA),
d_ff 6400, vocab 73448. MLA ranks: q_lora 768, kv_lora 256,
qk_nope 64, qk_rope 32, v_head 64.
"""
from repro_torch.configs.base import ArchConfig, register


@register("minicpm3-4b")
def minicpm3_4b() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b",
        family="dense",
        source="hf:openbmb/MiniCPM3-4B",
        num_layers=62,
        d_model=2560,
        vocab_size=73448,
        attention="mla",
        num_heads=40,
        num_kv_heads=40,
        head_dim=64,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
        d_ff=6400,
        supports_long_context=True,  # via sliding-window variant (long_500k)
        remat="full",
    )
