"""Pixtral-12B — VLM: Pixtral-ViT front-end (STUB) + Mistral-NeMo decoder.

[hf:mistralai/Pixtral-12B-2409] 40L, d_model 5120, 32 heads (GQA kv=8),
d_ff 14336, vocab 131072. The ViT is a stub: the caller passes precomputed
patch embeddings (B, 1024, 1024) as ``prefix_embeds``, fed through the
multimodal projector (``frontend_proj``); the language decoder is
implemented in full.
"""
from repro_torch.configs.base import ArchConfig, register


@register("pixtral-12b")
def pixtral_12b() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        family="vlm",
        source="hf:mistralai/Pixtral-12B-2409",
        num_layers=40,
        d_model=5120,
        vocab_size=131072,
        attention="gqa",
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        modality="vision",
        prefix_len=1024,
        frontend_dim=1024,
        supports_long_context=True,
        remat="full",
    )
