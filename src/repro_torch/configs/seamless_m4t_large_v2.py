"""SeamlessM4T-large v2 — encoder-decoder speech/text transformer backbone.

[arXiv:2308.11596] 24L enc + 24L dec, d_model 1024, 16 heads, d_ff 8192,
vocab 256206. The mel-spectrogram + conformer speech front-end is a stub:
the caller passes precomputed frame embeddings (B, S_enc, 1024) as
``prefix_embeds``, consumed through a linear adapter (``frontend_proj``).

It has no 500k-token autoregressive decode (``supports_long_context``
False).
"""
from repro_torch.configs.base import ArchConfig, register


@register("seamless-m4t-large-v2")
def seamless_m4t_large_v2() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        source="arXiv:2308.11596",
        num_layers=24,
        d_model=1024,
        vocab_size=256206,
        attention="gqa",
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        mlp="gelu",
        is_encoder_decoder=True,
        encoder_layers=24,
        encoder_seq_len=1024,
        modality="audio",
        frontend_dim=1024,
        supports_long_context=False,
        remat="full",
    )
