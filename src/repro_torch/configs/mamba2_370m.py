"""Mamba2-370M — attention-free SSM via State-Space Duality.

[arXiv:2405.21060] 48L, d_model 1024, ssm_state 128, vocab 50280, no MLP
(d_ff 0). Natively O(1) decode state: runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, register


@register("mamba2-370m")
def mamba2_370m() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m",
        family="ssm",
        source="arXiv:2405.21060",
        num_layers=48,
        d_model=1024,
        vocab_size=50280,
        attention="none",
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        mlp="none",
        ssm_state=128,
        ssm_conv=4,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=128,
        supports_long_context=True,
        remat="full",
    )
